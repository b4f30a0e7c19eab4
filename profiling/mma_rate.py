"""The card's TF32 tensor-core issue rates, alone, against the dense peak.

    python3 profiling/mma_rate.py

Builds ``profiling/mma_rate.cu`` (nvcc, sm_90a, into
``qoc_tpu_torch/_build/mma_rate/``) and times, with CUDA events, kernels
that issue nothing but: independent
``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` on register operands
(the resident bf16_3x kernels' instruction), at 1-4 blocks of 128-1024
threads on every SM; ``wgmma.mma_async`` m64nNk8 TF32 with both operands in
shared memory, N = 64, 56 and 40 (the tiled bf16_3x kernels' instruction
and widths), 24 a commit as they issue a k-slice, at 1-2 blocks of one or
two warpgroups on every SM; and FP32 FMA (the exact kernels' arithmetic).
Prints the card, each configuration's TFLOP/s (2 x 16 x 8 x 8 FLOP an mma,
2 x 64 x N x 8 a wgmma, 2 an FMA), the best of each against its peak
(``chip_smoke.PEAK_TF32_FLOPS``, ``chip_smoke.PEAK_FP32_FLOPS``), and its
rate per SM and clock (FLOP/cycle/SM) at the maximum SM clock that
nvidia-smi reports. Needs one CUDA device.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (peaks, device line; no JAX)
from qoc_tpu_torch.ops import chain  # noqa: E402

SOURCE = ROOT / "profiling" / "mma_rate.cu"
OUT = ROOT / "qoc_tpu_torch" / "_build" / "mma_rate"
ITERS = 20000


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libmma_rate.so"
    proc = subprocess.run([chain._nvcc(), *chain._NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit("building mma_rate.cu failed:\n"
                         + (proc.stdout + proc.stderr)[-4000:])
    lib = ctypes.CDLL(str(lib))
    lib.qoc_rate_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    return lib


def time_ms(lib, kind, out, blocks, threads, repeats=5):
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.qoc_rate_launch(kind, out.data_ptr(), ITERS, blocks,
                                  threads, stream)
        if err:
            raise RuntimeError("launch failed: CUDA error {}".format(err))

    launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(repeats):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mma_rate: needs a CUDA device.")
    chip_smoke.phase_device()
    lib = build()
    chains = lib.qoc_rate_chains()
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    clock_mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    out = torch.zeros(4 * 1024 * sms, device="cuda")
    wg_batch = lib.qoc_rate_wg_batch()
    best = {}
    kinds = [(0, "mma.sync m16n8k8 TF32", chip_smoke.PEAK_TF32_FLOPS)]
    kinds += [(n, "wgmma m64n{}k8 TF32 (shared-memory operands)".format(n),
               chip_smoke.PEAK_TF32_FLOPS) for n in (64, 56, 40)]
    kinds.append((1, "FP32 FMA", chip_smoke.PEAK_FP32_FLOPS))
    for kind, name, peak in kinds:
        shapes = ([(s, t) for s in (1, 2, 4) for t in (128, 256, 512, 1024)
                   if s * t <= 2048] if kind < 2
                  else [(s, t) for s in (1, 2) for t in (128, 256)])
        for per_sm, threads in shapes:
            blocks = per_sm * sms
            warps = blocks * threads // 32
            if kind == 0:
                flop = warps * ITERS * chains * 2 * 16 * 8 * 8
            elif kind == 1:
                flop = blocks * threads * ITERS * 4 * chains * 2
            else:
                flop = warps // 4 * ITERS * wg_batch * 2 * 64 * kind * 8
            ms = time_ms(lib, kind, out, blocks, threads)
            rate = flop / (ms * 1e-3)
            best[name] = max(best.get(name, (0.0, None)),
                             (rate, (per_sm, threads)))
            print("{}: {} blocks/SM x {} threads: {:.3f} ms, {:.1f} "
                  "TFLOP/s ({:.1%} of {:.1f})".format(
                      name, per_sm, threads, ms, rate / 1e12,
                      rate / peak, peak / 1e12), flush=True)
        rate, shape = best[name]
        print("best {}: {:.1f} TFLOP/s at {} blocks/SM x {} threads = {:.1%} "
              "of the {:.1f} TFLOP/s peak; {:.0f} FLOP/cycle/SM at {} MHz "
              "(max SM clock) on {} SMs".format(
                  name, rate / 1e12, *shape, rate / peak, peak / 1e12,
                  rate / (sms * clock_mhz * 1e6), clock_mhz, sms),
              flush=True)


if __name__ == "__main__":
    main()
