"""The tiled kernels on other shapes and forms, at the main path's inputs.

    python3 profiling/tiled_variants.py [--mode-only]

Builds ``profiling/tiled_variants.cu`` (nvcc, sm_90a, into
``qoc_tpu_torch/_build/variants/``) and times each variant there (CUDA
events, 10 launches after a warm-up) on chip_smoke.py's inputs:

- K3/K4's ``expm_tiled_kernel`` on other ``Tiled`` shapes (blocks sharing
  a matrix, register tiles) at the d = 2^7 planes (2000 x 128^2): K3 at A,
  K4 at (A^H, G), twice in turns (the list forward, then backward);
- the bf16_3x mode's two product forms, PR 11's (``mma.sync``, fragments
  split at every read) and the package's (``wgmma`` on operands split once
  a k-slice), in turns a b b a: K3 and K4 at the d = 2^7 planes, K6's
  forward and adjoint (last-step seeds) at the Lindblad d = 20 planes (15 x
  7 at padded 448).

``--mode-only`` builds and times only the bf16_3x forms. Each variant is
checked against the plain version first (in the mode for
the mode's forms). Prints the card, each variant's ptxas registers and
spills, groups launched, shared memory a block and its times, and
torch.linalg.matrix_exp's time on the d = 2^7 planes. Needs one CUDA
device; it is the measurement behind the choice of shapes and forms noted
in csrc/expm_fwd.cu, csrc/expm_frechet.cu and csrc/expm_common.cuh.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (problem builders and timer; no JAX)
from qoc_tpu_torch.ops import chain, expm_cuda  # noqa: E402

SOURCE = ROOT / "profiling" / "tiled_variants.cu"
OUT = ROOT / "qoc_tpu_torch" / "_build" / "variants"
MODE = chip_smoke.MODE


def build(mode_only):
    """The variants' library and ptxas's (registers, spill bytes) per
    entry."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libtiled_variants.so"
    flags = ["-DQOC_MODE_ONLY"] if mode_only else []
    proc = subprocess.run([chain._nvcc(), *chain._NVCC_FLAGS, *flags,
                           "-shared", "-o", str(lib), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    (OUT / "build.log").write_text(log)
    if proc.returncode:
        raise SystemExit("building tiled_variants.cu failed:\n" + log[-4000:])
    report, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            report.setdefault(current, [int(m.group(1)), 0])
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current in report:
            report[current][1] = int(m.group(1))
    return ctypes.CDLL(str(lib)), report


def ptxas(report, *parts):
    """(registers, spill bytes) of the first entry naming every part."""
    for k, v in report.items():
        if all(p in k for p in parts):
            return tuple(v)
    return None, None


def expm_variants(lib, report, dev, stream, mode_only):
    """{name: (run, groups, smem, ptxas, rel)} of the VARIANT entries (the
    bf16_3x forms' alone with mode_only)."""
    cint = ctypes.c_int
    a = chip_smoke.initial_planes(*chip_smoke.d128_problem()[:2], dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    g = torch.randn(a.shape, dtype=torch.complex64, device=dev, generator=gen)
    ah = a.mH.contiguous()
    plain = {}
    batch, dp = a.shape[0], a.shape[-1]
    runs = {}
    for m in re.finditer(r"^VARIANT\((\w+), (\d), (\w+), (\d), (\d), (\d), "
                         r"(\d+), (\d)\)", SOURCE.read_text(), re.M):
        name = m.group(1)
        if mode_only and "_mode_" not in name:
            continue
        t, dual, cl, tm, tn, gi, form = (int(m.group(2)), m.group(3) == "true",
                                         *map(int, m.group(4, 5, 6, 7, 8)))
        mode = MODE if form else "highest"
        if (dual, mode) not in plain:
            plain[dual, mode] = (expm_cuda.expm_frechet_plain(ah, g, mode)
                                 if dual else expm_cuda.expm_fwd_plain(a, mode))
        want = plain[dual, mode]
        x, y = (ah, g) if dual else (a, a)
        norm = expm_cuda._norm_max(x)
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [cint, cint, ctypes.c_void_p] \
            + [ctypes.POINTER(cint)] * 3
        smem, resident, slots = cint(), cint(), cint()
        outs = (ctypes.byref(smem), ctypes.byref(resident),
                ctypes.byref(slots))
        if fn(None, None, None, None, None, 0, 0, None, *outs):
            raise SystemExit(name + ": plan failed")
        groups = min(batch, resident.value)
        ws = torch.empty((groups, slots.value, dp, dp),
                         dtype=torch.complex64, device=dev)
        out = torch.empty_like(x)

        def run(fn=fn, x=x, y=y, norm=norm, out=out, ws=ws, groups=groups,
                outs=outs, name=name):
            if fn(x.data_ptr(), y.data_ptr(), norm.data_ptr(),
                  out.data_ptr(), ws.data_ptr(), batch, groups, stream,
                  *outs):
                raise RuntimeError(name + ": launch failed")
        run()
        torch.cuda.synchronize()
        rel = chip_smoke._rel(out, want)
        if rel > (chip_smoke.MODE_RTOL if form else chip_smoke.FWD_RTOL):
            raise SystemExit("{} disagrees with its plain version: {:.1e}"
                             .format(name, rel))
        key = "TiledILi{}ELb{}ELi{}ELi{}ELi{}ELi{}ELi{}E".format(
            t, int(dual), cl, tm, tn, gi, form)
        runs[name] = (run, groups, smem.value,
                      ptxas(report, "expm_tiled_kernel", key), rel)
    return runs, a


def stream_variants(lib, report, dev, stream):
    """{name: (run, clusters, None, ptxas, rel)} of K6's two bf16_3x forms
    (forward, adjoint) at the Lindblad d = 20 planes."""
    a_seg, n1, ninf = chip_smoke.mode_path_inputs(dev)["d20"][:3]
    s_count, length, dp = a_seg.shape[:3]
    gen = torch.Generator(device=dev).manual_seed(3)
    seeds = torch.randn((s_count, dp, dp), dtype=torch.complex64, device=dev,
                        generator=gen)
    pref = chain.stream_fwd(a_seg, n1, MODE)
    want = {False: chain.stream_fwd_plain(a_seg, n1, MODE),
            True: chain.stream_bwd_plain(a_seg, ninf, pref, seeds, MODE)}
    runs = {}
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    for form, tag in ((2, "mmasync"), (1, "wgmma")):
        for dual in (False, True):
            name = "k6_mode_{}_{}".format(tag, "bwd" if dual else "fwd")
            fn = getattr(lib, name)
            clusters, slots = chain.stream_grid(dual, dp, s_count, dev)
            ws = torch.empty((clusters, slots, dp, dp), dtype=torch.complex64,
                             device=dev)
            if dual:
                fn.argtypes = [ptr] * 6 + [cint] * 4 + [ptr]
                out = torch.empty_like(a_seg)
                args = (a_seg.data_ptr(), ninf.data_ptr(), pref.data_ptr(),
                        seeds.data_ptr(), out.data_ptr(), ws.data_ptr(),
                        s_count, length, 0, clusters, stream)
            else:
                fn.argtypes = [ptr] * 4 + [cint] * 3 + [ptr]
                out = torch.empty_like(pref)
                out[:, 0] = torch.eye(dp, dtype=torch.complex64, device=dev)
                args = (a_seg.data_ptr(), n1.data_ptr(), out.data_ptr(),
                        ws.data_ptr(), s_count, length, clusters, stream)

            def run(fn=fn, args=args, name=name, ws=ws):
                if fn(*args):
                    raise RuntimeError(name + ": launch failed")
            run()
            torch.cuda.synchronize()
            rel = chip_smoke._rel(out, want[dual])
            if rel > chip_smoke.MODE_RTOL:
                raise SystemExit("{} disagrees with its plain version in the "
                                 "mode: {:.1e}".format(name, rel))
            entry = "stream_{}_kernelILi7ELi{}E".format(
                "bwd" if dual else "fwd", form)
            runs[name] = (run, clusters, None, ptxas(report, entry), rel)
    return runs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tiled_variants: needs a CUDA device.")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chip_smoke.phase_device()
    mode_only = "--mode-only" in sys.argv[1:]
    lib, report = build(mode_only)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    runs, a = expm_variants(lib, report, dev, stream.value, mode_only)
    runs.update(stream_variants(lib, report, dev, stream.value))
    shapes = [n for n in runs if "_mode_" not in n]
    times = {name: [] for name in runs}
    for order in (shapes, shapes[::-1]):
        for name in order:
            times[name].append(chip_smoke.cuda_ms(runs[name][0], 10))
    for kernel in ("k3", "k4", "k6_fwd", "k6_bwd"):
        pair = ["{}_mode_{}{}".format(kernel[:2], form, kernel[2:])
                for form in ("mmasync", "wgmma")]
        for name in pair + pair[::-1]:
            times[name].append(chip_smoke.cuda_ms(runs[name][0], 10))
    library = chip_smoke.cuda_ms(lambda: torch.linalg.matrix_exp(a), 10)
    for name, (_, groups, smem, regs, rel) in runs.items():
        print("{:22s} {} groups, {} B shared a block, ptxas {} registers / "
              "{} B spilled, rel {:.1e}: {} ms".format(
                  name, groups, smem, *(regs or (None, None)), rel,
                  ", ".join("{:.3f}".format(t) for t in times[name])),
              flush=True)
    print("torch.linalg.matrix_exp on the d = 2^7 planes: {:.3f} ms".format(
        library))


if __name__ == "__main__":
    main()
