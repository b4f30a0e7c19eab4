"""K3/K4's tiled form on other shapes, at the d = 2^7 GRAPE's planes.

    python3 profiling/tiled_variants.py

Builds ``profiling/tiled_variants.cu`` (nvcc, sm_90a, into
``qoc_tpu_torch/_build/variants/``) and times each variant of
``expm_tiled_kernel`` there (CUDA events, 10 launches after a warm-up,
twice in turns: the list forward, then backward) on chip_smoke.py's d = 2^7
planes (2000 x 128^2, degree 19): K3 at A, K4 at (A^H, G). Each variant is
checked against the plain version first. Prints the card, each variant's
ptxas registers and spills, groups launched, shared memory a block and its
two times, and torch.linalg.matrix_exp's time on the same planes. Needs
one CUDA device; it is the measurement behind the choice of shapes noted
in csrc/expm_fwd.cu and csrc/expm_frechet.cu.
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


def build():
    """The variants' library and ptxas's (registers, spill bytes) per
    entry."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libtiled_variants.so"
    proc = subprocess.run([chain._nvcc(), *chain._NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(SOURCE)],
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


def shape_key(name):
    """The Tiled template arguments of a variant, as in its mangled name."""
    m = re.match(r"k([34])_(block|cluster(\d))_(\d)x(\d)", name)
    dual, cl = m.group(1) == "4", int(m.group(3) or 1)
    tm, tn = int(m.group(4)), int(m.group(5))
    gi = 8 if (tm, tn) == (8, 2) else 16
    return "TiledILi2ELb{}ELi{}ELi{}ELi{}ELi{}E".format(int(dual), cl, tm,
                                                         tn, gi)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tiled_variants: needs a CUDA device.")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chip_smoke.phase_device()
    lib, report = build()
    names = re.findall(r"^VARIANT\((\w+),", SOURCE.read_text(), re.M)
    a = chip_smoke.initial_planes(*chip_smoke.d128_problem()[:2], dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    g = torch.randn(a.shape, dtype=torch.complex64, device=dev, generator=gen)
    ah = a.mH.contiguous()
    inputs = {False: (a, a, expm_cuda._norm_max(a),
                      expm_cuda.expm_fwd_plain(a)),
              True: (ah, g, expm_cuda._norm_max(ah),
                     expm_cuda.expm_frechet_plain(ah, g))}
    batch, dp = a.shape[0], a.shape[-1]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    cint = ctypes.c_int
    runs = {}
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [cint, cint, ctypes.c_void_p] \
            + [ctypes.POINTER(cint)] * 3
        smem, resident, slots = cint(), cint(), cint()
        outs = (ctypes.byref(smem), ctypes.byref(resident),
                ctypes.byref(slots))
        if fn(None, None, None, None, None, 0, 0, None, *outs):
            raise SystemExit(name + ": plan failed")
        x, y, norm, want = inputs[name.startswith("k4")]
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
        rel = float((out - want).abs().max() / want.abs().max())
        if rel > chip_smoke.FWD_RTOL:
            raise SystemExit("{} disagrees with its plain version: {:.1e}"
                             .format(name, rel))
        entry = [v for k, v in report.items()
                 if "expm_tiled_kernel" in k and shape_key(name) in k]
        runs[name] = (run, groups, smem.value, entry[0] if entry else None,
                      rel)
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(chip_smoke.cuda_ms(runs[name][0], 10))
    library = chip_smoke.cuda_ms(lambda: torch.linalg.matrix_exp(a), 10)
    for name in names:
        _, groups, smem, regs, rel = runs[name]
        print("{:18s} {} groups, {} B shared a block, ptxas {} registers / "
              "{} B spilled, rel {:.1e}: {:.3f}, {:.3f} ms".format(
                  name, groups, smem, *(regs or (None, None)), rel,
                  *times[name]), flush=True)
    print("torch.linalg.matrix_exp on the same planes: {:.3f} ms".format(
        library))


if __name__ == "__main__":
    main()
