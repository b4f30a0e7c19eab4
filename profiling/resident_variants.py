"""K2 and K5's adjoint on other Adjoint shapes, at the main paths' inputs.

    python3 profiling/resident_variants.py

Builds ``profiling/resident_variants.cu`` (nvcc, sm_90a, into
``qoc_tpu_torch/_build/resident_variants/``) and times each variant of
the resident adjoint there (CUDA events, 10 launches after a warm-up,
twice in turns: the list forward, then backward): K2 at the Table-3
headline's shapes (S x L = 127 x 79, n_b = 21) and K5's adjoint at the M4
planes (125 x 16), each with last-step and per-step seeds. Each variant is
checked against the plain version first. Prints the card, each variant's
ptxas registers and spills, threads a block and its two times a case, and
the bound of each case (chip_smoke.py ``kernel_bound``). Needs one CUDA
device; it is the measurement behind the shape noted in
csrc/chain_common.cuh (Adjoint).
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
from qoc_tpu_torch.ops import chain  # noqa: E402

SOURCE = ROOT / "profiling" / "resident_variants.cu"
OUT = ROOT / "qoc_tpu_torch" / "_build" / "resident_variants"


def build():
    """The variants' library and ptxas's (registers, spill bytes) per
    entry function."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libresident_variants.so"
    proc = subprocess.run([chain._nvcc(), *chain._NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    (OUT / "build.log").write_text(log)
    if proc.returncode:
        raise SystemExit("building resident_variants.cu failed:\n"
                         + log[-4000:])
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


def shape(name):
    """(threads, one-pass, powers stashed, product unroll, build unroll) of
    a variant's name."""
    m = re.match(r"t(\d+)_(onepass|twopass)_(chunks|powers)_u(\d)_k(\d)",
                 name)
    return (int(m.group(1)), m.group(2) == "onepass", m.group(3) == "powers",
            int(m.group(4)), int(m.group(5)))


def ptxas(report, kernel, name):
    threads, one_pass, powers, unroll, ku = shape(name)
    key = "AdjointILi{}ELb{}ELb{}ELi{}ELi{}E".format(
        threads, int(one_pass), int(powers), unroll, ku)
    found = [v for k, v in report.items() if kernel in k and key in k]
    return found[0] if found else (None, None)


def cases(dev):
    """{case: (plain result, args but the seeds, seeds, bound ms)} of K2 at
    the headline and K5's adjoint at the M4 planes, both seed modes."""
    gen = torch.Generator(device=dev).manual_seed(7)
    op = chain.ChainExpmPropagate(chip_smoke.table3_basis(), dev,
                                  torch.float32)
    headline_w = chip_smoke.headline_weights(
        chip_smoke.table3_problem(1)[0], dev)
    n_steps = headline_w.shape[0]
    s_count, length = chain.segment_plan(n_steps)
    w_seg = torch.zeros((s_count * length, op.n_b), device=dev)
    w_seg[:n_steps] = headline_w
    w_seg = w_seg.reshape(s_count, length, op.n_b)
    n1, ninf = chain._norm_max(headline_w, op.basis_ri, op.d)
    a = torch.einsum("jk,kab->jab", w_seg.reshape(-1, op.n_b).to(
        torch.complex64), op.basis)
    inputs = {"K2": ((w_seg, op.basis_h, ninf,
                      chain.chain_fwd(w_seg, op.basis, n1)),
                     chain.chain_bwd_plain, a.abs().sum(-1).amax(-1),
                     chain.ladder_level(ninf))}
    planes = chip_smoke.m4_planes(dev)
    a_seg, n1, ninf = chip_smoke._segment_planes(planes)
    inputs["K5 bwd"] = ((a_seg, ninf, chain.plane_fwd(a_seg, n1)),
                        chain.plane_bwd_plain,
                        planes.abs().sum(-1).amax(-1),
                        chain.ladder_level(ninf))
    out = {}
    for key, (args, plain, step_norms, level) in inputs.items():
        pref = args[-1]
        dp = pref.shape[-1]
        for mode in ("last-step", "per-step"):
            lead = ((pref.shape[0], pref.shape[1] - 1) if mode == "per-step"
                    else (pref.shape[0],))
            seeds = torch.randn(lead + (dp, dp), dtype=torch.complex64,
                                device=dev, generator=gen)
            bound = chip_smoke.kernel_bound(
                step_norms, level, True, list(args) + [seeds, pref[:, 1:]],
                dp)[0]
            out["{} {}".format(key, mode)] = (plain(*args, seeds), args,
                                              seeds, bound)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("resident_variants: needs a CUDA device.")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chip_smoke.phase_device()
    lib, report = build()
    names = re.findall(r"^VARIANT\((\w+),", SOURCE.read_text(), re.M)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    runs, rels = {}, {}
    todo = cases(dev)
    for name in names:
        for case, (want, args, seeds, _) in todo.items():
            kernel = "chain" if case.startswith("K2") else "plane"
            fn = getattr(lib, "{}_{}".format(name, kernel))
            n_ptr = 7 if kernel == "chain" else 6
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (
                4 if kernel == "chain" else 3) + [ctypes.c_void_p]
            s_count, length = args[-1].shape[0], args[-1].shape[1] - 1
            out = torch.empty((s_count, length, 64, 64),
                              dtype=torch.complex64, device=dev)
            stash = torch.empty((s_count, 8, 64, 64), dtype=torch.complex64,
                                device=dev)
            per_step = int(seeds.dim() == 4)
            ints = ([s_count, length, args[0].shape[-1], per_step]
                    if kernel == "chain" else [s_count, length, per_step])

            def run(fn=fn, args=args, seeds=seeds, out=out, stash=stash,
                    ints=ints, name=name):
                if fn(*[x.data_ptr() for x in args], seeds.data_ptr(),
                      out.data_ptr(), stash.data_ptr(), *ints, stream):
                    raise RuntimeError(name + ": launch failed")
            run()
            torch.cuda.synchronize()
            rel = float((out - want).abs().max() / want.abs().max())
            if rel > chip_smoke.GRAD_RTOL:
                raise SystemExit("{} {} disagrees with its plain version: "
                                 "{:.1e}".format(name, case, rel))
            runs[name, case] = run
            rels[name, case] = rel
    times = {key: [] for key in runs}
    for order in (names, names[::-1]):
        for name in order:
            for case in todo:
                times[name, case].append(chip_smoke.cuda_ms(
                    runs[name, case], 10))
    for case, (_, _, _, bound) in todo.items():
        print("{}: bound {:.3f} ms".format(case, bound), flush=True)
    for name in names:
        threads = shape(name)[0]
        regs = {kernel: ptxas(report, kernel + "_bwd_kernel", name)
                for kernel in ("chain", "plane")}
        print("{:20s} {} threads, ptxas K2 {} registers / {} B spilled, K5 "
              "{} / {} B: ".format(name, threads, *regs["chain"],
                                    *regs["plane"])
              + "; ".join("{} {:.3f}, {:.3f} ms ({:.0%} of bound, rel "
                          "{:.1e})".format(case, *times[name, case],
                                           todo[case][3]
                                           / min(times[name, case]),
                                           rels[name, case])
                          for case in todo), flush=True)


if __name__ == "__main__":
    main()
