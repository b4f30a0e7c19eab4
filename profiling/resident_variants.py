"""The resident adjoint (K2, K5's adjoint, K4 at padded 64) on other Adjoint
shapes, at the main paths' inputs.

    python3 profiling/resident_variants.py [--exact] [--baseline DIR]

Builds the variants of ``profiling/resident_variants.cu`` (nvcc, sm_90a,
one translation unit a variant and one for K1/K5's forwards, all started
together, into ``qoc_tpu_torch/_build/resident_variants/``) and times each
variant there, in the bf16_3x mode (the TC variants) or with ``--exact``
in the exact one (CUDA events, 10 launches after a warm-up, twice in turns:
the list forward, then backward). The inputs are the main paths' (the
prefixes from the forward kernel of the same mode):

- K2 at the Table-3 headline (S x L = 127 x 79, n_b = 21), last-step and
  per-step seeds, and on the 512-candidate multistart's member rows (512 x
  200 steps, last-step seeds);
- K2's step without its generator build: the plane kernel (K5's adjoint)
  on the headline's generators A_t, staged from precomputed planes;
- K5's adjoint at the M4 planes (125 x 16), both seed modes;
- K4 at padded 64 on the M4 planes (2000 matrices), as the blocked route
  calls it (at A^H).

``--baseline DIR`` adds the resident adjoint of another checkout of the
repo at DIR (an earlier commit unpacked by ``git archive``): its package
entries (``qoc_chain_bwd``, ``qoc_plane_bwd``, ``qoc_expm_frechet`` at
dp = 64, one translation unit each, built beside the variants) in the same
mode, timed first in the a b b a as the variant ``baseline``. Each variant
is first held against the plain version in its mode (relative max error,
within chip_smoke.MODE_RTOL in the mode, GRAD_RTOL exact) and against the
first variant listed (max |diff|); the ablations (``_products``: every
elementwise pass of the step reduced to a store) are timed only. Prints the
card, each case's bound (chip_smoke.py ``kernel_bound``), and per variant
its threads, dynamic shared memory, ptxas registers and spill of each
kernel, and its two times a case with its share of the bound; then the
ablation shares of each form that has one. Needs one CUDA device; it is the
measurement behind the forms noted in csrc/chain_common.cuh (Adjoint).
"""

import argparse
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

SOURCE = ROOT / "profiling" / "resident_variants.cu"
CSRC = ROOT / "qoc_tpu_torch" / "csrc"
OUT = ROOT / "qoc_tpu_torch" / "_build" / "resident_variants"
D = chain.KERNEL_DP
STASH_SLOTS = 8
# Dynamic shared memory a block (chain_common.cuh BWD_SMEM, DUAL_SMEM).
SMEM = {"chain": 7 * D * D * 8 + 16, "plane": 7 * D * D * 8 + 16,
        "frechet": 6 * D * D * 8 + 16}
KERNELS = {"chain": "chain_bwd_kernel", "plane": "plane_bwd_kernel",
           "frechet": "frechet_resident_kernel"}
FIELDS = ("threads", "both", "powers", "unroll", "ku", "tc", "ablate")


def variants():
    """{name: (its VARIANT line, shape)} in the source's order; shape maps
    FIELDS to ints."""
    out = {}
    for m in re.finditer(r"^VARIANT\((\w+),([^)]*)\)", SOURCE.read_text(),
                         re.M):
        vals = [v.strip() for v in m.group(2).split(",")]
        out[m.group(1)] = (m.group(0), dict(zip(FIELDS, [
            int(v == "true") if v in ("true", "false") else int(v)
            for v in vals])))
    return out


def _ptxas(log):
    """{entry-function line: [registers, spill-store bytes]} of a log: the
    first of each that follows the entry's line (its own, before the
    properties of any function it calls)."""
    report, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line
            report[current] = [None, None]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current and report[current][0] is None:
            report[current][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current and report[current][1] is None:
            report[current][1] = int(m.group(1))
    return report


# The baseline's C entries (--baseline), by kind: its source in csrc/ and
# the entry's parameters (pointers, ints) before its tf32 and stream.
BASELINE = {
    "chain": ("chain_bwd.cu", "qoc_chain_bwd",
              "const void* w, const void* basis_h, const void* norm, "
              "const void* prefpad, const void* seeds, void* gA, void* stash, "
              "int S, int L, int n_b, int per_step",
              "w, basis_h, norm, prefpad, seeds, gA, stash, S, L, n_b, "
              "per_step"),
    "plane": ("plane_bwd.cu", "qoc_plane_bwd",
              "const void* a, const void* norm, const void* prefpad, "
              "const void* seeds, void* gA, void* stash, int S, int L, "
              "int per_step",
              "a, norm, prefpad, seeds, gA, stash, S, L, per_step"),
    "frechet": ("expm_frechet.cu", "qoc_expm_frechet",
                "const void* b, const void* g, const void* norm, void* out, "
                "void* ws, int B, int grid",
                "b, g, norm, out, ws, B, {dp}, grid"),
}


def baseline_units(root, tf32):
    """{unit: source text}: the baseline checkout's C entries of each kind
    behind the variants' names (baseline_chain, ...), in the mode tf32."""
    units = {}
    for kind, (source, entry, params, call) in BASELINE.items():
        units["baseline_" + kind] = (
            '#include "{}"\nextern "C" int baseline_{}({}, void* stream) '
            '{{\n  return {}({}, {}, stream);\n}}\n'.format(
                Path(root).resolve() / "qoc_tpu_torch" / "csrc" / source,
                kind, params, entry, call.format(dp=D), tf32))
    return units


def build(names, table, baseline=None):
    """(library of K1/K5's forwards, {name: (library, ptxas report)}): one
    nvcc a translation unit, all started together; ``baseline``: the units
    of baseline_units, loaded as the variant "baseline" (its libraries one
    a kind, its ptxas report theirs together)."""
    OUT.mkdir(parents=True, exist_ok=True)
    units = {"forwards": '#include "{}"\n#include "{}"\n'.format(
        CSRC / "chain_fwd.cu", CSRC / "plane_fwd.cu")}
    units.update(baseline or {})
    for name in names:
        units[name] = '#define QOC_ONE_VARIANT\n#include "{}"\n{}\n'.format(
            SOURCE, table[name][0])
    procs = {}
    for unit, text in units.items():
        src = OUT / "{}.cu".format(unit)
        src.write_text(text)
        procs[unit] = subprocess.Popen(
            [chain._nvcc(), *chain._NVCC_FLAGS, "-shared", "-o",
             str(OUT / "lib{}.so".format(unit)), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {unit: proc.communicate()[0] for unit, proc in procs.items()}
    (OUT / "build.log").write_text("".join(
        "== {}\n{}".format(unit, log) for unit, log in logs.items()))
    failed = [unit for unit, proc in procs.items() if proc.returncode]
    if failed:
        raise SystemExit("building resident_variants.cu failed ({}):\n{}"
                         .format(", ".join(failed), "".join(
                             logs[u][-3000:] for u in failed)))
    libs = {unit: ctypes.CDLL(str(OUT / "lib{}.so".format(unit)))
            for unit in units}
    out = {name: (libs[name], _ptxas(logs[name])) for name in names}
    if baseline:
        out["baseline"] = ({unit.split("_", 1)[1]: libs[unit]
                            for unit in baseline},
                           _ptxas("".join(logs[unit] for unit in baseline)))
    return libs.pop("forwards"), out


def _adjoint_tc(entry):
    """The TC argument (0 or 1) of the Adjoint in a ptxas entry line's
    mangled name, or None."""
    m = re.search(r"AdjointILi\d+ELb[01]ELb[01]ELi\d+ELi\d+ELb([01])E",
                  entry)
    return int(m.group(1)) if m else None


SASS_OPS = ("HMMA", "LDS", "LDS.64", "LDS.128", "STS", "STS.64", "STS.128",
            "LDG", "STG", "BAR", "FADD", "FFMA", "IADD3", "LOP3", "MOV",
            "CS2R")


def sass_counts(lib_path, kernel):
    """{opcode: static count} of ``kernel``'s SASS in a built library
    (cuobjdump -sass): the instructions the compiler emitted for every
    ladder level, not those a run executes."""
    from torch.utils.cpp_extension import CUDA_HOME
    text = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass",
         str(lib_path)], capture_output=True, text=True,
        check=True).stdout
    counts, inside = {"all": 0}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if inside and m:
            op = m.group(1)
            key = op.split(".")[0]
            if key in ("LDS", "STS"):
                key += next((w for w in (".128", ".64") if w in op), "")
            counts["all"] += 1
            if key in SASS_OPS:
                counts[key] = counts.get(key, 0) + 1
    return counts


def _ptr_args(n_ptr, n_int):
    return [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]


def cases(fwd_lib, dev, mode, stream):
    """{case: (kernel kind, launch arguments, plain result, bound ms)}: the
    inputs listed in the module note, in ``mode``."""
    tf32 = int(mode == chip_smoke.MODE)
    gen = torch.Generator(device=dev).manual_seed(7)
    fwd_lib.qoc_chain_fwd.argtypes = _ptr_args(4, 4)
    fwd_lib.qoc_plane_fwd.argtypes = _ptr_args(3, 3)

    def prefixes(kind, x, n1, s_count, length, basis=None, n_b=0):
        pref = chain._prefpad_out(s_count, length, dev)
        err = (fwd_lib.qoc_chain_fwd(x.data_ptr(), basis.data_ptr(),
                                     n1.data_ptr(), pref.data_ptr(),
                                     s_count, length, n_b, tf32, stream)
               if kind == "chain" else
               fwd_lib.qoc_plane_fwd(x.data_ptr(), n1.data_ptr(),
                                     pref.data_ptr(), s_count, length, tf32,
                                     stream))
        if err:
            raise RuntimeError("forward kernel launch failed: {}".format(err))
        return pref

    def seeds_of(s_count, length=None):
        shape = (s_count,) + ((length,) if length else ()) + (D, D)
        return torch.randn(shape, dtype=torch.complex64, device=dev,
                           generator=gen)

    out = {}
    headline = chip_smoke.headline_weights(
        chip_smoke.table3_problem(1)[0], dev)
    ms_op, w_ms = chip_smoke.multistart_weights(dev)
    op = chain.ChainExpmPropagate(chip_smoke.table3_basis(), dev,
                                  torch.float32)
    for label, the_op, w, n_chains in (
            ("K2 headline", op, headline, 1),
            ("K2 512x200 members", ms_op, w_ms, w_ms.shape[0])):
        w_seg, length = chip_smoke.chain_rows(w, n_chains)
        s_count, n_b = w_seg.shape[0], the_op.n_b
        n1, ninf = chain._norm_max(w.reshape(-1, n_b), the_op.basis_ri,
                                   the_op.d)
        pref = prefixes("chain", w_seg, n1, s_count, length, the_op.basis,
                        n_b)
        a = torch.einsum("jk,kab->jab", w_seg.reshape(-1, n_b).to(
            torch.complex64), the_op.basis)
        level = chain.ladder_level(ninf)
        norms = a.abs().sum(-1).amax(-1)
        modes = (("last-step", seeds_of(s_count)),)
        if n_chains == 1:
            modes += (("per-step", seeds_of(s_count, length)),)
        for seed_mode, s in modes:
            args = (w_seg, the_op.basis_h, ninf, pref, s)
            out["{} {}".format(label, seed_mode)] = (
                "chain", args, (s_count, length, n_b, int(s.dim() == 4)),
                chain.chain_bwd_plain(*args, mode),
                chip_smoke.kernel_bound(norms, level, True, [
                    w_seg, the_op.basis_h, ninf, pref, s, pref[:, 1:]],
                    mode=mode)[0])
        if n_chains == 1:
            # The same step without the build: A_t from planes.
            a_seg = a.reshape(s_count, length, D, D)
            s = modes[0][1]
            args = (a_seg, ninf, pref, s)
            out["K2 headline planes (no build)"] = (
                "plane", args, (s_count, length, 0),
                chain.plane_bwd_plain(*args, mode),
                chip_smoke.kernel_bound(norms, level, True,
                                        [a_seg, ninf, pref, s, a_seg],
                                        mode=mode)[0])
        del a
    planes = chip_smoke.m4_planes(dev)
    a_seg, n1, ninf = chip_smoke._segment_planes(planes)
    s_count, length = a_seg.shape[:2]
    pref = prefixes("plane", a_seg, n1, s_count, length)
    norms = a_seg.reshape(-1, D, D).abs().sum(-1).amax(-1)
    for seed_mode, s in (("last-step", seeds_of(s_count)),
                         ("per-step", seeds_of(s_count, length))):
        args = (a_seg, ninf, pref, s)
        out["K5 bwd M4 " + seed_mode] = (
            "plane", args, (s_count, length, int(s.dim() == 4)),
            chain.plane_bwd_plain(*args, mode),
            chip_smoke.kernel_bound(norms, chain.ladder_level(ninf), True,
                                    [a_seg, ninf, pref, s, a_seg],
                                    mode=mode)[0])
    ah = planes.mH.contiguous()
    g = torch.randn(ah.shape, dtype=torch.complex64, device=dev,
                    generator=gen)
    norm = expm_cuda._norm_max(ah)
    out["K4 padded 64 M4"] = (
        "frechet", (ah, g, norm), (ah.shape[0],),
        expm_cuda.expm_frechet_plain(ah, g, mode),
        chip_smoke.kernel_bound(ah.abs().sum(-2).amax(-1),
                                chain.ladder_level(norm), True, [ah, g, g],
                                chain=False, mode=mode)[0])
    return out


def launcher(lib, name, case, stream, sms):
    """A no-argument launch of variant ``name`` on ``case``'s inputs and
    its output tensor."""
    kind, args, ints, _, _ = case
    fn = getattr(lib[kind] if isinstance(lib, dict) else lib,
                 "{}_{}".format(name, kind))
    x = args[0]
    if kind == "frechet":
        grid = min(ints[0], sms)
        out = torch.empty_like(x)
        ws = torch.empty((grid, STASH_SLOTS, D, D), dtype=torch.complex64,
                         device=x.device)
        fn.argtypes = _ptr_args(5, 2)
        extra = (out, ws)
        ints = (ints[0], grid)
    else:
        s_count, length = ints[:2]
        out = torch.empty((s_count, length, D, D), dtype=torch.complex64,
                          device=x.device)
        stash = torch.empty((s_count, STASH_SLOTS, D, D),
                            dtype=torch.complex64, device=x.device)
        extra = (out, stash)
        if kind == "plane":
            ints = (s_count, length, ints[2])
        fn.argtypes = _ptr_args(len(args) + 2, len(ints))
    ptrs = [t.data_ptr() for t in (*args, *extra)]

    def run():
        if fn(*ptrs, *ints, stream):
            raise RuntimeError("{} on {}: launch failed".format(name, kind))
    return run, out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--exact", action="store_true",
                        help="the exact variants (TC 0) in the exact mode")
    parser.add_argument("--baseline", metavar="DIR",
                        help="also time the resident adjoint of the checkout "
                        "at DIR (first, as the variant baseline)")
    parser.add_argument("--sass", action="store_true",
                        help="also print static SASS instruction counts of "
                        "each variant's K2 kernel (cuobjdump)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("resident_variants: needs a CUDA device.")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chip_smoke.phase_device()
    mode = "highest" if args.exact else chip_smoke.MODE
    table = variants()
    names = [n for n, (_, shape) in table.items()
             if (shape["tc"] == 0) == args.exact]
    baseline = args.baseline and baseline_units(args.baseline,
                                                int(not args.exact))
    fwd_lib, libs = build(names, table, baseline)
    if baseline:
        table["baseline"] = (None, {"threads": "baseline", "ablate": 0})
    if args.sass:
        for name in names:
            counts = sass_counts(OUT / "lib{}.so".format(name),
                                 "chain_bwd_kernel")
            print("{} chain_bwd_kernel SASS (static): {}".format(
                name, ", ".join("{} {}".format(k, v)
                                for k, v in counts.items())), flush=True)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    todo = cases(fwd_lib, dev, mode, stream)
    tol = chip_smoke.GRAD_RTOL if args.exact else chip_smoke.MODE_RTOL
    runs, rels, diffs, first, failed = {}, {}, {}, {}, []
    if baseline:
        names.insert(0, "baseline")
    for name in names:
        shape = table[name][1]
        for case_name, case in todo.items():
            run, out = launcher(libs[name][0], name, case, stream, sms)
            run()
            torch.cuda.synchronize()
            runs[name, case_name] = run
            if shape["ablate"]:
                continue
            want = case[3]
            rel = float((out - want).abs().max() / want.abs().max())
            rels[name, case_name] = rel
            if rel > tol:
                print("{} {} disagrees with its plain version: {:.1e}".format(
                    name, case_name, rel), flush=True)
                failed.append(name)
            if case_name in first:
                diffs[name, case_name] = float(
                    (out - first[case_name]).abs().max())
            else:
                first[case_name] = out.clone()
    names = [n for n in names if n not in failed]
    times = {key: [] for key in runs if key[0] in names}
    for order in (names, names[::-1]):
        for name in order:
            for case_name in todo:
                times[name, case_name].append(chip_smoke.cuda_ms(
                    runs[name, case_name], 10))
    print("resident_variants ({}): {}".format(mode, ", ".join(
        "{} bound {:.3f} ms".format(c, v[4]) for c, v in todo.items())),
        flush=True)
    for name in names:
        shape = table[name][1]
        regs = []
        for kind, kernel in KERNELS.items():
            # (The baseline's units hold both modes' Adjoint: the one of
            # this mode, by its mangled TC argument.)
            found = [v for k, v in libs[name][1].items() if kernel in k and (
                name != "baseline" or _adjoint_tc(k) == int(not args.exact))]
            regs.append("{} {} registers / {} B spilled, {} B shared".format(
                kind, *(found[0] if found else (None, None)), SMEM[kind]))
        rows = []
        for case_name in todo:
            t = times[name, case_name]
            row = "{} {:.3f}, {:.3f} ms ({:.0%} of bound".format(
                case_name, *t, todo[case_name][4] / min(t))
            if (name, case_name) in rels:
                row += ", rel {:.1e}".format(rels[name, case_name])
            if (name, case_name) in diffs:
                row += ", max|diff| vs {} {:.1e}".format(
                    names[0], diffs[name, case_name])
            rows.append(row + ")")
        print("{} ({} threads; ptxas {}): {}".format(
            name, shape["threads"], "; ".join(regs), "; ".join(rows)),
            flush=True)
    for name in names:
        twin = name + "_products"
        if twin not in table or twin not in names:
            continue
        whole = min(times[name, "K2 headline last-step"])
        parts = {
            "products, barriers, staging and build (elementwise passes "
            "reduced to stores)": min(times[twin, "K2 headline last-step"]),
            "without the generator build (A_t from planes)": min(
                times[name, "K2 headline planes (no build)"]),
        }
        print("{} ablation at the headline (last-step seeds, {:.3f} ms "
              "whole): {}; so the elementwise passes {:.0%}, the build "
              "{:.0%}".format(
                  name, whole, "; ".join("{} {:.3f} ms ({:.0%})".format(
                      k, v, v / whole) for k, v in parts.items()),
                  1 - list(parts.values())[0] / whole,
                  1 - list(parts.values())[1] / whole), flush=True)
    if failed:
        raise SystemExit("variants that disagree with their plain versions: "
                         + ", ".join(sorted(set(failed))))


if __name__ == "__main__":
    main()
