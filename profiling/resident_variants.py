"""The resident kernels on other shapes, at the main paths' inputs: the
adjoint (K2, K5's adjoint, K4 at padded 64) on Adjoint shapes, or with
``--forward`` the bf16_3x forward (K1, K5's forward, K3 at padded 64) on
FwdTC shapes.

    python3 profiling/resident_variants.py [--exact] [--sass] [--baseline DIR]
    python3 profiling/resident_variants.py --forward [--sass] [--baseline DIR]
    python3 profiling/resident_variants.py --sass-against DIR

Builds the variants of ``profiling/resident_variants.cu`` (nvcc, sm_90a,
one translation unit a variant, all started together, into
``qoc_tpu_torch/_build/resident_variants/``) and times each variant there
(CUDA events, 10 launches after a warm-up, twice in turns: the list
forward, then backward). The adjoint's variants run in the bf16_3x mode
(the TC variants) or with ``--exact`` in the exact one, on the main paths'
inputs, the prefixes from the package's forward kernel of the same mode
(built beside them):

- K2 at the Table-3 headline (S x L = 127 x 79, n_b = 21), last-step and
  per-step seeds, and on the 512-candidate multistart's member rows (512 x
  200 steps, last-step seeds);
- K2's step without its generator build: the plane kernel (K5's adjoint)
  on the headline's generators A_t, staged from precomputed planes;
- K5's adjoint at the M4 planes (125 x 16), both seed modes;
- K4 at padded 64 on the M4 planes (2000 matrices), as the blocked route
  calls it (at A^H).

The forward's variants (``--forward``, the bf16_3x mode) run K1 at the
headline and on the 512 x 200 member rows, K1's step without its build
(K5's forward on the headline's A_t as planes), K5's forward at the M4
planes and K3 at padded 64 on the M4 planes.

``--baseline DIR`` adds the same kernels of another checkout of the repo at
DIR (an earlier commit unpacked by ``git archive``): its package entries
(``qoc_chain_bwd``, ``qoc_plane_bwd``, ``qoc_expm_frechet`` at dp = 64, or
with ``--forward`` ``qoc_chain_fwd``, ``qoc_plane_fwd``, ``qoc_expm_fwd``
at dp = 64; one translation unit each, built beside the variants) in the
same mode, timed first in the a b b a as the variant ``baseline``. With
``--forward``, where that checkout's mode form is ``Fwd<true>`` (the form
before FwdTC), its K1 step with every elementwise pass reduced to a store
is timed too (``baseline_products``).

Each variant is first held against the plain version in its mode
(relative max error, within chip_smoke.MODE_RTOL in the mode, GRAD_RTOL
exact) and against the first variant listed (max |diff|); the ablations
(``_products``: every elementwise pass of the step reduced to a store) are
timed only. Prints the card, each case's bound (chip_smoke.py
``kernel_bound``), and per variant its threads, dynamic shared memory,
ptxas registers and spill of each kernel, and its two times a case with
its share of the bound; then the ablation shares of each form that has
one: the elementwise passes (1 - products / whole) and the build (1 -
without the build / whole). ``--sass`` adds each variant's static SASS
counts of its K2 (or K1) kernel (cuobjdump).

``--sass-against DIR`` times nothing: it builds the package's kernel
library here and in the checkout at DIR (``chain.load_kernels``) and
prints which kernels of DIR's library compile to the same SASS here
(cuobjdump, addresses dropped), and which do not. Needs one CUDA device;
it is the measurement behind the forms noted in csrc/chain_common.cuh
(Adjoint, FwdTC).
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
SLOT = D * D * 8
# Per kind (the C entry's suffix): its kernel and dynamic shared memory a
# block (chain_common.cuh BWD_SMEM, DUAL_SMEM; expm_fwd.cu RESIDENT_SMEM;
# None: the form's, 6 slots, or 7 with a pair build).
KINDS = {
    "adjoint": {"chain": ("chain_bwd_kernel", 7 * SLOT + 16),
                "plane": ("plane_bwd_kernel", 7 * SLOT + 16),
                "frechet": ("frechet_resident_kernel", 6 * SLOT + 16)},
    "forward": {"chain_fwd": ("chain_fwd_kernel", None),
                "plane_fwd": ("plane_fwd_kernel", None),
                "expm_fwd": ("expm_resident_kernel", 5 * SLOT + 16)},
}
# Each family's variant macro and its fields; the forward's line needs
# QOC_FORWARD_VARIANTS.
FAMILY = {
    "adjoint": ("VARIANT", ("threads", "both", "powers", "unroll", "ku",
                            "tc", "ablate"), ""),
    "forward": ("FWD_VARIANT", ("ku", "passes", "early", "pair", "ablate"),
                "#define QOC_FORWARD_VARIANTS\n"),
}
# The case whose ablation shares are printed, and its twin without the
# generator build.
WHOLE = {"adjoint": ("K2 headline last-step", "K2 headline planes (no build)"),
         "forward": ("K1 headline", "K1 headline planes (no build)")}


def variants(family):
    """{name: (its line, shape)} of ``family``'s variants in the source's
    order; shape maps the family's fields to ints."""
    macro, fields, _ = FAMILY[family]
    out = {}
    for m in re.finditer(r"^{}\((\w+),([^)]*)\)".format(macro),
                         SOURCE.read_text(), re.M):
        vals = [v.strip() for v in m.group(2).split(",")]
        out[m.group(1)] = (m.group(0), dict(zip(fields, [
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
    "chain_fwd": ("chain_fwd.cu", "qoc_chain_fwd",
                  "const void* w, const void* basis, const void* norm, "
                  "void* prefpad, int S, int L, int n_b",
                  "w, basis, norm, prefpad, S, L, n_b"),
    "plane_fwd": ("plane_fwd.cu", "qoc_plane_fwd",
                  "const void* a, const void* norm, void* prefpad, int S, "
                  "int L", "a, norm, prefpad, S, L"),
    "expm_fwd": ("expm_fwd.cu", "qoc_expm_fwd",
                 "const void* a, const void* norm, void* out, int B, "
                 "int grid", "a, norm, out, nullptr, B, {dp}, grid"),
}


def baseline_units(root, family, tf32):
    """{unit: source text}: the baseline checkout's C entries of each of
    ``family``'s kinds behind the variants' names (baseline_chain, ...), in
    the mode tf32; for the forward also its K1 products ablation
    (baseline_products_chain_fwd, unit "products")."""
    csrc = Path(root).resolve() / "qoc_tpu_torch" / "csrc"
    units = {}
    for kind in KINDS[family]:
        source, entry, params, call = BASELINE[kind]
        units["baseline_" + kind] = (
            '#include "{}"\nextern "C" int baseline_{}({}, void* stream) '
            '{{\n  return {}({}, {}, stream);\n}}\n'.format(
                csrc / source, kind, params, entry, call.format(dp=D), tf32))
    if family == "forward":
        units["products"] = '#define QOC_BASELINE_FWD "{}"\n#include "{}"\n' \
            .format(csrc / "chain_fwd.cu", SOURCE)
    return units


def build(family, names, table, baseline=None):
    """(library of K1/K5's forwards or None, {name: (library, ptxas
    report)}): one nvcc a translation unit, all started together;
    ``baseline``: the units of baseline_units, loaded as the variant
    "baseline" (its libraries one a kind, its ptxas report theirs together)
    and, where its products unit builds, "baseline_products". The adjoint
    family also builds the package's K1/K5 forwards, for its prefixes."""
    OUT.mkdir(parents=True, exist_ok=True)
    units = {}
    if family == "adjoint":
        units["forwards"] = '#include "{}"\n#include "{}"\n'.format(
            CSRC / "chain_fwd.cu", CSRC / "plane_fwd.cu")
    units.update(baseline or {})
    for name in names:
        units[name] = '{}#define QOC_ONE_VARIANT\n#include "{}"\n{}\n'.format(
            FAMILY[family][2], SOURCE, table[name][0])
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
    if "products" in failed:
        print("baseline_products not built (the baseline's mode form is not "
              "Fwd<true>):\n" + logs["products"][-1500:], flush=True)
        failed.remove("products")
        del units["products"]
        baseline.pop("products")
    if failed:
        raise SystemExit("building resident_variants.cu failed ({}):\n{}"
                         .format(", ".join(failed), "".join(
                             logs[u][-3000:] for u in failed)))
    libs = {unit: ctypes.CDLL(str(OUT / "lib{}.so".format(unit)))
            for unit in units}
    out = {name: (libs[name], _ptxas(logs[name])) for name in names}
    if baseline:
        if "products" in baseline:
            out["baseline_products"] = ({"chain_fwd": libs.pop("products")},
                                        _ptxas(logs.pop("products")))
            baseline.pop("products")
        out["baseline"] = ({unit.split("_", 1)[1]: libs[unit]
                            for unit in baseline},
                           _ptxas("".join(logs[unit] for unit in baseline)))
    return libs.pop("forwards", None), out


def _adjoint_tc(entry):
    """The TC argument (0 or 1) of the Adjoint in a ptxas entry line's
    mangled name, or None."""
    m = re.search(r"AdjointILi\d+ELb[01]ELb[01]ELi\d+ELi\d+ELb([01])E",
                  entry)
    return int(m.group(1)) if m else None


def _baseline_entry(family, entry, tc):
    """Whether a ptxas entry line of a baseline's units is the kernel of
    the mode ``tc`` (its units hold both modes' kernels)."""
    if family == "adjoint":
        return _adjoint_tc(entry) == tc
    # The forward kernels' form: Fwd<tc> (a form template on the mode),
    # or the exact Fwd / a FwdTC.
    m = re.search(r"_kernelILb([01])E", entry)
    if m:
        return int(m.group(1)) == tc
    return ("FwdTC" in entry) == bool(tc)


SASS_OPS = ("HMMA", "LDS", "LDS.64", "LDS.128", "STS", "STS.64", "STS.128",
            "LDG", "STG", "BAR", "FADD", "FFMA", "IADD3", "LOP3", "MOV",
            "CS2R")


def _cuobjdump(lib_path):
    from torch.utils.cpp_extension import CUDA_HOME
    return subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass",
         str(lib_path)], capture_output=True, text=True,
        check=True).stdout


def sass_counts(lib_path, kernel):
    """{opcode: static count} of ``kernel``'s SASS in a built library
    (cuobjdump -sass): the instructions the compiler emitted for every
    ladder level, not those a run executes."""
    counts, inside = {"all": 0}, False
    for line in _cuobjdump(lib_path).splitlines():
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


def sass_functions(lib_path):
    """{function name: its SASS with addresses and encodings dropped} of a
    library."""
    funcs, name = {}, None
    for line in _cuobjdump(lib_path).splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*(?:/\*.*)?$", line)
        if name and m:
            funcs[name].append(m.group(1))
    return {k: "\n".join(v) for k, v in funcs.items()}


def sass_against(root):
    """Build the package's kernel library here and at ``root``, and print
    which of root's kernels have a kernel here of the same SASS."""
    here = chain.build_dir() / "libqoc_chain.so"
    chain.load_kernels()
    there = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from qoc_tpu_torch.ops import chain; chain.load_kernels(); "
         "print(chain.build_dir())"], cwd=root, capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[-1]
    mine = sass_functions(here)
    bodies = set(mine.values())
    theirs = sass_functions(Path(there) / "libqoc_chain.so")
    same = sorted(k for k, v in theirs.items() if v in bodies)
    other = sorted(k for k, v in theirs.items() if v not in bodies)
    print("sass-against {}: {} of {} functions compile to the same SASS "
          "here ({} here)".format(root, len(same), len(theirs), len(mine)),
          flush=True)
    for k in other:
        print("  differs or gone: " + k, flush=True)
    for k in same:
        print("  same: " + k, flush=True)


def _ptr_args(n_ptr, n_int):
    return [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]


def adjoint_cases(fwd_lib, dev, mode, stream):
    """{case: (kernel kind, launch arguments, ints, plain result, bound
    ms)}: the adjoint's inputs listed in the module note, in ``mode``."""
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


def forward_cases(dev, mode):
    """{case: (kernel kind, launch arguments, ints, plain result, bound
    ms)}: the forward's inputs listed in the module note, in ``mode``."""
    out = {}
    headline = chip_smoke.headline_weights(
        chip_smoke.table3_problem(1)[0], dev)
    ms_op, w_ms = chip_smoke.multistart_weights(dev)
    op = chain.ChainExpmPropagate(chip_smoke.table3_basis(), dev,
                                  torch.float32)
    for label, the_op, w, n_chains in (
            ("K1 headline", op, headline, 1),
            ("K1 512x200 members", ms_op, w_ms, w_ms.shape[0])):
        w_seg, length = chip_smoke.chain_rows(w, n_chains)
        s_count, n_b = w_seg.shape[0], the_op.n_b
        n1 = chain._norm_max(w.reshape(-1, n_b), the_op.basis_ri,
                             the_op.d)[0]
        a = torch.einsum("jk,kab->jab", w_seg.reshape(-1, n_b).to(
            torch.complex64), the_op.basis)
        level = chain.ladder_level(n1)
        norms = a.abs().sum(-2).amax(-1)
        pref = chain._prefpad_out(s_count, length, dev)
        args = (w_seg, the_op.basis, n1)
        out[label] = ("chain_fwd", args, (s_count, length, n_b),
                      chain.chain_fwd_plain(*args, mode),
                      chip_smoke.kernel_bound(
                          norms, level, False, [*args, pref],
                          mode=mode)[0])
        if n_chains == 1:
            # The same step without the build: A_t from planes.
            a_seg = a.reshape(s_count, length, D, D)
            out["K1 headline planes (no build)"] = (
                "plane_fwd", (a_seg, n1), (s_count, length),
                chain.plane_fwd_plain(a_seg, n1, mode),
                chip_smoke.kernel_bound(norms, level, False,
                                        [a_seg, n1, pref], mode=mode)[0])
        del a
    planes = chip_smoke.m4_planes(dev)
    a_seg, n1, _ = chip_smoke._segment_planes(planes)
    s_count, length = a_seg.shape[:2]
    out["K5 fwd M4"] = (
        "plane_fwd", (a_seg, n1), (s_count, length),
        chain.plane_fwd_plain(a_seg, n1, mode),
        chip_smoke.kernel_bound(
            a_seg.reshape(-1, D, D).abs().sum(-2).amax(-1),
            chain.ladder_level(n1), False,
            [a_seg, n1, chain._prefpad_out(s_count, length, dev)],
            mode=mode)[0])
    norm = expm_cuda._norm_max(planes)
    out["K3 padded 64 M4"] = (
        "expm_fwd", (planes, norm), (planes.shape[0],),
        expm_cuda.expm_fwd_plain(planes, mode),
        chip_smoke.kernel_bound(planes.abs().sum(-2).amax(-1),
                                chain.ladder_level(norm), False,
                                [planes, planes], chain=False,
                                mode=mode)[0])
    return out


def launcher(lib, name, case, stream, sms):
    """A no-argument launch of variant ``name`` on ``case``'s inputs and
    its output tensor, or None where the variant has no entry of the
    case's kind."""
    kind, args, ints, _, _ = case
    if isinstance(lib, dict) and kind not in lib:
        return None
    fn = getattr(lib[kind] if isinstance(lib, dict) else lib,
                 "{}_{}".format(name, kind))
    x = args[0]
    if kind in ("frechet", "expm_fwd"):
        grid = min(ints[0], sms)
        out = torch.empty_like(x)
        extra = (out,)
        if kind == "frechet":
            extra += (torch.empty((grid, STASH_SLOTS, D, D),
                                  dtype=torch.complex64, device=x.device),)
        ints = (ints[0], grid)
    elif kind in ("chain_fwd", "plane_fwd"):
        out = chain._prefpad_out(ints[0], ints[1], x.device)
        extra = (out,)
    else:
        s_count, length = ints[:2]
        out = torch.empty((s_count, length, D, D), dtype=torch.complex64,
                          device=x.device)
        stash = torch.empty((s_count, STASH_SLOTS, D, D),
                            dtype=torch.complex64, device=x.device)
        extra = (out, stash)
        if kind == "plane":
            ints = (s_count, length, ints[2])
    fn.argtypes = _ptr_args(len(args) + len(extra), len(ints))
    ptrs = [t.data_ptr() for t in (*args, *extra)]

    def run():
        if fn(*ptrs, *ints, stream):
            raise RuntimeError("{} on {}: launch failed".format(name, kind))
    return run, out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--exact", action="store_true",
                        help="the adjoint's exact variants (TC 0) in the "
                        "exact mode")
    parser.add_argument("--forward", action="store_true",
                        help="the bf16_3x forward's variants (FwdTC)")
    parser.add_argument("--baseline", metavar="DIR",
                        help="also time the same kernels of the checkout at "
                        "DIR (first, as the variant baseline)")
    parser.add_argument("--sass", action="store_true",
                        help="also print static SASS instruction counts of "
                        "each variant's K2 (K1) kernel (cuobjdump)")
    parser.add_argument("--sass-against", metavar="DIR",
                        help="only compare the package's SASS with that of "
                        "the checkout at DIR, kernel by kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("resident_variants: needs a CUDA device.")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chip_smoke.phase_device()
    if args.sass_against:
        sass_against(args.sass_against)
        return
    family = "forward" if args.forward else "adjoint"
    if args.forward and args.exact:
        raise SystemExit("resident_variants: the forward's variants are the "
                         "bf16_3x mode's (no --exact).")
    mode = "highest" if args.exact else chip_smoke.MODE
    table = variants(family)
    names = [n for n, (_, shape) in table.items()
             if family == "forward" or (shape["tc"] == 0) == args.exact]
    baseline = args.baseline and baseline_units(args.baseline, family,
                                                int(not args.exact))
    fwd_lib, libs = build(family, names, table, baseline)
    first = ["baseline"] if baseline else []
    if "baseline_products" in libs:
        first.append("baseline_products")
        table["baseline_products"] = (None, {"threads": "baseline",
                                             "ablate": 1})
    if baseline:
        table["baseline"] = (None, {"threads": "baseline", "ablate": 0})
    kernel = next(iter(KINDS[family].values()))[0]
    if args.sass:
        for name in names:
            counts = sass_counts(OUT / "lib{}.so".format(name), kernel)
            print("{} {} SASS (static): {}".format(
                name, kernel, ", ".join("{} {}".format(k, v)
                                        for k, v in counts.items())),
                flush=True)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    todo = (forward_cases(dev, mode) if args.forward else
            adjoint_cases(fwd_lib, dev, mode, stream))
    tol = chip_smoke.GRAD_RTOL if args.exact else chip_smoke.MODE_RTOL
    runs, rels, diffs, ref, failed = {}, {}, {}, {}, []
    names = first + names
    for name in names:
        shape = table[name][1]
        for case_name, case in todo.items():
            made = launcher(libs[name][0], name, case, stream, sms)
            if made is None:
                continue
            run, out = made
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
            if case_name in ref:
                diffs[name, case_name] = float(
                    (out - ref[case_name]).abs().max())
            else:
                ref[case_name] = out.clone()
    names = [n for n in names if n not in failed]
    times = {key: [] for key in runs if key[0] in names}
    for order in (names, names[::-1]):
        for name in order:
            for case_name in todo:
                if (name, case_name) in times:
                    times[name, case_name].append(chip_smoke.cuda_ms(
                        runs[name, case_name], 10))
    print("resident_variants ({}, {}): {}".format(family, mode, ", ".join(
        "{} bound {:.3f} ms".format(c, v[4]) for c, v in todo.items())),
        flush=True)
    tc = int(not args.exact)
    for name in names:
        shape = table[name][1]
        regs = []
        for kind, (kern, smem) in KINDS[family].items():
            if name == "baseline_products":
                if kind != "chain_fwd":
                    continue
                kern = "baseline_products_kernel"
            found = [v for k, v in libs[name][1].items() if kern in k and (
                name != "baseline" or _baseline_entry(family, k, tc))]
            if smem is None:
                smem = (7 if shape.get("pair") else 6) * SLOT + 16
            regs.append("{} {} registers / {} B spilled, {} B shared".format(
                kind, *(found[0] if found else (None, None)), smem))
        rows = []
        for case_name in todo:
            if (name, case_name) not in times:
                continue
            t = times[name, case_name]
            row = "{} {:.3f}, {:.3f} ms ({:.0%} of bound".format(
                case_name, *t, todo[case_name][4] / min(t))
            if (name, case_name) in rels:
                row += ", rel {:.1e}".format(rels[name, case_name])
            if (name, case_name) in diffs:
                row += ", max|diff| vs {} {:.1e}".format(
                    names[0], diffs[name, case_name])
            rows.append(row + ")")
        print("{} ({}; ptxas {}): {}".format(
            name, " ".join("{} {}".format(k, v) for k, v in shape.items()),
            "; ".join(regs), "; ".join(rows)), flush=True)
    whole_case, planes_case = WHOLE[family]
    for name in names:
        twin = name + "_products"
        if twin not in names or (name, planes_case) not in times:
            continue
        whole = min(times[name, whole_case])
        parts = {
            "products, barriers, staging and build (elementwise passes "
            "reduced to stores)": min(times[twin, whole_case]),
            "without the generator build (A_t from planes)": min(
                times[name, planes_case]),
        }
        print("{} ablation at the headline ({}, {:.3f} ms whole): {}; so "
              "the elementwise passes {:.0%}, the build {:.0%}".format(
                  name, whole_case, whole, "; ".join(
                      "{} {:.3f} ms ({:.0%})".format(k, v, v / whole)
                      for k, v in parts.items()),
                  1 - list(parts.values())[0] / whole,
                  1 - list(parts.values())[1] / whole), flush=True)
    if failed:
        raise SystemExit("variants that disagree with their plain versions: "
                         + ", ".join(sorted(set(failed))))


if __name__ == "__main__":
    main()
