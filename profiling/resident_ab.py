"""The resident chain kernels and the GRAPE rates they carry, for an A/B of
two trees in one call.

    python3 profiling/resident_ab.py [--tree DIR]

Imports qoc_tpu_torch and chip_smoke.py from DIR (default: this checkout)
and prints one line, tagged with DIR: K1 and K2 at the Table-3 headline's
shapes (K2 with last-step and with per-step seeds), K5's forward and
adjoint at the M4 planes (both seed modes) and K4 at the M4 planes (d = 64),
in ms (CUDA events, 20 launches after a warm-up); then the headline's and
the step-cost headline's GRAPE rates (2 warm-up + 30 timed iterations,
it/s). Run it on two trees in turns (parent, change, change, parent) in one
call: the kernels build into each tree's own qoc_tpu_torch/_build. Needs
one CUDA device.
"""

import argparse
import importlib
import sys
from pathlib import Path

import torch

REPEATS = 20
WARMUP, TIMED = 2, 30


def kernel_times(cs, chain, expm_cuda, dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    op = chain.ChainExpmPropagate(cs.table3_basis(), dev, torch.float32)
    w = cs.headline_weights(cs.table3_problem(1)[0], dev)
    s_count, length = chain.segment_plan(w.shape[0])
    w_seg = torch.zeros((s_count * length, op.n_b), device=dev)
    w_seg[:w.shape[0]] = w
    w_seg = w_seg.reshape(s_count, length, op.n_b)
    n1, ninf = chain._norm_max(w, op.basis_ri, op.d)
    pref = chain.chain_fwd(w_seg, op.basis, n1)
    dp = op.dp
    last = torch.randn((s_count, dp, dp), dtype=torch.complex64, device=dev,
                       generator=gen)
    steps = torch.randn((s_count, length, dp, dp), dtype=torch.complex64,
                        device=dev, generator=gen)
    ms = {
        "K1": cs.cuda_ms(lambda: chain.chain_fwd(w_seg, op.basis, n1),
                         REPEATS),
        "K2 last-step": cs.cuda_ms(lambda: chain.chain_bwd(
            w_seg, op.basis_h, ninf, pref, last), REPEATS),
        "K2 per-step": cs.cuda_ms(lambda: chain.chain_bwd(
            w_seg, op.basis_h, ninf, pref, steps), REPEATS),
    }
    planes = cs.m4_planes(dev)
    a_seg, n1, ninf = cs._segment_planes(planes)
    s_count, length = a_seg.shape[:2]
    pref = chain.plane_fwd(a_seg, n1)
    last = torch.randn((s_count, dp, dp), dtype=torch.complex64, device=dev,
                       generator=gen)
    steps = torch.randn((s_count, length, dp, dp), dtype=torch.complex64,
                        device=dev, generator=gen)
    g = torch.randn(planes.shape, dtype=torch.complex64, device=dev,
                    generator=gen)
    ah = planes.mH.contiguous()
    ms.update({
        "K5 fwd": cs.cuda_ms(lambda: chain.plane_fwd(a_seg, n1), REPEATS),
        "K5 bwd last-step": cs.cuda_ms(lambda: chain.plane_bwd(
            a_seg, ninf, pref, last), REPEATS),
        "K5 bwd per-step": cs.cuda_ms(lambda: chain.plane_bwd(
            a_seg, ninf, pref, steps), REPEATS),
        "K4 M4 planes": cs.cuda_ms(lambda: expm_cuda.expm_frechet_fwd(ah, g),
                                   REPEATS),
    })
    return ms


def grape_rate(cs, dev, step_cost):
    from qoc_tpu_torch import grape_schroedinger_discrete
    pstate, hamiltonian, costs = (cs.stepcost_problem(1) if step_cost
                                  else cs.table3_problem(1))
    result = grape_schroedinger_discrete(
        cs.CONTROL_COUNT, cs.CONTROL_EVAL_COUNT, costs, cs.EVOLUTION_TIME,
        hamiltonian, pstate.initial_states, cs.SYSTEM_EVAL_COUNT,
        complex_controls=True, initial_controls=pstate.initial_controls,
        iteration_count=WARMUP + TIMED, log_iteration_step=0,
        max_control_norms=pstate.max_control_norms, fused_chunk=WARMUP,
        device=dev)
    if result.iteration_count_ran != WARMUP + TIMED:
        raise RuntimeError("GRAPE stopped early")
    return result.iterations_per_s


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve()
                                              .parent.parent))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("resident_ab: needs a CUDA device.")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs = importlib.import_module("chip_smoke")
    from qoc_tpu_torch.ops import chain, expm_cuda
    if Path(chain.__file__).resolve().parents[2] != tree:
        raise SystemExit("resident_ab: imported qoc_tpu_torch from {}, not "
                         "{}".format(chain.__file__, tree))
    chain.load_kernels()
    ms = kernel_times(cs, chain, expm_cuda, dev)
    rates = {"headline GRAPE": grape_rate(cs, dev, False),
             "step-cost headline GRAPE": grape_rate(cs, dev, True)}
    print("resident_ab {} ({}): ".format(tree.name, torch.cuda
                                         .get_device_name(0))
          + ", ".join("{} {:.3f} ms".format(k, v) for k, v in ms.items())
          + "; " + ", ".join("{} {:.2f} it/s".format(k, v)
                             for k, v in rates.items()), flush=True)


if __name__ == "__main__":
    main()
