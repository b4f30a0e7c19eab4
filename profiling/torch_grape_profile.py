"""Where the time of a qoc_tpu_torch GRAPE iteration goes, on one CUDA card.

Run from the root of a checkout, with one NVIDIA GPU and nvcc:

    python3 profiling/torch_grape_profile.py [--json PATH]

For the Table-3 headline (LinearHamiltonian, M2: the fused route, K1/K2),
the Magnus-M4 problem of the JAX package's bench_m4 (the plane route, K5),
the d = 2^7 problem (d = 128, 2001 points, M2: the blocked route, K3/K4),
the Table-1 d = 2^10 single-step backprop (the blocked route on
torch.matmul, no kernel), the Lindblad d = 20 cell (superoperator 400,
100 steps, MAGNUS_EXPM: the streamed route, K6), and the step-cost cells
(the headline with the JAX package's bench_stepcost ForbidStates at
cost_eval_step 1 and 10: K1, K2 in its per-step-seed mode and the
trajectory glue; the d = 20 cell with its density step costs: K6 in its
per-step-seed mode), the 4- and 16-member ensembles of chip_smoke's phase
27 (K1/K2's member axis; 16 members also with ForbidStates), the
512-candidate multistart of its phase 29, and the 4- and 16-member d = 20
Lindblad ensembles of its phase 32 and the 16-candidate d = 20 Lindblad
multistart of its phase 33 (K6's member axis), and Lindblad example 1
under RKDP5 in float32 at atol 1e-8 (the adaptive integrator of phase 42,
plain torch, no kernel), all built as chip_smoke.py builds them, it runs one GRAPE iteration the way core/graperunner.py does
(clip, loss, gradient, Adam update; chip_smoke.make_iteration), or one
iteration of the multistart runner (chip_smoke.make_multistart_iteration):
2 warm-up iterations, then 10
timed without the profiler (host clock, one synchronise at the end), then
5 under torch.profiler. It prints the card's name and power limit, the
unprofiled ms per iteration, the device time of each kernel class per
iteration, the device's busy and idle share of the profiled window and the
peak device memory; ``--json PATH`` also writes them to PATH as JSON,
``--cells 0,9`` profiles only the listed cells (by their order above), and
``--modes highest,bf16_3x`` profiles each of them in each precision mode
(``config.MXU_MODE``, in that order, in one call; by default the mode that
``QOC_TPU_MXU_PRECISION`` chose); every cell runs in either mode (the
d = 2^10 backprop's products on torch.matmul as the 3-pass split).
``--optimizer lbfgs`` runs the GRAPE cells' iterations with the device
L-BFGS (``LBFGS()``: the loss and gradient, then the line search's
``ls_steps`` + 1 forward losses) in place of Adam; the multistart cells
keep Adam.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (problem builders; imports no JAX)
from qoc_tpu_torch.core.lindblad import build_lindblad_loss  # noqa: E402

WARMUP, TIMED, PROFILED = 2, 10, 5
KERNELS = (("chain_fwd_kernel", "K1"), ("chain_bwd_kernel", "K2"),
           ("plane_fwd_kernel", "K5 fwd"), ("plane_bwd_kernel", "K5 bwd"),
           ("expm_resident_kernel", "K3"), ("frechet_resident_kernel", "K4"),
           ("stream_fwd_kernel", "K6 fwd"), ("stream_bwd_kernel", "K6 bwd"))


def _class(name):
    for key, label in KERNELS:
        if key in name:
            return label
    if "expm_tiled_kernel" in name:    # Tiled<T, false, ...> is K3, true K4
        return "K4" if ", true," in name else "K3"
    lower = name.lower()
    if "gemm" in lower or "cutlass" in lower:
        return "glue matmuls (cuBLAS)"
    if "memcpy" in lower or "memset" in lower:
        return "glue copies"
    return "glue elementwise/reductions"


def ensemble_loss(hamiltonian, params):
    """build_loss of chip_smoke.make_iteration for an ensemble."""
    from qoc_tpu_torch.parallel import build_ensemble_loss
    return lambda pstate, dev, dtype: build_ensemble_loss(
        pstate, hamiltonian, params, device=dev, dtype=dtype)


# The GRAPE cells' optimizer (--optimizer): "adam", the problems' own, or
# "lbfgs".
OPTIMIZER = {"name": "adam"}


def grape_cell(pstate, build_loss=None):
    """(dev -> a cell's iteration) of a GRAPE problem, with the optimizer
    that --optimizer names."""
    def build(dev):
        from qoc_tpu_torch import LBFGS
        return chip_smoke.make_iteration(
            pstate, dev, build_loss,
            LBFGS() if OPTIMIZER["name"] == "lbfgs" else None)
    return build


def ensemble_cell(n_members, step_costs=()):
    pstate, ham, params, _ = chip_smoke.ensemble_problem(
        n_members, step_costs=step_costs)
    return grape_cell(pstate, ensemble_loss(ham, params))


def lindblad_ensemble_cell(n_members):
    kw = chip_smoke.lindblad_ensemble_problem(n_members)
    return grape_cell(chip_smoke.lindblad_pstate(kw), ensemble_loss(
        kw["hamiltonian"], kw["hamiltonian_params"]))


def lindblad_multistart_cell(n_starts):
    kw = chip_smoke.lindblad_d20_problem()
    return lambda dev: chip_smoke.make_multistart_iteration(
        chip_smoke.lindblad_pstate(kw), kw["hamiltonian"], None, n_starts,
        dev)


def multistart_cell(n_starts):
    pstate, ham, _ = chip_smoke.multistart_problem()
    return lambda dev: chip_smoke.make_multistart_iteration(
        pstate, ham, None, n_starts, dev)


def rkdp5_cell():
    """Example 1 (chip_smoke.example1_problem) under RKDP5 at atol 1e-8."""
    from qoc_tpu_torch.models import LindbladMethod
    pstate = chip_smoke.lindblad_pstate(dict(
        chip_smoke.example1_problem(), method=LindbladMethod.RKDP5))
    pstate.atol = chip_smoke.RKDP5_F32_ATOL
    return grape_cell(pstate, build_lindblad_loss)


def cells():
    """(name, dev -> iteration) of every cell, in the order of --cells."""
    return [
        ("headline M2 (fused, K1/K2)",
         grape_cell(chip_smoke.table3_problem(1)[0])),
        ("bench_m4 M4 (plane, K5)", grape_cell(chip_smoke.m4_problem(1)[0])),
        ("d=128 M2 (blocked, K3/K4)",
         grape_cell(chip_smoke.d128_problem()[0])),
        ("d=1024 backprop (blocked, torch.matmul)",
         grape_cell(chip_smoke.d1024_problem()[0])),
        ("Lindblad d=20 (streamed, K6)",
         grape_cell(chip_smoke.lindblad_d20_pstate(), build_lindblad_loss)),
        ("step-cost headline (fused, K1/K2 per-step)",
         grape_cell(chip_smoke.stepcost_problem()[0])),
        ("step-cost headline, cost_eval_step 10",
         grape_cell(chip_smoke.stepcost_problem(
             chip_smoke.THINNED_COST_EVAL_STEP)[0])),
        ("Lindblad d=20 step costs (streamed, K6 per-step)",
         grape_cell(chip_smoke.lindblad_d20_pstate(
             chip_smoke.d20_step_costs()), build_lindblad_loss)),
        ("ensemble 4 members (fused, K1/K2 member axis)", ensemble_cell(4)),
        ("ensemble 16 members (fused, K1/K2 member axis)",
         ensemble_cell(16)),
        ("ensemble 16 members step costs (K2 member axis per-step)",
         ensemble_cell(16, [chip_smoke.forbid_level(
             chip_smoke.D, chip_smoke.M4_STEPS)])),
        ("multistart 512 candidates (fused, K1/K2 member axis)",
         multistart_cell(512)),
        ("Lindblad ensemble d=20, 4 members (streamed, K6 member axis)",
         lindblad_ensemble_cell(4)),
        ("Lindblad ensemble d=20, 16 members (streamed, K6 member axis)",
         lindblad_ensemble_cell(16)),
        ("Lindblad multistart d=20, 16 candidates (streamed, K6 member "
         "axis)", lindblad_multistart_cell(16)),
        ("Lindblad example 1 RKDP5, atol 1e-8 (plain torch)",
         rkdp5_cell()),
    ]


def profile_cell(name, build_iteration, dev):
    iteration = build_iteration(dev)
    for _ in range(WARMUP):
        iteration()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    for _ in range(TIMED):
        iteration()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3 / TIMED
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(PROFILED):
            iteration()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - start) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("torch.profiler recorded no device time")
    by_class = {}
    for e in device:
        label = _class(e.name)
        by_class[label] = by_class.get(label, 0.0) + e.time_range.elapsed_us()
    # Busy time: the union of the device intervals (one stream, so the sum
    # up to overlaps of copies).
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    busy += cur_end - cur_start
    first = min(s for s, _ in spans)
    last = max(e for _, e in spans)
    result = {
        "cell": name,
        "ms_per_iteration_unprofiled": wall_ms,
        "it_s_unprofiled": 1e3 / wall_ms,
        "device_ms_per_iteration": {k: v / 1e3 / PROFILED
                                    for k, v in sorted(by_class.items())},
        "device_busy_ms_per_iteration": busy / 1e3 / PROFILED,
        "profiled_window_ms_per_iteration": window_us / 1e3 / PROFILED,
        "device_span_ms_per_iteration": (last - first) / 1e3 / PROFILED,
        "idle_share_of_window": 1.0 - busy / window_us,
        "kernel_launches_per_iteration": len(device) / PROFILED,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    print("{}: {:.3f} ms/iteration unprofiled ({:.2f} it/s); device busy "
          "{:.3f} of {:.3f} ms profiled (idle {:.1%}), {:.0f} device "
          "kernels/iteration, peak {:.2f} GB".format(
              name, wall_ms, 1e3 / wall_ms,
              result["device_busy_ms_per_iteration"],
              result["profiled_window_ms_per_iteration"],
              result["idle_share_of_window"],
              result["kernel_launches_per_iteration"],
              result["peak_memory_gb"]), flush=True)
    for label, ms in sorted(result["device_ms_per_iteration"].items(),
                            key=lambda kv: -kv[1]):
        print("  {:32s} {:8.3f} ms  {:5.1%}".format(
            label, ms, ms / result["device_busy_ms_per_iteration"]))
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, help="write the results here")
    parser.add_argument("--cells", help="comma-separated cell indices "
                        "(default: all)")
    parser.add_argument("--modes", help="comma-separated precision modes, "
                        "each cell profiled in each (default: the "
                        "QOC_TPU_MXU_PRECISION mode)")
    parser.add_argument("--optimizer", choices=("adam", "lbfgs"),
                        default="adam", help="the GRAPE cells' optimizer "
                        "(default: adam)")
    args = parser.parse_args()
    OPTIMIZER["name"] = args.optimizer
    if not torch.cuda.is_available():
        raise SystemExit("torch_grape_profile: needs a CUDA device.")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    chosen = cells()
    if args.cells:
        chosen = [chosen[int(i)] for i in args.cells.split(",")]
    from qoc_tpu_torch import config
    modes = args.modes.split(",") if args.modes else [config.MXU_MODE]
    results = []
    for mode in modes:
        config.MXU_MODE = config.mxu_mode(torch.float32, mode)
        for name, build in chosen:
            result = profile_cell("{} [{}, {}]".format(
                name, mode, args.optimizer), build, dev)
            result["mode"] = mode
            result["optimizer"] = args.optimizer
            results.append(result)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "cells": results},
                                        indent=1))


if __name__ == "__main__":
    main()
