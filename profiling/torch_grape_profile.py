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
per-step-seed mode), all built as chip_smoke.py builds them, it runs
one GRAPE iteration the way core/graperunner.py does (clip, loss, gradient,
Adam update; chip_smoke.make_iteration): 2 warm-up iterations, then 10
timed without the profiler (host clock, one synchronise at the end), then
5 under torch.profiler. It prints the card's name and power limit, the
unprofiled ms per iteration, the device time of each kernel class per
iteration, the device's busy and idle share of the profiled window and the
peak device memory; ``--json PATH`` also writes them to PATH as JSON.
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
    if "expm_tiled_kernel" in name:    # <T, false> is K3, <T, true> K4
        return "K4" if "true>" in name else "K3"
    lower = name.lower()
    if "gemm" in lower or "cutlass" in lower:
        return "glue matmuls (cuBLAS)"
    if "memcpy" in lower or "memset" in lower:
        return "glue copies"
    return "glue elementwise/reductions"


def profile_cell(name, pstate, dev, build_loss=None):
    iteration = chip_smoke.make_iteration(pstate, dev, build_loss)
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_grape_profile: needs a CUDA device.")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    results = [profile_cell("headline M2 (fused, K1/K2)",
                            chip_smoke.table3_problem(1)[0], dev),
               profile_cell("bench_m4 M4 (plane, K5)",
                            chip_smoke.m4_problem(1)[0], dev),
               profile_cell("d=128 M2 (blocked, K3/K4)",
                            chip_smoke.d128_problem()[0], dev),
               profile_cell("d=1024 backprop (blocked, torch.matmul)",
                            chip_smoke.d1024_problem()[0], dev),
               profile_cell("Lindblad d=20 (streamed, K6)",
                            chip_smoke.lindblad_d20_pstate(), dev,
                            build_lindblad_loss),
               profile_cell("step-cost headline (fused, K1/K2 per-step)",
                            chip_smoke.stepcost_problem()[0], dev),
               profile_cell("step-cost headline, cost_eval_step 10",
                            chip_smoke.stepcost_problem(
                                chip_smoke.THINNED_COST_EVAL_STEP)[0], dev),
               profile_cell("Lindblad d=20 step costs (streamed, K6 "
                            "per-step)", chip_smoke.lindblad_d20_pstate(
                                chip_smoke.d20_step_costs()), dev,
                            build_lindblad_loss)]
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "cells": results},
                                        indent=1))


if __name__ == "__main__":
    main()
