"""What the adaptive RKDP5 integrator needs, in attempts, by dtype and atol.

    python3 profiling/rkdp5_attempts.py [--device cpu]

Runs the port's RKDP5 integrator (``qoc_tpu_torch/ops/rkdp5.py``, plain
torch) through the public Lindblad entry points on the card (or, with
``--device cpu``, the CPU) and prints, for each case, the attempts an
interval it ran and those in which the lane was active, the host reads
(``ops.rkdp5``'s counters, through ``chip_smoke._rkdp5_counted``), the
wall time and whether the result is finite:

- examples/1_transmon_pi_decoherence.py's problem (d = 2, T1 = 1000, 11
  control points, one interval of T = 10, maximum norm 5, its flat initial
  controls; ``chip_smoke.example1_problem``): evolve (the forward-only
  integrator, no bound on attempts) in float64 and float32 at atol 1e-12
  and 1e-8; then the GRAPE loss and gradient at bench.py's settings
  (``bench.py:177`` ``_lindblad_step``: atol 1e-8, rkdp5_max_steps 256) in
  float32 and float64, and in float32 with 16384 attempts;
- a problem shaped like the d = 20 cell (bench.py's construction,
  ``chip_smoke.lindblad_problem``: H = 0.1 n + c a + c* a^H, T1 rate 1e-3,
  one interval of T = 100, 11 control points): the loss (the bounded
  integrator, 16384 attempts, no gradient) in float64 at atol 1e-12 and in
  float32 at atol 1e-12 and 1e-8.

Prints the device's name and power limit first. Imports nothing of JAX.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the problems; no JAX)
from qoc_tpu_torch import evolve_lindblad_discrete  # noqa: E402
from qoc_tpu_torch.core.common import (slap_controls_torch,  # noqa: E402
                                       strip_controls)
from qoc_tpu_torch.core.lindblad import build_lindblad_loss  # noqa: E402
from qoc_tpu_torch.models import LindbladMethod  # noqa: E402

MAX_STEPS = 16384


def counted(label, run):
    """Run ``run()`` and print chip_smoke's line of its counts (attempts
    an interval, host reads, wall time) and whether it is finite."""
    value, line = chip_smoke._rkdp5_counted(run, 1)
    print("{}: {}, {}".format(
        label, line, "finite" if np.all(np.isfinite(value)) else "NaN"),
        flush=True)


def loss_value(kw, device, dtype, atol, max_steps, gradient):
    """The GRAPE loss (and its gradient) of the problem ``kw`` at its
    initial controls, through build_lindblad_loss under RKDP5."""
    pstate = chip_smoke.lindblad_pstate(dict(kw,
                                             method=LindbladMethod.RKDP5))
    pstate.atol, pstate.rkdp5_max_steps = atol, max_steps
    loss = build_lindblad_loss(pstate, device, dtype)
    flat = torch.as_tensor(strip_controls(True, kw["initial_controls"]),
                           dtype=dtype, device=device)
    if not gradient:
        with torch.no_grad():
            return loss(slap_controls_torch(True, flat, pstate.controls_shape)
                        )[0].cpu().numpy()
    flat.requires_grad_(True)
    error = loss(slap_controls_torch(True, flat, pstate.controls_shape))[0]
    grad, = torch.autograd.grad(error, flat)
    return np.append(grad.cpu().numpy(), float(error.detach()))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    device = torch.device(parser.parse_args().device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0])
    else:
        print("cpu")
    example1 = chip_smoke.example1_problem()
    evolve_kw = {k: example1[k] for k in (
        "evolution_time", "initial_densities", "system_eval_count", "costs",
        "hamiltonian", "lindblad_data")}
    for dtype in (torch.float64, torch.float32):
        for atol in (1e-12, 1e-8):
            counted("example 1 evolve, {}, atol {:g}".format(
                str(dtype)[6:], atol), lambda: evolve_lindblad_discrete(
                    controls=example1["initial_controls"], atol=atol,
                    device=device, dtype=dtype, **evolve_kw).final_densities)
    for dtype, max_steps in ((torch.float32, 256), (torch.float64, 256),
                             (torch.float32, MAX_STEPS)):
        counted("example 1 loss and gradient, {}, atol 1e-8, "
                "rkdp5_max_steps {}".format(str(dtype)[6:], max_steps),
                lambda: loss_value(example1, device, dtype, 1e-8, max_steps,
                                   True))
    d20 = chip_smoke.lindblad_problem(chip_smoke.D20, 11, 2, 100.0)
    for dtype, atol in ((torch.float64, 1e-12), (torch.float32, 1e-12),
                        (torch.float32, 1e-8)):
        counted("d = 20, T = 100 loss, {}, atol {:g}, rkdp5_max_steps "
                "{}".format(str(dtype)[6:], atol, MAX_STEPS),
                lambda: loss_value(d20, device, dtype, atol, MAX_STEPS,
                                   False))


if __name__ == "__main__":
    main()
