"""How far a rounding moves the adaptive RKDP5 integrator's result.

    python3 profiling/rkdp5_sensitivity.py [--device cpu]

The step controller accepts or rejects an attempt by comparing an error
estimate with 1, so a change of the input in its last bits can flip a
decision and move the result by up to the integrator's own error. This
script measures that, with the port alone (float64, on the CPU by default,
or ``--device cuda``), to set the tolerances of the tests that hold the
port to ``qoc_tpu``:

- examples/1_transmon_pi_decoherence.py's problem
  (``chip_smoke.example1_problem``), 5 Adam iterations at atol 1e-12: the
  largest change of the errors when the drift is scaled by 1 + 1e-15;
- the same problem with ``LBFGSB()`` (scipy's line search on the host
  loop; the example's own optimizer), 3 iterations at atol 1e-12 (phase 43
  of chip_smoke.py), and 1 at atol 1e-10 and rkdp5_max_steps 512 through
  an identity ``impose_control_conditions`` hook (tests/test_torch_lbfgs.py's
  settings): the largest change of the errors of every evaluation, of the
  best controls and of the best final densities under the same scaling;
- the RKDP5 ensemble of tests/test_torch_lindblad_ensemble.py (example 6's
  construction at d = 2: 3 detuning members in [-0.02, 0.02], 6 control
  points drawn from seed 6, 3 intervals of T = 2, atol 1e-10): the largest
  change of the members' final densities when the controls are scaled by
  1 + 1e-15.

Prints each change beside the integrator's attempts. Imports nothing of
JAX.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (example 1; no JAX)
from qoc_tpu_torch import (LBFGSB, ConstantLindblad,  # noqa: E402
                           EnsembleLinearHamiltonian, LinearHamiltonian,
                           TargetDensityInfidelity, grape_lindblad_discrete)
from qoc_tpu_torch.models import LindbladMethod  # noqa: E402
from qoc_tpu_torch.parallel import build_lindblad_ensemble_loss  # noqa: E402


def example1_errors(device, scale):
    """Example 1's 5 GRAPE errors with the drift scaled by ``scale``."""
    kw = chip_smoke.example1_problem()
    kw["hamiltonian"] = LinearHamiltonian(kw["hamiltonian"].h0 * scale,
                                          kw["hamiltonian"].operators)
    result, line = chip_smoke._rkdp5_counted(
        lambda: grape_lindblad_discrete(
            iteration_count=5, log_iteration_step=0, atol=1e-12,
            device=device, dtype=torch.float64, **kw), 5)
    return np.asarray(result.errors), line


def example1_lbfgsb(iterations, atol, max_steps, hook=None):
    """(device, scale) -> example 1's LBFGSB GRAPE (through ``hook``, an
    impose_control_conditions hook, where given) with the drift scaled by
    ``scale``: its errors, best controls and best final densities, and its
    counts line."""
    def run(device, scale):
        kw = chip_smoke.example1_problem()
        kw["hamiltonian"] = LinearHamiltonian(kw["hamiltonian"].h0 * scale,
                                              kw["hamiltonian"].operators)
        result, line = chip_smoke._rkdp5_counted(
            lambda: grape_lindblad_discrete(
                iteration_count=iterations, log_iteration_step=0,
                optimizer=LBFGSB(), atol=atol, rkdp5_max_steps=max_steps,
                impose_control_conditions=hook, device=device,
                dtype=torch.float64, **kw), iterations)
        return {"errors": np.asarray(result.errors),
                "controls": result.best_controls,
                "densities": result.best_final_densities}, line
    return run


def ensemble_densities(device, scale):
    """The members' final densities of the tests' RKDP5 ensemble, its
    controls scaled by ``scale``."""
    a = np.array([[0, 1], [0, 0]], dtype=complex)
    h0 = np.diag([0.5, -0.5]).astype(complex)
    rng = np.random.default_rng(6)
    controls = 0.3 * (rng.normal(size=(6, 1)) + 1j * rng.normal(size=(6, 1)))
    initial = np.zeros((1, 2, 2), dtype=complex)
    initial[0, 0, 0] = 1
    target = np.zeros((1, 2, 2), dtype=complex)
    target[0, 1, 1] = 1
    kw = dict(control_count=1, control_eval_count=6,
              costs=[TargetDensityInfidelity(target)], evolution_time=2.0,
              initial_densities=initial, system_eval_count=4,
              hamiltonian=EnsembleLinearHamiltonian(h0, a[None], h0[None]),
              initial_controls=controls, max_control_norms=np.full(1, 10.0),
              lindblad_data=ConstantLindblad(np.array([1e-3]), a[None]),
              method=LindbladMethod.RKDP5,
              hamiltonian_params=np.linspace(-0.02, 0.02, 3)[:, None])
    pstate = chip_smoke.lindblad_pstate(kw)
    pstate.atol, pstate.rkdp5_max_steps = 1e-10, 1024
    loss = build_lindblad_ensemble_loss(
        pstate, kw["hamiltonian"], kw["hamiltonian_params"], device=device,
        dtype=torch.float64)
    with torch.no_grad():
        densities, line = chip_smoke._rkdp5_counted(
            lambda: loss(torch.as_tensor(controls * scale,
                                         device=device))[1], 1)
    return densities.cpu().numpy(), line


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cpu")
    device = torch.device(parser.parse_args().device)
    for name, run in (("example 1 GRAPE errors (5 iterations, atol 1e-12)",
                       example1_errors),
                      ("RKDP5 ensemble final densities (3 members, atol "
                       "1e-10)", ensemble_densities),
                      ("example 1 LBFGSB GRAPE (3 iterations, atol 1e-12)",
                       example1_lbfgsb(3, 1e-12, 16384)),
                      ("example 1 LBFGSB GRAPE (1 iteration, atol 1e-10, "
                       "512 attempts, identity hook)",
                       example1_lbfgsb(1, 1e-10, 512, lambda c: c))):
        base, line = run(device, 1.0)
        moved, moved_line = run(device, 1.0 + 1e-15)
        if isinstance(base, dict):
            change = ", ".join("{} {:.3e}".format(key, float(np.abs(
                moved[key] - base[key]).max()) if moved[key].shape
                == base[key].shape else float("inf")) for key in base)
        else:
            change = "{:.3e}".format(float(np.abs(moved - base).max()))
        print("{} on {}: max|change| {} under a 1 + 1e-15 scaling; "
              "{} (scaled: {})".format(name, device.type, change, line,
                                       moved_line), flush=True)


if __name__ == "__main__":
    main()
