"""Carry problem data from ``qoc_tpu`` objects over to qoc_tpu_torch.

``qoc_tpu`` keeps its problem data as host numpy on its objects
(``LinearHamiltonian.h0`` / ``.operators``, the costs' conjugated targets),
so these functions read attributes by duck typing and never import
``qoc_tpu`` or ``jax``. Arrays come back as numpy in float64/complex128,
the form the port's constructors take; the Adam state comes back as
tensors on the requested device.
"""

import numpy as np
import torch

from qoc_tpu_torch.costs import TargetDensityInfidelity, TargetStateInfidelity
from qoc_tpu_torch.models import ConstantLindblad, LinearHamiltonian

__all__ = ["adam_state", "constant_lindblad", "controls", "densities",
           "linear_hamiltonian", "max_control_norms", "states",
           "target_density_infidelity", "target_state_infidelity"]


def linear_hamiltonian(hamiltonian):
    """A port ``LinearHamiltonian`` with the same ``h0`` and
    ``operators``."""
    return LinearHamiltonian(np.asarray(hamiltonian.h0, dtype=np.complex128),
                             np.asarray(hamiltonian.operators,
                                        dtype=np.complex128))


def states(array):
    """Initial or target states (K, d, 1) as complex128 numpy."""
    return np.asarray(array, dtype=np.complex128)


def densities(array):
    """Initial or target densities (K, d, d) as complex128 numpy."""
    return np.asarray(array, dtype=np.complex128)


def constant_lindblad(lindblad_data):
    """A port ``ConstantLindblad`` with the same rates (float64) and
    collapse operators (complex128)."""
    rates, operators = lindblad_data.dissipators, lindblad_data.operators
    return ConstantLindblad(
        None if rates is None else np.asarray(rates, dtype=np.float64),
        None if operators is None
        else np.asarray(operators, dtype=np.complex128))


def controls(array):
    """Control values (E, C): complex128 if complex, else float64."""
    array = np.asarray(array)
    return array.astype(np.complex128 if np.iscomplexobj(array)
                        else np.float64)


def max_control_norms(norms):
    """Per-channel maximum control norms (C,) as float64 numpy."""
    return np.asarray(norms, dtype=np.float64)


def target_state_infidelity(cost):
    """A port ``TargetStateInfidelity`` with the same targets, phase mode
    and multiplier (the targets are recovered from ``qoc_tpu``'s stored
    conjugate transposes)."""
    dagger = np.asarray(cost.target_states_dagger)
    targets = np.conjugate(np.swapaxes(dagger, -1, -2))
    return TargetStateInfidelity(
        targets, cost_multiplier=cost.cost_multiplier,
        neglect_relative_phase=cost.neglect_relative_phase)


def target_density_infidelity(cost):
    """A port ``TargetDensityInfidelity`` with the same targets and
    multiplier (recovered from ``qoc_tpu``'s stored conjugate
    transposes)."""
    dagger = np.asarray(cost.target_densities_dagger)
    return TargetDensityInfidelity(
        np.conjugate(np.swapaxes(dagger, -1, -2)),
        cost_multiplier=cost.cost_multiplier)


def adam_state(state, device="cpu", dtype=torch.float64):
    """An Adam state ``{"m", "v", "t"}`` (arrays or numbers) as the port's
    state dict of tensors."""
    return {
        "m": torch.tensor(np.asarray(state["m"]), dtype=dtype,
                          device=device),
        "v": torch.tensor(np.asarray(state["v"]), dtype=dtype,
                          device=device),
        "t": torch.tensor(int(np.asarray(state["t"])), dtype=torch.int32,
                          device=device),
    }
