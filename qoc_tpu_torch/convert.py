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

from qoc_tpu_torch.costs import (ForbidDensities, ForbidStates,
                                 TargetDensityInfidelity,
                                 TargetDensityInfidelityTime,
                                 TargetStateInfidelity,
                                 TargetStateInfidelityTime)
from qoc_tpu_torch.models import ConstantLindblad, LinearHamiltonian

__all__ = ["adam_state", "constant_lindblad", "controls", "densities",
           "forbid_densities", "forbid_states", "linear_hamiltonian",
           "max_control_norms", "states", "target_density_infidelity",
           "target_density_infidelity_time", "target_state_infidelity",
           "target_state_infidelity_time"]


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
    return TargetStateInfidelity(
        _undagger(cost.target_states_dagger),
        cost_multiplier=cost.cost_multiplier,
        neglect_relative_phase=cost.neglect_relative_phase)


def target_density_infidelity(cost):
    """A port ``TargetDensityInfidelity`` with the same targets and
    multiplier (recovered from ``qoc_tpu``'s stored conjugate
    transposes)."""
    return TargetDensityInfidelity(_undagger(cost.target_densities_dagger),
                                   cost_multiplier=cost.cost_multiplier)


def _undagger(dagger):
    """Arrays back from their stored conjugate transposes."""
    return np.conjugate(np.swapaxes(np.asarray(dagger), -1, -2))


# The step costs keep their evaluation count, (system_eval_count - 1) //
# cost_eval_step, and not its two factors: the port's cost is built with
# system_eval_count = count + 1 and cost_eval_step = 1, which gives the
# same count.


def target_state_infidelity_time(cost):
    """A port ``TargetStateInfidelityTime`` with the same targets, phase
    mode, evaluation count and multiplier."""
    return TargetStateInfidelityTime(
        int(cost.cost_eval_count) + 1, _undagger(cost.target_states_dagger),
        cost_multiplier=cost.cost_multiplier,
        neglect_relative_phase=cost.neglect_relative_phase)


def forbid_states(cost):
    """A port ``ForbidStates`` with the same (possibly ragged) forbidden
    states per evolving state, evaluation count and multiplier."""
    forbidden = [_undagger(f) for f in cost.forbidden_states_dagger]
    count = int(cost.cost_normalization_constant) // len(forbidden)
    return ForbidStates(forbidden, count + 1,
                        cost_multiplier=cost.cost_multiplier)


def target_density_infidelity_time(cost):
    """A port ``TargetDensityInfidelityTime`` with the same targets,
    evaluation count and multiplier."""
    return TargetDensityInfidelityTime(
        int(cost.cost_eval_count) + 1,
        _undagger(cost.target_densities_dagger),
        cost_multiplier=cost.cost_multiplier)


def forbid_densities(cost):
    """A port ``ForbidDensities`` with the same (possibly ragged) forbidden
    densities per evolving density, evaluation count and multiplier."""
    forbidden = [_undagger(f) for f in cost.forbidden_densities_dagger]
    count = int(cost.cost_normalization_constant) // len(forbidden)
    return ForbidDensities(forbidden, count + 1,
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
