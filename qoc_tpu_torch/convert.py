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

from qoc_tpu_torch.costs import (ControlArea, ControlBandwidthMax,
                                 ControlNorm, ControlVariation,
                                 ForbidDensities, ForbidStates,
                                 TargetDensityInfidelity,
                                 TargetDensityInfidelityTime,
                                 TargetStateInfidelity,
                                 TargetStateInfidelityTime)
from qoc_tpu_torch.models import (ConstantLindblad,
                                  EnsembleLinearHamiltonian,
                                  LinearHamiltonian)

__all__ = ["adam_state", "constant_lindblad", "control_area",
           "control_bandwidth_max", "control_norm", "control_variation",
           "controls", "densities",
           "forbid_densities", "forbid_states", "linear_hamiltonian",
           "max_control_norms", "states", "target_density_infidelity",
           "target_density_infidelity_time", "target_state_infidelity",
           "target_state_infidelity_time"]


def linear_hamiltonian(hamiltonian):
    """A port ``LinearHamiltonian`` with the same ``h0`` and ``operators``;
    for an ensemble (``qoc_tpu``'s ``EnsembleLinearHamiltonian``, known by
    its ``param_operators``) the port's ``EnsembleLinearHamiltonian`` with
    the same ``param_operators`` too."""
    h0 = np.asarray(hamiltonian.h0, dtype=np.complex128)
    operators = np.asarray(hamiltonian.operators, dtype=np.complex128)
    if hasattr(hamiltonian, "param_operators"):
        return EnsembleLinearHamiltonian(
            h0, operators, np.asarray(hamiltonian.param_operators,
                                      dtype=np.complex128))
    return LinearHamiltonian(h0, operators)


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


# The control costs keep their sizes as products (E C, C (E - order)), and
# the port's constructors form the same products from control_count = 1.


def _optional(array):
    return None if array is None else np.asarray(array, dtype=np.float64)


def control_norm(cost):
    """A port ``ControlNorm`` with the same weights, norms, size and
    multiplier."""
    return ControlNorm(1, int(cost.controls_size),
                       control_weights=_optional(cost.control_weights),
                       cost_multiplier=cost.cost_multiplier,
                       max_control_norms=_optional(cost.max_control_norms))


def control_area(cost):
    """A port ``ControlArea`` with the same channels, norms, size and
    multiplier."""
    return ControlArea(int(cost.control_count),
                       int(cost.control_size) // int(cost.control_count),
                       cost_multiplier=cost.cost_multiplier,
                       max_control_norms=_optional(cost.max_control_norms))


def control_variation(cost):
    """A port ``ControlVariation`` with the same order, norms, size and
    multiplier."""
    return ControlVariation(1, int(cost.diffs_size) + int(cost.order),
                            cost_multiplier=cost.cost_multiplier,
                            max_control_norms=_optional(
                                cost.max_control_norms),
                            order=int(cost.order))


def control_bandwidth_max(cost):
    """A port ``ControlBandwidthMax`` with the same bounds, frequencies,
    penalty sets and multiplier (the sets copied, not recomputed, so that a
    bound on a grid frequency falls on the same side)."""
    freqs = np.asarray(cost.freqs)
    port = ControlBandwidthMax(int(cost.control_count), len(freqs), 1.0,
                               cost.max_bandwidths,
                               cost_multiplier=cost.cost_multiplier)
    port.freqs = freqs
    port.penalty_indices = [np.asarray(i) for i in cost.penalty_indices]
    return port


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
