"""State-vector cost functions.

Counterpart of ``qoc_tpu/costs/state_costs.py``: ``TargetStateInfidelity``
at the final step, and the step costs ``TargetStateInfidelityTime`` and
``ForbidStates``, evaluated at every cost step (``requires_step_evaluation``)
under ``torch.func.vmap`` over a block's steps, so they call no ``.item()``
and no numpy on tensors. Same formulas and normalization as reference
qoc/standard/costs/{targetstateinfidelity,targetstateinfidelitytime,
forbidstates}.py.
"""

import numpy as np
import torch

from qoc_tpu_torch.models.cost import Cost, DeviceCopies

__all__ = ["ForbidStates", "TargetStateInfidelity",
           "TargetStateInfidelityTime"]


def _pop_phase_kwarg(kwargs):
    """Accept both the correct spelling and the reference's public (typo'd)
    keyword ``neglect_relative_pahse`` (targetstateinfidelity.py:27)."""
    if "neglect_relative_pahse" in kwargs:
        return kwargs.pop("neglect_relative_pahse")
    return kwargs.pop("neglect_relative_phase", False)


def _state_infidelity(target_states_dagger, states, neglect_relative_phase):
    """1 - |Σ_k <t_k|psi_k>|^2 / K^2, or 1 - Σ_k |<t_k|psi_k>|^2 / K."""
    # <t_k|psi_k> for each k: (K, 1, d) x (K, d, 1) -> (K,).
    inner_products = torch.matmul(target_states_dagger, states)[:, 0, 0]
    state_count = target_states_dagger.shape[0]
    if not neglect_relative_phase:
        inner_products_sum = torch.sum(inner_products)
        fidelity = (torch.real(inner_products_sum
                               * torch.conj(inner_products_sum))
                    / state_count ** 2)
    else:
        fidelities = torch.real(inner_products * torch.conj(inner_products))
        fidelity = torch.sum(fidelities) / state_count
    return 1 - fidelity


class TargetStateInfidelity(Cost):
    """Infidelity of the evolved states w.r.t. target states at the final
    step.

    Default: coherent sum 1 - |sum_k <t_k|psi_k>|^2 / K^2
    (reference targetstateinfidelity.py:53-56); with
    ``neglect_relative_phase=True``: incoherent 1 - sum_k |<t_k|psi_k>|^2 / K
    (reference :58-61).
    """
    name = "target_state_infidelity"
    requires_step_evaluation = False

    def __init__(self, target_states, cost_multiplier=1.0, **kwargs):
        neglect_relative_phase = _pop_phase_kwarg(kwargs)
        if kwargs:
            raise TypeError("Unexpected kwargs: {}".format(sorted(kwargs)))
        super().__init__(cost_multiplier=cost_multiplier)
        target_states = np.asarray(target_states).astype(np.complex128)
        self.state_count = target_states.shape[0]
        self.target_states_dagger = np.conjugate(
            np.swapaxes(target_states, -1, -2))
        self.neglect_relative_phase = neglect_relative_phase
        self._dagger = DeviceCopies([self.target_states_dagger])

    def cost(self, controls, states, system_eval_step):
        dagger, = self._dagger.like(states)
        return (_state_infidelity(dagger, states, self.neglect_relative_phase)
                * self.cost_multiplier)


class TargetStateInfidelityTime(Cost):
    """The same infidelity at every cost step, each normalized by the number
    of cost evaluations, (system_eval_count - 1) // cost_eval_step
    (reference targetstateinfidelitytime.py:13-73)."""
    name = "target_state_infidelity_time"
    requires_step_evaluation = True

    def __init__(self, system_eval_count, target_states, cost_eval_step=1,
                 cost_multiplier=1.0, **kwargs):
        neglect_relative_phase = _pop_phase_kwarg(kwargs)
        if kwargs:
            raise TypeError("Unexpected kwargs: {}".format(sorted(kwargs)))
        super().__init__(cost_multiplier=cost_multiplier)
        self.cost_eval_count = (system_eval_count - 1) // cost_eval_step
        target_states = np.asarray(target_states).astype(np.complex128)
        self.state_count = target_states.shape[0]
        self.target_states_dagger = np.conjugate(
            np.swapaxes(target_states, -1, -2))
        self.neglect_relative_phase = neglect_relative_phase
        self._dagger = DeviceCopies([self.target_states_dagger])

    def cost(self, controls, states, system_eval_step):
        dagger, = self._dagger.like(states)
        infidelity = _state_infidelity(dagger, states,
                                       self.neglect_relative_phase)
        return (infidelity / self.cost_eval_count) * self.cost_multiplier


class ForbidStates(Cost):
    """Penalize occupation of forbidden states at every cost step.

    For evolving state k with forbidden set {f_kj}: mean_j |<f_kj|psi_k>|^2,
    summed over k, normalized by cost_eval_count * state_count
    (reference forbidstates.py:12-81). ``forbidden_states`` is a uniform
    array (K, F, d, 1) or a ragged list/tuple of per-state arrays
    (F_k, d, 1).
    """
    name = "forbid_states"
    requires_step_evaluation = True

    def __init__(self, forbidden_states, system_eval_count, cost_eval_step=1,
                 cost_multiplier=1.0):
        super().__init__(cost_multiplier=cost_multiplier)
        if isinstance(forbidden_states, (list, tuple)):
            per_state = [np.asarray(f).astype(np.complex128)
                         for f in forbidden_states]
        else:
            forbidden_states = np.asarray(forbidden_states).astype(
                np.complex128)
            per_state = list(forbidden_states)
        cost_evaluation_count = (system_eval_count - 1) // cost_eval_step
        self.cost_normalization_constant = (cost_evaluation_count
                                            * len(per_state))
        self.forbidden_states_count = [f.shape[0] for f in per_state]
        self.forbidden_states_dagger = [
            np.conjugate(np.swapaxes(f, -1, -2)) for f in per_state]
        self._dagger = DeviceCopies(self.forbidden_states_dagger)

    def cost(self, controls, states, system_eval_step):
        total = 0.0
        for i, (forbidden_dagger, count) in enumerate(zip(
                self._dagger.like(states), self.forbidden_states_count)):
            # (F, 1, d) x (d, 1) -> (F, 1, 1) -> (F,)
            inner_products = torch.matmul(forbidden_dagger,
                                          states[i])[:, 0, 0]
            fidelities = torch.real(inner_products
                                    * torch.conj(inner_products))
            total = total + torch.sum(fidelities) / count
        cost_normalized = total / self.cost_normalization_constant
        return cost_normalized * self.cost_multiplier
