"""State-vector cost functions.

Counterpart of ``qoc_tpu/costs/state_costs.py`` (``TargetStateInfidelity``;
the step costs ``TargetStateInfidelityTime`` and ``ForbidStates`` ride the
per-step-seed chain kernels of ROADMAP slice 2). Same formulas and
normalization as reference qoc/standard/costs/targetstateinfidelity.py.
"""

import numpy as np
import torch

from qoc_tpu_torch.models.cost import Cost

__all__ = ["TargetStateInfidelity"]


def _pop_phase_kwarg(kwargs):
    """Accept both the correct spelling and the reference's public (typo'd)
    keyword ``neglect_relative_pahse`` (targetstateinfidelity.py:27)."""
    if "neglect_relative_pahse" in kwargs:
        return kwargs.pop("neglect_relative_pahse")
    return kwargs.pop("neglect_relative_phase", False)


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
        # Device copies of the targets, made once per (device, dtype): a
        # host-to-device copy inside the iteration would wait for the device.
        self._dagger = {}

    def _dagger_like(self, states):
        key = (states.device, states.dtype)
        if key not in self._dagger:
            self._dagger[key] = torch.as_tensor(
                self.target_states_dagger, dtype=states.dtype,
                device=states.device)
        return self._dagger[key]

    def cost(self, controls, states, system_eval_step):
        # <t_k|psi_k> for each k: (K, 1, d) x (K, d, 1) -> (K,).
        inner_products = torch.matmul(self._dagger_like(states),
                                      states)[:, 0, 0]
        if not self.neglect_relative_phase:
            inner_products_sum = torch.sum(inner_products)
            fidelity = (torch.real(inner_products_sum
                                   * torch.conj(inner_products_sum))
                        / self.state_count ** 2)
        else:
            fidelities = torch.real(inner_products
                                    * torch.conj(inner_products))
            fidelity = torch.sum(fidelities) / self.state_count
        return (1 - fidelity) * self.cost_multiplier
