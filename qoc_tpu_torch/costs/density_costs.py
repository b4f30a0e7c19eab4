"""Density-matrix cost functions.

Counterpart of ``qoc_tpu/costs/density_costs.py``
(``TargetDensityInfidelity``; the step costs ``TargetDensityInfidelityTime``
and ``ForbidDensities`` ride the per-step-seed chain kernels of a later
slice). Same formula and normalization as reference
qoc/standard/costs/targetdensityinfidelity.py, with the traces batched.
"""

import numpy as np
import torch

from qoc_tpu_torch.models.cost import Cost

__all__ = ["TargetDensityInfidelity"]


class TargetDensityInfidelity(Cost):
    """1 - sum_k |Tr(rho_target_k^H rho_k)| / (K * d) at the final step
    (Frobenius inner product; reference targetdensityinfidelity.py:12-69)."""
    name = "target_density_infidelity"
    requires_step_evaluation = False

    def __init__(self, target_densities, cost_multiplier=1.0):
        super().__init__(cost_multiplier=cost_multiplier)
        target_densities = np.asarray(target_densities).astype(np.complex128)
        self.density_count = target_densities.shape[0]
        self.hilbert_size = target_densities.shape[1]
        self.target_densities_dagger = np.conjugate(
            np.swapaxes(target_densities, -1, -2))
        # Device copies of the targets, made once per (device, dtype).
        self._dagger = {}

    def _dagger_like(self, densities):
        key = (densities.device, densities.dtype)
        if key not in self._dagger:
            self._dagger[key] = torch.as_tensor(
                self.target_densities_dagger, dtype=densities.dtype,
                device=densities.device)
        return self._dagger[key]

    def cost(self, controls, densities, system_eval_step):
        prods = torch.matmul(self._dagger_like(densities), densities)
        fidelities = torch.abs(torch.diagonal(prods, dim1=-2,
                                              dim2=-1).sum(-1))
        fidelity_normalized = (torch.sum(fidelities)
                               / (self.density_count * self.hilbert_size))
        return (1 - fidelity_normalized) * self.cost_multiplier
