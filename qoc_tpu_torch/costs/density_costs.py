"""Density-matrix cost functions.

Counterpart of ``qoc_tpu/costs/density_costs.py``: ``TargetDensityInfidelity``
at the final step, and the step costs ``TargetDensityInfidelityTime`` and
``ForbidDensities`` (evaluated under ``torch.func.vmap`` over a block's
steps, as the state step costs are). Same formulas and normalization as
reference qoc/standard/costs/{targetdensityinfidelity,
targetdensityinfidelitytime,forbiddensities}.py, with the traces batched.

As in ``qoc_tpu`` (its documented fix of the reference),
``TargetDensityInfidelityTime.requires_step_evaluation`` is True: the
reference sets it False (targetdensityinfidelitytime.py:30), against its
own docstring.
"""

import numpy as np
import torch

from qoc_tpu_torch.models.cost import Cost, DeviceCopies

__all__ = ["ForbidDensities", "TargetDensityInfidelity",
           "TargetDensityInfidelityTime"]


def _density_infidelity(target_densities_dagger, densities, hilbert_size):
    """1 - Σ_k |Tr(rho_target_k^H rho_k)| / (K d)."""
    prods = torch.matmul(target_densities_dagger, densities)
    fidelities = torch.abs(torch.diagonal(prods, dim1=-2, dim2=-1).sum(-1))
    return 1 - (torch.sum(fidelities)
                / (target_densities_dagger.shape[0] * hilbert_size))


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
        self._dagger = DeviceCopies([self.target_densities_dagger])

    def cost(self, controls, densities, system_eval_step):
        dagger, = self._dagger.like(densities)
        return (_density_infidelity(dagger, densities, self.hilbert_size)
                * self.cost_multiplier)


class TargetDensityInfidelityTime(Cost):
    """The target-density infidelity at every cost step, normalized by the
    cost evaluation count (reference targetdensityinfidelitytime.py:13-76;
    ``requires_step_evaluation`` True as in ``qoc_tpu``, module
    docstring)."""
    name = "target_density_infidelity_time"
    requires_step_evaluation = True

    def __init__(self, system_eval_count, target_densities, cost_eval_step=1,
                 cost_multiplier=1.0):
        super().__init__(cost_multiplier=cost_multiplier)
        self.cost_eval_count = (system_eval_count - 1) // cost_eval_step
        target_densities = np.asarray(target_densities).astype(np.complex128)
        self.density_count = target_densities.shape[0]
        self.hilbert_size = target_densities.shape[1]
        self.target_densities_dagger = np.conjugate(
            np.swapaxes(target_densities, -1, -2))
        self._dagger = DeviceCopies([self.target_densities_dagger])

    def cost(self, controls, densities, system_eval_step):
        dagger, = self._dagger.like(densities)
        infidelity = _density_infidelity(dagger, densities, self.hilbert_size)
        return (infidelity / self.cost_eval_count) * self.cost_multiplier


class ForbidDensities(Cost):
    """Penalize overlap with forbidden densities at every cost step.

    For density k with forbidden set {F_kj}: mean_j |Tr(F_kj^H rho_k)/d|^2,
    summed over k, normalized by cost_eval_count * density_count
    (reference forbiddensities.py:12-85). Takes a uniform array
    (K, F, d, d) or a ragged list of per-density arrays (F_k, d, d).
    """
    name = "forbid_densities"
    requires_step_evaluation = True

    def __init__(self, forbidden_densities, system_eval_count,
                 cost_eval_step=1, cost_multiplier=1.0):
        super().__init__(cost_multiplier=cost_multiplier)
        if isinstance(forbidden_densities, (list, tuple)):
            per_density = [np.asarray(f).astype(np.complex128)
                           for f in forbidden_densities]
        else:
            per_density = list(np.asarray(forbidden_densities).astype(
                np.complex128))
        self.hilbert_size = per_density[0].shape[-1]
        cost_evaluation_count = (system_eval_count - 1) // cost_eval_step
        self.cost_normalization_constant = (cost_evaluation_count
                                            * len(per_density))
        self.forbidden_densities_count = [f.shape[0] for f in per_density]
        self.forbidden_densities_dagger = [
            np.conjugate(np.swapaxes(f, -1, -2)) for f in per_density]
        self._dagger = DeviceCopies(self.forbidden_densities_dagger)

    def cost(self, controls, densities, system_eval_step):
        total = 0.0
        for i, (forbidden_dagger, count) in enumerate(zip(
                self._dagger.like(densities),
                self.forbidden_densities_count)):
            # (F, d, d) x (d, d) -> (F, d, d), trace -> (F,)
            inner_products = (torch.diagonal(
                torch.matmul(forbidden_dagger, densities[i]), dim1=-2,
                dim2=-1).sum(-1) / self.hilbert_size)
            fidelities = torch.real(inner_products
                                    * torch.conj(inner_products))
            total = total + torch.sum(fidelities) / count
        cost_normalized = total / self.cost_normalization_constant
        return cost_normalized * self.cost_multiplier
