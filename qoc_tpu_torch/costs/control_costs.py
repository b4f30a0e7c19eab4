"""Control-regularization cost functions.

Counterpart of ``qoc_tpu/costs/control_costs.py`` (reference
qoc/standard/costs/{controlnorm,controlarea,controlvariation,
controlbandwidthmax}.py): the same formulas and normalization, with two of
``qoc_tpu``'s fixes of reference defects: ``ControlArea`` does not crash
when ``max_control_norms`` is None (the reference's ``normalized_control``
NameError, controlarea.py:58), and a ``ControlBandwidthMax`` channel whose
bound is at or above the Nyquist frequency has an empty penalty set and
costs nothing (the reference crashes on the empty reduction).

They are final costs (``requires_step_evaluation`` False) of the controls
alone. The ensemble and multistart losses evaluate them under
``torch.func.vmap`` over the chains (``parallel/ensemble.py``), so they
call no ``.item()`` and branch on no value of a tensor; their constants
(norms, weights, the penalty masks) are device copies made once
(``DeviceCopies``).
"""

import numpy as np
import torch

from qoc_tpu_torch.models.cost import Cost, DeviceCopies

__all__ = ["ControlArea", "ControlBandwidthMax", "ControlNorm",
           "ControlVariation"]


def _normalized(controls, norms):
    """The controls over their channels' maximum norms (a DeviceCopies of
    one array, or None)."""
    if norms is None:
        return controls
    return controls / norms.like(controls.real)[0]


class ControlNorm(Cost):
    """Mean squared modulus of the (optionally normalized, weighted)
    controls (reference controlnorm.py:11-73)."""
    name = "control_norm"
    requires_step_evaluation = False

    def __init__(self, control_count, control_eval_count,
                 control_weights=None, cost_multiplier=1.0,
                 max_control_norms=None):
        super().__init__(cost_multiplier=cost_multiplier)
        self.control_weights = (np.asarray(control_weights)
                                if control_weights is not None else None)
        self.controls_size = control_eval_count * control_count
        self.max_control_norms = (np.asarray(max_control_norms)
                                  if max_control_norms is not None else None)
        self._norms = (DeviceCopies([self.max_control_norms])
                       if self.max_control_norms is not None else None)
        self._weights = (DeviceCopies([self.control_weights])
                         if self.control_weights is not None else None)

    def cost(self, controls, states, system_eval_step):
        controls = _normalized(controls, self._norms)
        if self._weights is not None:
            controls = controls * self._weights.like(controls.real)[0]
        total = torch.sum(torch.real(controls * torch.conj(controls)))
        return (total / self.controls_size) * self.cost_multiplier


class ControlArea(Cost):
    """Modulus of the discrete integral of each control channel
    (reference controlarea.py:11-67, with its NameError fixed)."""
    name = "control_area"
    requires_step_evaluation = False

    def __init__(self, control_count, control_eval_count,
                 cost_multiplier=1.0, max_control_norms=None):
        super().__init__(cost_multiplier=cost_multiplier)
        self.control_count = control_count
        self.control_size = control_count * control_eval_count
        self.max_control_norms = (np.asarray(max_control_norms)
                                  if max_control_norms is not None else None)
        self._norms = (DeviceCopies([self.max_control_norms])
                       if self.max_control_norms is not None else None)

    def cost(self, controls, states, system_eval_step):
        normalized_controls = _normalized(controls, self._norms)
        # sum over time per channel, modulus, sum over channels.
        total = torch.sum(torch.abs(torch.sum(normalized_controls, dim=0)))
        return (total / self.control_size) * self.cost_multiplier


class ControlVariation(Cost):
    """Squared modulus of order-n differences of the controls along time
    (reference controlvariation.py:11-75)."""
    name = "control_variation"
    requires_step_evaluation = False

    def __init__(self, control_count, control_eval_count,
                 cost_multiplier=1.0, max_control_norms=None, order=1):
        super().__init__(cost_multiplier=cost_multiplier)
        self.max_control_norms = (np.asarray(max_control_norms)
                                  if max_control_norms is not None else None)
        self.diffs_size = control_count * (control_eval_count - order)
        self.order = order
        # |delta|^2 <= 2^order for unit-modulus-bounded controls (triangle
        # inequality), hence the 2^order normalization.
        self.cost_normalization_constant = self.diffs_size * (2 ** order)
        self._norms = (DeviceCopies([self.max_control_norms])
                       if self.max_control_norms is not None else None)

    def cost(self, controls, states, system_eval_step):
        normalized_controls = _normalized(controls, self._norms)
        diffs = torch.diff(normalized_controls, n=self.order, dim=0)
        total = torch.sum(torch.real(diffs * torch.conj(diffs)))
        return (total / self.cost_normalization_constant
                ) * self.cost_multiplier


class ControlBandwidthMax(Cost):
    """Penalize spectral weight of each control above its maximum bandwidth.

    FFT per channel; the frequencies at or above max_bandwidth (the positive
    side only, the reference's ``freqs >= max_bandwidth``,
    controlbandwidthmax.py:70) are summed and normalized by their count and
    peak (reference :67-75). The penalized index sets are fixed at
    construction (``penalty_indices``, from fftfreq) and enter the cost as
    0/1 masks, so it is a fixed reduction; a channel with an empty set
    costs nothing (module docstring).
    """
    name = "control_bandwidth_max"
    requires_step_evaluation = False

    def __init__(self, control_count, control_eval_count, evolution_time,
                 max_bandwidths, cost_multiplier=1.0):
        super().__init__(cost_multiplier=cost_multiplier)
        self.max_bandwidths = np.asarray(max_bandwidths)
        self.control_count = control_count
        dt = evolution_time / (control_eval_count - 1)
        self.freqs = np.fft.fftfreq(control_eval_count, d=dt)
        self.penalty_indices = [
            np.nonzero(self.freqs >= float(max_bandwidth))[0]
            for max_bandwidth in self.max_bandwidths
        ]
        self._masks = None

    def cost(self, controls, states, system_eval_step):
        if self._masks is None:
            # Built at the first call from ``penalty_indices``, which
            # convert.control_bandwidth_max may have set.
            masks = np.zeros((len(self.freqs), len(self.penalty_indices)))
            for i, indices in enumerate(self.penalty_indices):
                masks[np.asarray(indices, dtype=np.int64), i] = 1
            self._masks = DeviceCopies([masks])
        masks, = self._masks.like(controls.real)
        total = torch.zeros((), dtype=masks.dtype, device=masks.device)
        for i, indices in enumerate(self.penalty_indices):
            if len(indices) == 0:
                # Bound at or above Nyquist: nothing to penalize.
                continue
            penalized = torch.abs(torch.fft.fft(controls[:, i])) * masks[:, i]
            penalty_normalized = torch.sum(penalized) / (
                len(indices) * torch.amax(penalized))
            total = total + penalty_normalized
        return (total / self.control_count) * self.cost_multiplier
