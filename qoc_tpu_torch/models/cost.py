"""Cost function base class.

Counterpart of ``qoc_tpu/models/cost.py`` (reference qoc/models/cost.py:5-51).
Concrete costs are differentiable torch functions of (controls, states,
system_eval_step); the data they need (targets, normalization constants) is
precomputed at construction time so the per-iteration work is device math.
"""

import numpy as np
import torch

__all__ = ["Cost", "DeviceCopies", "validate_cost_dimensions"]


def validate_cost_dimensions(costs, hilbert_dim):
    """Raise a clean ValueError when a cost's stored targets / forbidden
    operators disagree with the problem's Hilbert dimension.

    Without this the mismatch surfaces as an opaque matmul shape error from
    deep inside the propagation loss. Called by the Evolve*/Grape* state
    constructors, so every entry point validates once, up front."""
    for cost in costs:
        d = None
        dagger = getattr(cost, "target_states_dagger", None)
        if dagger is not None:
            d = int(np.asarray(dagger).shape[-1])
        dens = getattr(cost, "target_densities_dagger", None)
        if dens is not None:
            d = int(np.asarray(dens).shape[-1])
        forb = getattr(cost, "forbidden_states_dagger", None)
        if forb is not None and len(forb):
            d = int(np.asarray(forb[0]).shape[-1])
        hilbert = getattr(cost, "hilbert_size", None)
        if hilbert is not None:
            d = int(hilbert)
        if d is not None and d != hilbert_dim:
            raise ValueError(
                "{} was constructed for Hilbert dimension {}, but the "
                "problem's initial states/densities have dimension {}."
                "".format(type(cost).__name__, d, hilbert_dim))


class DeviceCopies:
    """Device copies of a cost's host arrays (targets, forbidden states),
    made once per (device, dtype) of the tensors it is evaluated on: a
    host-to-device copy inside the iteration would wait for the device."""

    def __init__(self, arrays):
        self.arrays = arrays
        self._copies = {}

    def like(self, x):
        """The arrays as tensors on ``x``'s device in ``x``'s dtype."""
        key = (x.device, x.dtype)
        if key not in self._copies:
            self._copies[key] = [torch.as_tensor(a, dtype=x.dtype,
                                                 device=x.device)
                                 for a in self.arrays]
        return self._copies[key]


class Cost:
    """Base class for GRAPE cost functions.

    Fields:
    cost_multiplier :: float - weight of this cost in the total error.
    name :: str - identifier.
    requires_step_evaluation :: bool - True if the cost must be evaluated at
        every cost evaluation step (e.g. occupation penalties), False if only
        at the end of evolution (e.g. target infidelity).
    """
    name = "parent_cost"
    requires_step_evaluation = False

    def __init__(self, cost_multiplier=1.0):
        self.cost_multiplier = cost_multiplier

    def __str__(self):
        return self.name

    def cost(self, controls, states, system_eval_step):
        """Compute the penalty (a real 0-dim tensor, differentiable).

        Arguments:
        controls :: tensor (control_eval_count, control_count) or None.
        states :: tensor - evolving states (K, d, 1).
        system_eval_step :: int - current step index.
        """
        raise NotImplementedError("The cost {} has not implemented "
                                  "an evaluation method.".format(self))
