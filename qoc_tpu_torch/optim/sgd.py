"""Stochastic gradient descent, on device.

Counterpart of ``qoc_tpu/optim/sgd.py`` (reference
qoc/standard/optimizers/sgd.py:7-59): params <- params - learning_rate *
grads, in the port's optimizer interface (``optim/adam.py``): an empty
state dict threaded through the GRAPE loop, and the per-candidate form
for the multistart (``qoc_tpu``'s ``jax.vmap(optimizer.update_jax)``).
The reference's host loop (``run``) is ROADMAP slice 3 of the port.
"""

import torch

__all__ = ["SGD"]


class SGD:
    name = "sgd"
    supports_fused = True

    def __init__(self, learning_rate=1e-3):
        self.learning_rate = learning_rate

    def __str__(self):
        return "{}, lr: {}".format(self.name, self.learning_rate)

    def init_state(self, params):
        """SGD keeps no state."""
        return {}

    def update(self, state, grads, params):
        """One step: returns (state, new params)."""
        return state, params - self.learning_rate * grads

    def init_state_batch(self, params):
        """The per-candidate state of params (N, n): none."""
        return {}

    def update_batch(self, state, grads, params, frozen):
        """One step of every candidate: returns (state, new params), where a
        ``frozen`` candidate (a bool (N,)) keeps its parameters."""
        new_params = params - self.learning_rate * grads
        return state, torch.where(frozen[:, None], params, new_params)
