"""Stochastic gradient descent, on device and on the host loop.

Counterpart of ``qoc_tpu/optim/sgd.py`` (reference
qoc/standard/optimizers/sgd.py:7-59): params <- params - learning_rate *
grads, in the port's optimizer interface (``optim/adam.py``): an empty
state dict threaded through the GRAPE loop, and the per-candidate form
for the multistart (``qoc_tpu``'s ``jax.vmap(optimizer.update_jax)``),
and the host twin (``run``/``update_np``, ``qoc_tpu``'s ``run``/``update``)
for the host loop.
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

    def update(self, state, grads, params, f0=None, loss_fn=None):
        """One step: returns (state, new params). ``f0`` and ``loss_fn``, a
        line search's inputs (see LBFGS.update), are unused."""
        return state, params - self.learning_rate * grads

    def init_state_batch(self, params):
        """The per-candidate state of params (N, n): none."""
        return {}

    def update_batch(self, state, grads, params, frozen, f0=None,
                     batch_loss=None):
        """One step of every candidate: returns (state, new params), where a
        ``frozen`` candidate (a bool (N,)) keeps its parameters. ``f0`` and
        ``batch_loss`` are unused."""
        new_params = params - self.learning_rate * grads
        return state, torch.where(frozen[:, None], params, new_params)

    def run(self, function, iteration_count, initial_params, jacobian,
            args=()):
        """Minimize on the host loop; ``jacobian`` returns (grads,
        terminate), and a terminating evaluation skips its update."""
        params = initial_params
        for _ in range(iteration_count):
            grads, terminate = jacobian(params, *args)
            if terminate:
                break
            params = self.update_np(grads, params)

    def update_np(self, grads, params):
        """One step on numpy arrays."""
        return params - self.learning_rate * grads

    def state_dict(self):
        """SGD keeps no state."""
        return {}

    def load_state_dict(self, state):
        pass
