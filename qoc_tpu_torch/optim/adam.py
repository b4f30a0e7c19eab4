"""Adam optimizer, on device and on the host loop.

Counterpart of ``qoc_tpu/optim/adam.py`` (reference
qoc/standard/optimizers/adam.py:9-165): textbook Adam with bias correction,
plus the reference's extras (exponential learning-rate decay, gradient
norm-rescaling, elementwise gradient clipping). The state is a dict of
tensors that the GRAPE loop threads through its iterations; the update is
the arithmetic of ``qoc_tpu``'s ``Adam.update_jax``, step for step, and
never reads a value back to the host. The per-candidate form
(``init_state_batch``/``update_batch``, ``qoc_tpu``'s
``jax.vmap(optimizer.update_jax)`` in its multistart runner) carries a
leading candidate axis on the state and the parameters. The host twin
(``run``/``update_np``, ``qoc_tpu``'s ``run``/``update``) is the same rule
in numpy, for the host loop that an ``impose_control_conditions`` hook
forces (``core/graperunner.py``); its ``state_dict``/``load_state_dict``
are what that loop checkpoints (``qoc_tpu``'s names).
"""

import numpy as np
import torch

__all__ = ["Adam"]


class Adam:
    name = "adam"
    supports_fused = True

    def __init__(self, beta_1=0.9, beta_2=0.999, clip_grads=None,
                 epsilon=1e-8, learning_rate=1e-3, learning_rate_decay=None,
                 operation_policy=None, scale_grads=None):
        self.apply_scale_grads = scale_grads is not None
        self.apply_clip_grads = clip_grads is not None
        self.apply_learning_rate_decay = learning_rate_decay is not None
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.clip_grads = clip_grads
        self.epsilon = epsilon
        self.gradient_moment = None
        self.gradient_square_moment = None
        self.initial_learning_rate = learning_rate
        self.iteration_count = 0
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.scale_grads = scale_grads

    def __str__(self):
        return ("{}, beta_1: {}, beta_2: {}, epsilon: {}, lr0: {}, "
                "lr_decay: {}, clip_grads: {}, scale_grads: {}"
                "".format(self.name, self.beta_1, self.beta_2, self.epsilon,
                          self.initial_learning_rate,
                          self.learning_rate_decay, self.clip_grads,
                          self.scale_grads))

    def init_state(self, params):
        """Optimizer state: first and second moments and the step count
        (int32 on the params' device)."""
        return {
            "m": torch.zeros_like(params),
            "v": torch.zeros_like(params),
            "t": torch.zeros((), dtype=torch.int32, device=params.device),
        }

    def update(self, state, grads, params, f0=None, loss_fn=None):
        """One Adam step: returns (new state, new params). ``f0`` and
        ``loss_fn``, a line search's inputs (see LBFGS.update), are
        unused."""
        t = state["t"]
        if self.apply_learning_rate_decay:
            learning_rate = (self.initial_learning_rate
                             * torch.exp(-t.to(grads.dtype)
                                         / self.learning_rate_decay))
        else:
            learning_rate = self.initial_learning_rate
        if self.apply_scale_grads:
            grads = (grads / torch.linalg.vector_norm(grads)) \
                * self.scale_grads
        if self.apply_clip_grads:
            grads = torch.clamp(grads, -self.clip_grads, self.clip_grads)

        t = t + 1
        b1, b2 = self.beta_1, self.beta_2
        tf = t.to(grads.dtype)
        m = b1 * state["m"] + (1 - b1) * grads
        v = b2 * state["v"] + (1 - b2) * torch.square(grads)
        m_hat = m / (1 - b1 ** tf)
        v_hat = v / (1 - b2 ** tf)
        params = params - learning_rate * m_hat / (torch.sqrt(v_hat)
                                                   + self.epsilon)
        return {"m": m, "v": v, "t": t}, params

    def init_state_batch(self, params):
        """Per-candidate state for params (N, n): moments (N, n) and a step
        count per candidate (N,)."""
        return torch.func.vmap(self.init_state)(params)

    def update_batch(self, state, grads, params, frozen, f0=None,
                     batch_loss=None):
        """One Adam step of every candidate, each with its own step count
        (:meth:`update` under ``torch.func.vmap``): returns (new state, new
        params), where a ``frozen`` candidate (a bool (N,)) keeps its
        parameters and its state. ``f0`` and ``batch_loss`` are unused."""
        new_state, new_params = torch.func.vmap(self.update)(state, grads,
                                                             params)

        def keep(new, old):
            return torch.where(
                frozen.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)

        return ({key: keep(new_state[key], state[key]) for key in state},
                keep(new_params, params))

    # -- host twin -----------------------------------------------------------

    def run(self, function, iteration_count, initial_params, jacobian,
            args=()):
        """Minimize on the host loop; ``jacobian`` returns (grads,
        terminate), and a terminating evaluation skips its update. When
        ``_warm_start`` is set (by the resume after ``load_state_dict``),
        the moments and step count carried over are kept; the flag is
        consumed."""
        if getattr(self, "_warm_start", False):
            self._warm_start = False
        else:
            self.iteration_count = 0
            self.gradient_moment = np.zeros_like(initial_params)
            self.gradient_square_moment = np.zeros_like(initial_params)
        params = initial_params
        for _ in range(iteration_count):
            grads, terminate = jacobian(params, *args)
            if terminate:
                break
            params = self.update_np(grads, params)

    def update_np(self, grads, params):
        """One Adam step on numpy arrays (reference adam.py:110-165)."""
        if self.apply_learning_rate_decay:
            learning_rate = (self.initial_learning_rate
                             * np.exp(-self.iteration_count
                                      / self.learning_rate_decay))
        else:
            learning_rate = self.initial_learning_rate
        if self.apply_scale_grads:
            grads = (grads / np.linalg.norm(grads)) * self.scale_grads
        if self.apply_clip_grads:
            grads = np.clip(grads, -self.clip_grads, self.clip_grads)

        self.iteration_count += 1
        t = self.iteration_count
        b1, b2 = self.beta_1, self.beta_2
        self.gradient_moment = b1 * self.gradient_moment + (1 - b1) * grads
        self.gradient_square_moment = (b2 * self.gradient_square_moment
                                       + (1 - b2) * np.square(grads))
        m_hat = self.gradient_moment / (1 - b1 ** t)
        v_hat = self.gradient_square_moment / (1 - b2 ** t)
        return params - learning_rate * m_hat / (np.sqrt(v_hat)
                                                 + self.epsilon)

    # -- checkpoint support ------------------------------------------------

    def state_dict(self):
        """The host twin's state (``qoc_tpu``'s keys)."""
        return {
            "gradient_moment": self.gradient_moment,
            "gradient_square_moment": self.gradient_square_moment,
            "iteration_count": np.asarray(self.iteration_count),
        }

    def load_state_dict(self, state):
        self.gradient_moment = np.asarray(state["gradient_moment"])
        self.gradient_square_moment = np.asarray(
            state["gradient_square_moment"])
        self.iteration_count = int(state["iteration_count"])
