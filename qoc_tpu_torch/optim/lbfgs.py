"""Limited-memory BFGS with a fixed line-search ladder, on device.

Counterpart of ``qoc_tpu/optim/lbfgs.py`` (a ``qoc_tpu`` extension: the
reference offers quasi-Newton optimization only through scipy's L-BFGS-B,
``optim/lbfgsb.py`` here). The arithmetic is ``qoc_tpu``'s step for step:

- the **two-loop recursion** over a ``history``-slot ring of curvature
  pairs, newest first; empty slots (rho = 0) add nothing, and an ascent
  direction falls back to scaled steepest descent;
- a **fixed Armijo ladder** in place of data-dependent backtracking:
  ``ls_steps`` forward losses at ``initial_step * backtrack**k`` and one
  probe at ``_fd_eps`` that measures the slope along the projected path
  (the GRAPE clip is a projection outside the gradient, so g.d is not the
  directional derivative on the norm boundary). The first Armijo-feasible
  rung is taken, else the best improving rung, else no step;
- curvature pairs inserted **delayed by one**: the update at x_k, given
  g(x_k), forms (x_k - x_{k-1}, g_k - g_{k-1}) from the previous call's
  iterate kept in the state, and skips a pair that fails
  s.y > 1e-10 |s| |y|.

The device form (``init_state``/``update``, the batched
``init_state_batch``/``update_batch`` of the multistart) keeps its state
as a dict of tensors, picks the ring's slots by gathers and the step by
``argmax``/``torch.where``, and reads nothing back to the host: the
ladder's ``ls_steps`` + 1 losses run one after the other under
``torch.no_grad()``, so on the fused route each is one forward kernel
launch. The functions are written on leading batch axes, so one code path
serves one run (params (n,)) and a candidate batch (params (N, n)).

The host twin (``run``) is the same algorithm in float64 numpy with
sequential backtracking, for the host loop that an
``impose_control_conditions`` hook forces (``core/graperunner.py``).
"""

import numpy as np
import torch

__all__ = ["LBFGS"]


class LBFGS:
    name = "lbfgs"
    supports_fused = True
    # The GRAPE loops pass a clip-projected loss for the line search.
    needs_loss = True

    def __init__(self, history=8, ls_steps=6, initial_step=1.0,
                 backtrack=0.5, c1=1e-4, operation_policy=None):
        """history - curvature pairs kept.
        ls_steps - the line-search ladder's length; rung k tries
            ``initial_step * backtrack**k``, one forward loss each.
        c1 - Armijo's sufficient-decrease constant."""
        if history < 1:
            raise ValueError("history must be >= 1")
        if ls_steps < 1:
            raise ValueError("ls_steps must be >= 1")
        self.history = int(history)
        self.ls_steps = int(ls_steps)
        self.initial_step = float(initial_step)
        self.backtrack = float(backtrack)
        self.c1 = float(c1)
        self._host = None

    def __str__(self):
        return ("{}, history: {}, ls_steps: {}, initial_step: {}, "
                "backtrack: {}, c1: {}".format(
                    self.name, self.history, self.ls_steps,
                    self.initial_step, self.backtrack, self.c1))

    def _alphas(self, dtype):
        return (self.initial_step
                * self.backtrack ** np.arange(self.ls_steps)).astype(dtype)

    def _fd_eps(self, dtype):
        """The slope probe's offset: a hundredth of the smallest rung, so
        that the probe is a local slope and float32 loss rounding (about
        1e-7) stays near 1e-3 of a typical slope."""
        return np.asarray(0.01 * self.initial_step
                          * self.backtrack ** (self.ls_steps - 1),
                          dtype=dtype)

    # -- device form ---------------------------------------------------------

    def init_state(self, params):
        """The empty ring for params (..., n): s and y (..., history, n),
        rho (..., history), gamma, the previous iterate and gradient, and
        the int32 cursor t (the pairs inserted so far)."""
        lead, n, m = params.shape[:-1], params.shape[-1], self.history

        def zeros(*shape, dtype=params.dtype):
            return torch.zeros(lead + shape, dtype=dtype,
                               device=params.device)

        return {"s": zeros(m, n), "y": zeros(m, n), "rho": zeros(m),
                "gamma": zeros(), "prev_params": zeros(n),
                "prev_grads": zeros(n), "have_prev": zeros(),
                "t": zeros(dtype=torch.int32)}

    def init_state_batch(self, params):
        """Per-candidate state for params (N, n)."""
        return self.init_state(params)

    def _direction(self, state, grads):
        """Two-loop recursion: (d = -H g, g.d) with the implicit inverse
        Hessian, newest pair first; empty slots contribute nothing."""
        m = self.history
        order = torch.remainder(
            state["t"].to(torch.int64)[..., None] - 1
            - torch.arange(m, device=grads.device), m)
        s_ring = torch.take_along_dim(state["s"], order[..., None], dim=-2)
        y_ring = torch.take_along_dim(state["y"], order[..., None], dim=-2)
        rho_ring = torch.take_along_dim(state["rho"], order, dim=-1)
        zero = torch.zeros((), dtype=grads.dtype, device=grads.device)
        q = grads
        alphas = []
        for j in range(m):
            rho_j = rho_ring[..., j]
            a = rho_j * _dot(s_ring[..., j, :], q)
            q = q - torch.where(rho_j > 0, a, zero)[..., None] \
                * y_ring[..., j, :]
            alphas.append(a)
        gnorm = torch.linalg.vector_norm(grads, dim=-1)
        gamma = torch.where(state["gamma"] > 0, state["gamma"],
                            1.0 / torch.clamp(gnorm, min=1.0))
        r = gamma[..., None] * q
        for j in reversed(range(m)):
            rho_j = rho_ring[..., j]
            b = rho_j * _dot(y_ring[..., j, :], r)
            r = r + torch.where(rho_j > 0, alphas[j] - b, zero)[..., None] \
                * s_ring[..., j, :]
        d = -r
        gtd = _dot(grads, d)
        # Descent safeguard: a stale or indefinite history can point uphill.
        bad = gtd >= 0
        d = torch.where(bad[..., None], -gamma[..., None] * grads, d)
        gtd = torch.where(bad, -gamma * gnorm * gnorm, gtd)
        return d, gtd

    def _select_step(self, f0, gtd, losses):
        """losses (..., ls_steps) on the descending ladder: the first
        Armijo-feasible rung's step, else the best improving rung's, else
        0."""
        alphas = torch.as_tensor(self._alphas(_np_dtype(losses)),
                                 device=losses.device)
        armijo = losses <= f0[..., None] + self.c1 * alphas * gtd[..., None]
        first_ok = torch.argmax(armijo.to(losses.dtype), dim=-1)
        any_ok = torch.any(armijo, dim=-1)
        best_k = torch.argmin(losses, dim=-1)
        improves = torch.take_along_dim(
            losses, best_k[..., None], dim=-1)[..., 0] < f0
        k = torch.where(any_ok, first_ok, best_k)
        return torch.where(any_ok | improves, torch.take(alphas, k),
                           torch.zeros_like(f0))

    def _advance(self, state, params, grads):
        """Insert the delayed curvature pair and keep the current iterate
        for the next call."""
        m = self.history
        s = params - state["prev_params"]
        y = grads - state["prev_grads"]
        sy, ss, yy = _dot(s, y), _dot(s, s), _dot(y, y)
        good = ((state["have_prev"] > 0.5)
                & (sy > 1e-10 * torch.sqrt(ss * yy) + 1e-30))
        slot = good[..., None] & (
            torch.arange(m, device=params.device)
            == torch.remainder(state["t"], m)[..., None])
        zero = torch.zeros((), dtype=params.dtype, device=params.device)
        rho_val = torch.where(good, 1.0 / torch.clamp(sy, min=1e-30), zero)
        return {
            "s": torch.where(slot[..., None], s[..., None, :], state["s"]),
            "y": torch.where(slot[..., None], y[..., None, :], state["y"]),
            "rho": torch.where(slot, rho_val[..., None], state["rho"]),
            "gamma": torch.where(good, sy / torch.clamp(yy, min=1e-30),
                                 state["gamma"]),
            "prev_params": params, "prev_grads": grads,
            "have_prev": torch.ones_like(state["have_prev"]),
            "t": state["t"] + good.to(torch.int32),
        }

    def _ladder(self, params, d, f0, loss):
        """The step of each run along d: the slope probe and the ladder's
        forward losses through ``loss`` (params (..., n) -> losses (...)),
        one after the other, without a graph."""
        np_dtype = _np_dtype(params)
        eps = float(self._fd_eps(np_dtype))
        with torch.no_grad():
            # Projected-path Armijo slope (module docstring), clamped to
            # <= 0 so that the test stays a descent test under FD noise.
            gtd = torch.clamp((loss(params + eps * d) - f0) / eps, max=0.0)
            losses = torch.stack([loss(params + float(a) * d)
                                  for a in self._alphas(np_dtype)], dim=-1)
        return self._select_step(f0, gtd, losses)

    def update(self, state, grads, params, f0, loss_fn):
        """One L-BFGS step: returns (new state, new params).
        ``loss_fn(flat_params) -> scalar`` is the clip-projected loss and
        ``f0`` its value at ``params``."""
        state = self._advance(state, params, grads)
        d, _ = self._direction(state, grads)
        alpha = self._ladder(params, d, f0, loss_fn)
        return state, params + alpha * d

    def update_batch(self, state, grads, params, frozen, f0, batch_loss):
        """One step of every candidate (params (N, n), f0 (N,)):
        ``batch_loss((N, n)) -> (N,)`` gives all candidates' projected
        losses in one forward a rung. A ``frozen`` candidate (a bool (N,))
        keeps its parameters and its state; it still rides through the
        ladder, as in ``qoc_tpu``, so that no branch depends on the data."""
        new_state = self._advance(state, params, grads)
        d, _ = self._direction(new_state, grads)
        alpha = self._ladder(params, d, f0, batch_loss)
        new_params = params + alpha[:, None] * d

        def keep(new, old):
            return torch.where(
                frozen.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)

        return ({key: keep(new_state[key], state[key]) for key in state},
                keep(new_params, params))

    # -- host twin -----------------------------------------------------------

    def run(self, function, iteration_count, initial_params, jacobian,
            args=()):
        """The host loop on numpy, with sequential backtracking along the
        same ladder. ``function`` returns (error, terminate), ``jacobian``
        (grads, terminate)."""
        params = np.asarray(initial_params, dtype=float)
        n, m = params.size, self.history
        if getattr(self, "_warm_start", False):
            # The ring carried over by load_state_dict (a resume).
            self._warm_start = False
        else:
            self._host = {
                "s": np.zeros((m, n)), "y": np.zeros((m, n)),
                "rho": np.zeros(m), "gamma": 0.0,
                "prev_params": np.zeros(n), "prev_grads": np.zeros(n),
                "have_prev": 0.0, "t": 0,
            }
        h = self._host
        for _ in range(iteration_count):
            grads, terminate = jacobian(params, *args)
            if terminate:
                break
            grads = np.asarray(grads, dtype=float)
            self._advance_np(h, params, grads)
            d, _ = self._direction_np(h, grads)
            f0, _ = function(params, *args)
            eps = float(self._fd_eps(float))
            f_eps, _ = function(params + eps * d, *args)
            gtd = min((f_eps - f0) / eps, 0.0)
            alpha = 0.0
            best_alpha, best_f = 0.0, f0
            for a in self._alphas(float):
                f_trial, _ = function(params + a * d, *args)
                if f_trial <= f0 + self.c1 * a * gtd:
                    alpha = a
                    break
                if f_trial < best_f:
                    best_alpha, best_f = a, f_trial
            if alpha == 0.0:
                alpha = best_alpha
            params = params + alpha * d

    def _advance_np(self, h, params, grads):
        m = self.history
        s = params - h["prev_params"]
        y = grads - h["prev_grads"]
        sy = float(s @ y)
        good = (h["have_prev"] > 0.5
                and sy > 1e-10 * np.sqrt((s @ s) * (y @ y)) + 1e-30)
        if good:
            idx = h["t"] % m
            h["s"][idx] = s
            h["y"][idx] = y
            h["rho"][idx] = 1.0 / sy
            h["gamma"] = sy / max(float(y @ y), 1e-30)
            h["t"] += 1
        h["prev_params"] = params.copy()
        h["prev_grads"] = grads.copy()
        h["have_prev"] = 1.0

    def _direction_np(self, h, grads):
        m = self.history
        q = grads.copy()
        alphas = np.zeros(m)
        idxs = [(h["t"] - 1 - j) % m for j in range(m)]
        for j, idx in enumerate(idxs):
            if h["rho"][idx] > 0:
                alphas[j] = h["rho"][idx] * (h["s"][idx] @ q)
                q -= alphas[j] * h["y"][idx]
        gamma = (h["gamma"] if h["gamma"] > 0
                 else 1.0 / max(np.linalg.norm(grads), 1.0))
        r = gamma * q
        for j in reversed(range(m)):
            idx = idxs[j]
            if h["rho"][idx] > 0:
                beta = h["rho"][idx] * (h["y"][idx] @ r)
                r += (alphas[j] - beta) * h["s"][idx]
        d = -r
        gtd = float(grads @ d)
        if gtd >= 0:
            d = -gamma * grads
            gtd = -gamma * float(grads @ grads)
        return d, gtd

    # -- checkpoint support ------------------------------------------------

    def state_dict(self):
        """The host twin's ring (``qoc_tpu``'s keys), empty before a run."""
        if self._host is None:
            return {}
        return {key: np.asarray(value) for key, value in self._host.items()}

    def load_state_dict(self, state):
        self._host = {
            "s": np.asarray(state["s"], dtype=float),
            "y": np.asarray(state["y"], dtype=float),
            "rho": np.asarray(state["rho"], dtype=float),
            "gamma": float(state["gamma"]),
            "prev_params": np.asarray(state["prev_params"], dtype=float),
            "prev_grads": np.asarray(state["prev_grads"], dtype=float),
            "have_prev": float(state["have_prev"]),
            "t": int(state["t"]),
        }


def _dot(a, b):
    """Inner product over the last axis."""
    return torch.sum(a * b, dim=-1)


def _np_dtype(tensor):
    return np.float32 if tensor.dtype == torch.float32 else np.float64
