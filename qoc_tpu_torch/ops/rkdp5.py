"""Adaptive Dormand-Prince RKDP5(4) integrator with dense output, on lanes.

Counterpart of ``qoc_tpu/ops/rkdp5.py`` (reference
qoc/core/mathmethods.py:209-480): the same Butcher tableau, FSAL reuse,
Hairer's automatic initial step, accept/reject controller (safety 0.9,
factors [0.2, 10]) and quartic dense output. Two integrators:

- :func:`integrate_rkdp5`, forward only, runs until every lane has passed
  ``x_eval[-1]``, with no bound on attempts (``qoc_tpu``'s
  ``lax.while_loop``);
- :func:`integrate_rkdp5_scan`, differentiable, runs at most ``max_steps``
  attempts and gives NaN in every lane that did not pass ``x_eval[-1]``
  (``qoc_tpu``'s bounded ``lax.scan``). Autograd runs through the realized
  mesh: the initial step, the error norm and the next step are detached
  where ``qoc_tpu`` stops their gradient, so the gradient is the
  discretize-then-optimize adjoint of the scheme that ran.

Lanes. With ``lanes=True`` the state's leading axis holds independent
problems (the candidates x members of a Lindblad ensemble or multistart),
and ``rhs(x, y)`` takes each lane's abscissa x (L,) with the states y (L,
...). Each lane has its own x, step h, rejected flag and error norm, the
norm taken over that lane's entries alone, so each lane takes the mesh it
would take alone (``qoc_tpu`` runs such lanes under ``jax.vmap``). An
attempt runs on every lane; a lane that is done, or whose attempt was
rejected, keeps its carry through ``torch.where``, and a done lane keeps
its step too, so its no-op attempts stay finite and give zero gradient.

Host reads. Where ``qoc_tpu`` branches on the device (``lax.cond``,
``lax.while_loop``), the port runs the attempts in chunks of masked
attempts, 4 and then :data:`CHUNK` a chunk, and reads once a chunk whether
any lane is still active, never once an attempt: an integration of A
attempts reads at most ceil(A / CHUNK) + 1 times and wastes fewer than
CHUNK attempts (fewer than 4 where it takes 4 or fewer). :data:`counts` counts, over every integration
since :func:`reset_counts`: ``attempts`` run, ``busy`` attempts (those in
which some lane was active), ``host_reads`` and ``integrations``.
"""

import torch

from qoc_tpu_torch.ops.linalg import rms_norm

__all__ = ["CHUNK", "counts", "integrate_rkdp5", "integrate_rkdp5_scan",
           "integrate_rkdp5_step", "reset_counts", "rkdp5_dense"]

# Attempts between two host reads, once the chunks have ramped up from
# _FIRST_CHUNK. A read costs a device sync, about the time of a few of the
# small launches that an attempt is made of; a wasted attempt costs a whole
# attempt, some hundreds of them at d = 2. Smooth short intervals take 2-4
# attempts (the d = 20 cell), example 1's one interval hundreds.
CHUNK = 8
_FIRST_CHUNK = 4

counts = {"attempts": 0, "busy": 0, "host_reads": 0, "integrations": 0}


def reset_counts():
    """Set every entry of :data:`counts` to 0."""
    for key in counts:
        counts[key] = 0


# Butcher tableau, Hairer-Norsett-Wanner table 5.2 (reference
# mathmethods.py:209-247, ``qoc_tpu`` rkdp5.py:44-66).
_C2, _C3, _C4, _C5 = 1 / 5, 3 / 10, 4 / 5, 8 / 9
_A21 = 1 / 5
_A31, _A32 = 3 / 40, 9 / 40
_A41, _A42, _A43 = 44 / 45, -56 / 15, 32 / 9
_A51, _A52, _A53, _A54 = 19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729
_A61, _A62, _A63, _A64, _A65 = (9017 / 3168, -355 / 33, 46732 / 5247,
                                49 / 176, -5103 / 18656)
_B1, _B3, _B4, _B5, _B6 = 35 / 384, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84
_B1H, _B3H, _B4H, _B5H, _B6H, _B7H = (5179 / 57600, 7571 / 16695, 393 / 640,
                                      -92097 / 339200, 187 / 2100, 1 / 40)
# Dense-output coefficients (reference mathmethods.py:249-255).
_D1 = -12715105075 / 11282082432
_D3 = 87487479700 / 32700410799
_D4 = -10690763975 / 1880347072
_D5 = 701980252875 / 199316789632
_D6 = -1453857185 / 822651844
_D7 = 69997945 / 29380423
_ORDER = 5
_ERROR_EXP = -1 / 5  # -1/(min(p, p_hat) + 1)


def _against(x, y):
    """``x`` (the step or abscissa, 0-dim or one value a lane) with
    trailing unit axes, to broadcast against the states ``y``."""
    return x.reshape(x.shape + (1,) * (y.dim() - x.dim()))


def _step_like(h, y):
    """The step ``h`` against the states ``y``, in their dtype: cast once,
    not at every product with a complex stage."""
    return _against(h, y).to(y.dtype)


def _stage(y0, hy, terms):
    """y0 + h Σ_j a_j k_j for ``terms`` ((a_j, k_j), ...): scaled adds and
    one multiply-add, fewer launches than the products and sums apart."""
    (a, k), rest = terms[0], terms[1:]
    total = a * k
    for a, k in rest:
        total = torch.add(total, k, alpha=a)
    return torch.addcmul(y0, hy, total)


def integrate_rkdp5_step(h, rhs, x0, y0, k1=None):
    """One RKDP5(4) step. Returns (ks, y1 (5th order), y1h (4th order)).

    ``h`` and ``x0`` are 0-dim, or (L,) against lanes y0 (L, ...).
    Parity: reference mathmethods.py:307-349 (FSAL: pass ``k1`` = the
    previous k7).
    """
    hy = _step_like(h, y0)
    if k1 is None:
        k1 = rhs(x0, y0)
    k2 = rhs(x0 + _C2 * h, _stage(y0, hy, ((_A21, k1),)))
    k3 = rhs(x0 + _C3 * h, _stage(y0, hy, ((_A31, k1), (_A32, k2))))
    k4 = rhs(x0 + _C4 * h, _stage(y0, hy, ((_A41, k1), (_A42, k2),
                                           (_A43, k3))))
    k5 = rhs(x0 + _C5 * h, _stage(y0, hy, ((_A51, k1), (_A52, k2),
                                           (_A53, k3), (_A54, k4))))
    k6 = rhs(x0 + h, _stage(y0, hy, ((_A61, k1), (_A62, k2), (_A63, k3),
                                     (_A64, k4), (_A65, k5))))
    y1 = _stage(y0, hy, ((_B1, k1), (_B3, k3), (_B4, k4), (_B5, k5),
                         (_B6, k6)))
    k7 = rhs(x0 + h, y1)
    y1h = _stage(y0, hy, ((_B1H, k1), (_B3H, k3), (_B4H, k4), (_B5H, k5),
                          (_B6H, k6), (_B7H, k7)))
    return (k1, k2, k3, k4, k5, k6, k7), y1, y1h


def _dense(ks, h, theta, y0, y1):
    """The quartic dense output at ``theta`` (the fraction of the step h,
    broadcasting against the states) of a step y0 -> y1 of size ``h``."""
    hy = _step_like(h, y0)
    r1 = y0
    r2 = y1 - y0
    r3 = y0 + hy * ks[0] - y1
    r4 = 2 * (y1 - y0) - hy * (ks[0] + ks[6])
    r5 = _stage(torch.zeros_like(y0), hy, ((_D1, ks[0]), (_D3, ks[2]),
                                           (_D4, ks[3]), (_D5, ks[4]),
                                           (_D6, ks[5]), (_D7, ks[6])))
    theta = theta.to(y0.dtype)
    theta2 = theta ** 2
    theta3 = theta ** 3
    theta4 = theta2 ** 2
    return (r1
            + theta * (r2 + r3)
            - theta2 * (r3 - r4 - r5)
            - theta3 * (r4 + 2 * r5)
            + theta4 * r5)


def rkdp5_dense(ks, x0, x1, x_eval, y0, y1):
    """Quartic dense-output interpolation of one step onto ``x_eval``
    (n_eval,): shape (n_eval, *y0.shape). ``x0`` and ``x1`` are 0-dim, or
    (L,) against lanes y0 (L, ...).

    Parity: reference mathmethods.py:263-304.
    """
    h = x1 - x0
    x_eval = x_eval.reshape(x_eval.shape + (1,) * h.dim())
    theta = (x_eval - x0) / h
    # Broadcast theta (n_eval, *lanes) against y-shaped residuals.
    return _dense(ks, h, _against(theta, y0[None]), y0, y1)


def _initial_step(rhs, x_initial, y_initial):
    """Hairer's automatic initial step size, one a lane (reference
    mathmethods.py:405-420). Returns (h_first, f0), where f0 =
    rhs(x_initial, y_initial) is reused as k1 and h_first is detached."""
    f0 = rhs(x_initial, y_initial)
    lanes = x_initial.dim()
    with torch.no_grad():
        y0, f0d = y_initial.detach(), f0.detach()
        d0 = rms_norm(y0, lanes)
        d1 = rms_norm(f0d, lanes)
        tiny = torch.finfo(d1.dtype).tiny
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                         torch.full_like(d1, 1e-6),
                         0.01 * d0 / torch.clamp(d1, min=tiny))
        f1 = rhs(x_initial + h0, y0 + _step_like(h0, y0) * f0d)
        d2 = rms_norm(f1 - f0d, lanes) / h0
        dmax = torch.maximum(d1, d2)
        flat = dmax <= 1e-15
        h1 = torch.where(
            flat, torch.clamp(h0 * 1e-3, min=1e-6),
            torch.pow(0.01 / torch.where(flat, torch.ones_like(dmax), dmax),
                      1 / (_ORDER + 1)))
        return torch.minimum(100 * h0, h1), f0


def _safe_abs(y):
    """|y| with a zero (not NaN) derivative at y == 0."""
    mag2 = torch.real(y * torch.conj(y))
    positive = mag2 > 0
    safe = torch.where(positive, mag2, torch.ones_like(mag2))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(mag2))


def _controller_factors(error_norm, step_rejected, safety, fac_max, fac_min):
    """Step-size multipliers for the accepted and rejected branches."""
    # NaN-safe power: guard the error_norm == 0 lane before the pow.
    positive = error_norm > 0
    err_safe = torch.where(positive, error_norm,
                           torch.ones_like(error_norm))
    powed = safety * torch.pow(err_safe, _ERROR_EXP)
    fac_accept = torch.where(positive, torch.clamp(powed, max=fac_max),
                             torch.full_like(powed, fac_max))
    # After a rejection, do not let the next step grow (reference :455-457).
    fac_accept = torch.where(step_rejected, torch.clamp(fac_accept, max=1.0),
                             fac_accept)
    fac_reject = torch.clamp(powed, min=fac_min)
    return fac_accept, fac_reject


def _attempt(rhs, x, y, k1, h, step_rejected, atol, rtol, safety, fac_max,
             fac_min):
    """One accept/reject attempt of every lane. Returns (accept, ks, y1,
    x_new, h_next); accept and h_next are detached."""
    ks, y1, y1h = integrate_rkdp5_step(h, rhs, x, y, k1=k1)
    x_new = x + h
    # The step-size controller is detached from the gradient, as in
    # qoc_tpu: differentiating through the h-update chain explodes
    # reverse-mode gradients, while the gradient on the realized mesh is the
    # exact adjoint of the scheme that ran.
    with torch.no_grad():
        y1d, y1hd = y1.detach(), y1h.detach()
        if isinstance(rtol, (int, float)) and rtol == 0:
            # Static fast path: skips |y| (qoc_tpu rkdp5.py:168).
            scale = atol
        else:
            scale = atol + torch.maximum(_safe_abs(y1d),
                                         _safe_abs(y1hd)) * rtol
        error_norm = rms_norm((y1d - y1hd) / scale, h.dim())
        accept = error_norm < 1
        fac_accept, fac_reject = _controller_factors(
            error_norm, step_rejected, safety, fac_max, fac_min)
        h_next = h * torch.where(accept, fac_accept, fac_reject)
    return accept, ks, y1, x_new, h_next


# What the dense output of a step needs: x, x_new, y, y1 and ks 0, 2-6.
_HELD_KS = (0, 2, 3, 4, 5, 6)


def _hold(held, x, x_new, x_eval, ks, y, y1, take):
    """Keep, for each eval point and lane, the step that covers it: the
    last one that the lane ``take``s with x <= x_eval <= x_new (inclusive
    left, reference :467-469). The dense output is formed once from them,
    after the loop, in place of at every attempt; ``held`` is (covered
    (n_eval, L), x, x_new, y, y1, ks 0, 2-6), each with the eval axis
    first."""
    lanes = (1,) * x.dim()
    cover = ((x <= x_eval.reshape(x_eval.shape + lanes))
             & (x_eval.reshape(x_eval.shape + lanes) <= x_new) & take)
    now = (x, x_new, y, y1) + tuple(ks[j] for j in _HELD_KS)
    return (held[0] | cover,) + tuple(
        torch.where(_against(cover, old), new, old)
        for new, old in zip(now, held[1:]))


def _held_dense(held, x_eval):
    """The dense outputs (n_eval, L, ...) of the held steps, 0 where no
    step covered an eval point (``qoc_tpu``'s zeros)."""
    covered, x, x_new, y, y1 = held[:5]
    ks = dict(zip(_HELD_KS, held[5:]))
    h = x_new - x
    theta = (x_eval.reshape(x_eval.shape + (1,) * (h.dim() - 1)) - x) / h
    dense = _dense((ks[0], None, ks[2], ks[3], ks[4], ks[5], ks[6]), h,
                   _against(theta, y), y, y1)
    return torch.where(_against(covered, y), dense, torch.zeros_like(dense))


def _integrate(rhs, x_eval, x_initial, y_initial, atol, rtol, safety,
               fac_max, fac_min, max_steps, lanes):
    if not lanes:
        # One lane: the lane axis added here and taken off the result.
        out = _integrate(lambda x, y: rhs(x[0], y[0])[None], x_eval,
                         x_initial, y_initial[None], atol, rtol, safety,
                         fac_max, fac_min, max_steps, True)
        return out[:, 0]
    rdt = y_initial.real.dtype
    x_eval = torch.as_tensor(x_eval, dtype=rdt, device=y_initial.device)
    x_final = x_eval[-1]
    x = torch.as_tensor(x_initial, dtype=rdt, device=y_initial.device)
    x = x.expand(y_initial.shape[:1]).clone()
    h, k1 = _initial_step(rhs, x, y_initial)
    y = y_initial
    # The held steps start uncovered, with a unit step (no 0/0 below).
    blank = torch.zeros((x_eval.shape[0],) + y.shape, dtype=y.dtype,
                        device=y.device)
    lane_x = torch.zeros((x_eval.shape[0],) + x.shape, dtype=rdt,
                         device=x.device)
    held = ((lane_x > 0), lane_x, lane_x + 1) + (blank,) * (
        2 + len(_HELD_KS))
    rejected = torch.zeros_like(x, dtype=torch.bool)
    counts["integrations"] += 1
    steps = reads = 0
    while max_steps is None or steps < max_steps:
        # The chunks ramp up to CHUNK: 4, 8, ... attempts, since short
        # intervals take only a few.
        length = min(CHUNK, _FIRST_CHUNK << reads)
        if max_steps is not None:
            length = min(length, max_steps - steps)
        busy = torch.zeros((), dtype=torch.int64, device=x.device)
        for _ in range(length):
            active = x <= x_final
            busy = busy + active.any()
            accept, ks, y1, x_new, h_next = _attempt(
                rhs, x, y, k1, h, rejected, atol, rtol, safety, fac_max,
                fac_min)
            take = active & accept
            held = _hold(held, x, x_new, x_eval, ks, y, y1, take)
            x = torch.where(take, x_new, x)
            y = torch.where(_against(take, y), y1, y)
            k1 = torch.where(_against(take, y), ks[6], k1)
            h = torch.where(active, h_next, h)
            rejected = torch.where(active, ~accept, rejected)
        steps += length
        reads += 1
        # The chunk's one host read: its busy attempts and whether any lane
        # is still active.
        busy, more = torch.stack((busy, (x <= x_final).any().to(
            torch.int64))).tolist()
        counts["attempts"] += length
        counts["busy"] += busy
        counts["host_reads"] += 1
        if not more:
            break
    out = _held_dense(held, x_eval)
    if max_steps is None:
        return out
    converged = x > x_final
    return torch.where(_against(converged, out[0])[None], out,
                       torch.full_like(out, float("nan")))


def integrate_rkdp5(rhs, x_eval, x_initial, y_initial, atol=1e-12, rtol=0.0,
                    step_safety_factor=0.9, step_update_factor_max=10.0,
                    step_update_factor_min=2e-1, lanes=False):
    """Adaptive RKDP5(4), forward only, until every lane has passed
    ``x_eval[-1]`` (``qoc_tpu``'s ``lax.while_loop`` form; run it under
    ``torch.no_grad()``).

    Arguments match the reference (mathmethods.py:352-480): ``x_eval`` is a
    sorted tensor of output abscissae (> x_initial, a number); outputs are
    quartic dense evaluations, shape (len(x_eval), *y_initial.shape). With
    ``lanes`` the leading axis of ``y_initial`` holds independent lanes
    (module docstring).
    """
    return _integrate(rhs, x_eval, x_initial, y_initial, atol, rtol,
                      step_safety_factor, step_update_factor_max,
                      step_update_factor_min, None, lanes)


def integrate_rkdp5_scan(rhs, x_eval, x_initial, y_initial, atol=1e-12,
                         rtol=0.0, step_safety_factor=0.9,
                         step_update_factor_max=10.0,
                         step_update_factor_min=2e-1, max_steps=16384,
                         lanes=False):
    """Adaptive RKDP5(4), differentiable, bounded at ``max_steps`` attempts
    (``qoc_tpu``'s bounded masked ``lax.scan``).

    The values of :func:`integrate_rkdp5` where a lane passes
    ``x_eval[-1]`` within ``max_steps`` attempts; NaN in every lane that
    does not, so the failure is visible (raise ``max_steps``; an attempt
    costs 6 fresh RHS evaluations). The attempts stop at the first chunk
    after which no lane is active.
    """
    return _integrate(rhs, x_eval, x_initial, y_initial, atol, rtol,
                      step_safety_factor, step_update_factor_max,
                      step_update_factor_min, int(max_steps), lanes)
