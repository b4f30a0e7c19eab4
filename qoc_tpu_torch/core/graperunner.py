"""GRAPE optimization loop, on device.

Counterpart of ``qoc_tpu/core/graperunner.py`` (the fused path,
``_run_fused``). Each iteration is clip-project -> loss and gradient ->
optimizer update (Adam or SGD), with best-iterate tracking and the termination freeze done by
``torch.where`` on device. Per-iteration rows (error, |grads|, valid) go
into preallocated device tensors and are pulled to the host once per chunk,
for logging in the reference's format: no iteration reads a value back to
the host, so on CUDA the host enqueues iterations ahead of the card.

Reference-parity semantics, exactly as ``qoc_tpu``:
- controls are clipped to max_control_norms *outside* the differentiation
  (the gradient is taken at the clipped point w.r.t. the clipped controls —
  reference schroedingerdiscrete.py:307-313),
- the optimizer updates the *unclipped* parameters,
- iteration i logs the error/gradient evaluated at iteration i's parameters
  before the update; reaching ``error <= min_error`` skips the update and
  freezes every later iteration of the run.

The host loop (L-BFGS-B, the device L-BFGS, user
``impose_control_conditions`` hooks) and resuming from a save file are
later slices of the port (ROADMAP 3 and 4); an optimizer without the
fused update (``supports_fused``) is refused.
"""

import numpy as np
import torch

from qoc_tpu_torch.config import complex_dtype
from qoc_tpu_torch.core.common import (clip_control_norms_torch,
                                       slap_controls, slap_controls_torch,
                                       strip_controls, strip_controls_torch)
from qoc_tpu_torch.profiler import RateMeter, trace_annotation

__all__ = ["run_grape"]

_DEFAULT_CHUNK = 200


def run_grape(pstate, result, loss_flat, device, dtype, evolved="states"):
    """Run the optimization described by ``pstate`` and fill ``result``.

    ``loss_flat`` maps flat real params (already clipped; a tensor that
    requires grad) to (error, final evolved): the final states, or with
    ``evolved="densities"`` the final densities, of shape
    ``pstate.evolved_shape``, which go to ``result.best_final_<evolved>``
    (``qoc_tpu``'s runner takes the field names; its Lindblad entry point
    passes ``best_final_densities``). For an ensemble the error is the
    members' mean and the final states keep the member axis."""
    if pstate.impose_control_conditions is not None:
        raise NotImplementedError(
            "impose_control_conditions needs the host optimization loop, "
            "which is ROADMAP slice 3 of qoc_tpu_torch.")
    if not getattr(pstate.optimizer, "supports_fused", False):
        raise NotImplementedError(
            "{} needs the host optimization loop, which is ROADMAP slice 3 "
            "of qoc_tpu_torch; use Adam or SGD.".format(
                type(pstate.optimizer).__name__))
    _run_fused(pstate, result, loss_flat, device, dtype, evolved)


def _run_fused(pstate, result, loss_flat, device, dtype, evolved):
    cc = pstate.complex_controls
    shape = pstate.controls_shape
    mcn = torch.as_tensor(np.asarray(pstate.max_control_norms),
                          dtype=dtype, device=device)
    optimizer = pstate.optimizer
    min_error = pstate.min_error
    meter = RateMeter().start()

    def evaluate(params):
        """(error, final_states, clipped_flat, grads) at ``params``."""
        controls = slap_controls_torch(cc, params, shape)
        clipped_flat = strip_controls_torch(
            cc, clip_control_norms_torch(controls, mcn))
        clipped_flat = clipped_flat.detach().requires_grad_(True)
        error, final_states = loss_flat(clipped_flat)
        grads, = torch.autograd.grad(error, clipped_flat)
        return error.detach(), final_states.detach(), clipped_flat.detach(), \
            grads

    x0 = strip_controls(cc, np.asarray(pstate.initial_controls))
    params = torch.as_tensor(x0, dtype=dtype, device=device)
    opt_state = optimizer.init_state(params)
    done = torch.zeros((), dtype=torch.bool, device=device)
    states_shape = pstate.evolved_shape
    best = {
        "error": torch.tensor(torch.finfo(dtype).max, dtype=dtype,
                              device=device),
        "controls_flat": torch.zeros_like(params),
        "final_states": torch.zeros(states_shape,
                                    dtype=complex_dtype(dtype),
                                    device=device),
        "iteration": torch.zeros((), dtype=torch.int64, device=device),
        "count": torch.zeros((), dtype=torch.int64, device=device),
    }

    def iteration_step(params, opt_state, done):
        error, final_states, clipped_flat, grads = evaluate(params)
        grads_norm = torch.linalg.vector_norm(grads)
        new_opt_state, new_params = optimizer.update(opt_state, grads,
                                                     params)
        # Freeze everything once terminated; `valid` marks rows that really
        # ran (the terminating evaluation itself is still valid/logged).
        valid = ~done
        improved = valid & (error < best["error"])
        best["error"] = torch.where(improved, error, best["error"])
        best["controls_flat"] = torch.where(improved, clipped_flat,
                                            best["controls_flat"])
        best["final_states"] = torch.where(improved, final_states,
                                           best["final_states"])
        best["iteration"] = torch.where(improved, best["count"],
                                        best["iteration"])
        best["count"] = best["count"] + valid.to(torch.int64)
        new_done = done | (error <= min_error)
        # Termination skips the update (reference adam.py:104-106 breaks
        # before update()).
        params = torch.where(new_done, params, new_params)
        opt_state = {key: torch.where(new_done, opt_state[key],
                                      new_opt_state[key])
                     for key in opt_state}
        return params, opt_state, new_done, (error, grads_norm, valid)

    chunk = int(pstate.fused_chunk or _DEFAULT_CHUNK)
    iterations_left = max(0, pstate.iteration_count)
    global_iter = 0
    all_errors = []
    while iterations_left > 0:
        length = min(chunk, iterations_left)
        rows = torch.empty((3, length), dtype=dtype, device=device)
        with trace_annotation("qoc_tpu_torch.grape.chunk"):
            for i in range(length):
                params, opt_state, done, row = iteration_step(
                    params, opt_state, done)
                rows[:, i] = torch.stack([r.to(dtype) for r in row])
        errors, gnorms, valids = rows.cpu().numpy()
        n_valid = int(np.sum(valids > 0.5))
        if n_valid:
            meter.tick(n_valid)
        all_errors.append(errors[:n_valid])
        for j in range(n_valid):
            _log_row(pstate, global_iter + j, float(errors[j]),
                     float(gnorms[j]))
        global_iter += n_valid
        iterations_left -= length
        if bool(done):
            break

    if global_iter == 0:
        # iteration_count == 0: fill the result from one evaluation of the
        # initial controls instead of returning the sentinel best.
        if pstate.should_log:
            print("qoc_tpu_torch: iteration_count is 0; evaluating the "
                  "initial controls without optimizing.")
        error0, states0, clipped0, _ = evaluate(params)
        result.best_controls = slap_controls(
            cc, clipped0.cpu().numpy(), shape)
        result.best_error = float(error0)
        setattr(result, "best_final_" + evolved, states0.cpu().numpy())
        result.best_iteration = 0
        result.iteration_count_ran = 0
        result.iterations_per_s = 0.0
        result.errors = np.zeros((0,))
        return

    result.best_controls = slap_controls(
        cc, best["controls_flat"].cpu().numpy(), shape)
    result.best_error = float(best["error"])
    setattr(result, "best_final_" + evolved,
            best["final_states"].cpu().numpy())
    result.best_iteration = int(best["iteration"])
    result.iteration_count_ran = global_iter
    result.iterations_per_s = meter.steady_rate
    result.iterations_per_s_mean = meter.mean_rate
    result.errors = np.concatenate(all_errors)


def _log_row(pstate, iteration, error, grads_norm):
    if not pstate.should_log or iteration > pstate.final_iteration:
        return
    if (iteration % pstate.log_iteration_step == 0
            or iteration == pstate.final_iteration):
        print("{:^6d} | {:^1.8e} | {:^1.8e}".format(iteration, error,
                                                    grads_norm))
