"""GRAPE optimization loops: the fused loop on device and the host loop.

Counterpart of ``qoc_tpu/core/graperunner.py``. The fused loop
(``_run_fused``, every optimizer with a device update: Adam, SGD, LBFGS)
runs each iteration as clip-project -> loss and gradient -> optimizer
update, with best-iterate tracking and the termination freeze done by
``torch.where`` on device. Per-iteration rows (error, |grads|, valid) go
into preallocated device tensors and are pulled to the host once per chunk,
for logging in the reference's format: no iteration reads a value back to
the host, so on CUDA the host enqueues iterations ahead of the card. Every
update is also given the scalar loss through the same clip projection,
which only the line search of an optimizer that ``needs_loss`` (LBFGS)
calls.

The host loop (``_run_host``: LBFGSB, and every optimizer under an
``impose_control_conditions`` hook, which runs on numpy controls) hands
the optimizer's ``run`` a loss and a gradient function of numpy params;
each reads the error back. A loss and a gradient asked at the same point
(scipy's paired calls) cost one evaluation on the device, and the loss
alone of a ``needs_loss`` optimizer's line search is a forward without the
backward.

Reference-parity semantics, exactly as ``qoc_tpu``:
- controls are clipped to max_control_norms *outside* the differentiation
  (the gradient is taken at the clipped point w.r.t. the clipped controls —
  reference schroedingerdiscrete.py:307-313),
- the optimizer updates the *unclipped* parameters,
- iteration i logs the error/gradient evaluated at iteration i's parameters
  before the update; reaching ``error <= min_error`` skips the update and
  freezes every later iteration of the run.

Resuming from a save file is a later slice of the port (ROADMAP Queue 1
item 7).
"""

import numpy as np
import torch

from qoc_tpu_torch.config import complex_dtype
from qoc_tpu_torch.core.common import (clip_control_norms,
                                       clip_control_norms_torch,
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
    if (getattr(pstate.optimizer, "supports_fused", False)
            and pstate.impose_control_conditions is None):
        _run_fused(pstate, result, loss_flat, device, dtype, evolved)
    else:
        _run_host(pstate, result, loss_flat, device, dtype, evolved)


def _run_host(pstate, result, loss_flat, device, dtype, evolved):
    cc = pstate.complex_controls
    shape = pstate.controls_shape
    mcn = np.asarray(pstate.max_control_norms)
    optimizer = pstate.optimizer
    meter = RateMeter().start()
    state = {"iteration": 0, "cache_key": None, "cache_val": None}
    errors = []

    def prepare(params):
        controls = clip_control_norms(
            slap_controls(cc, np.asarray(params), shape), mcn)
        if pstate.impose_control_conditions is not None:
            controls = pstate.impose_control_conditions(controls)
        return controls

    def as_flat(controls):
        return torch.as_tensor(strip_controls(cc, controls), dtype=dtype,
                               device=device)

    def evaluate(params):
        """(controls, error, final evolved, grads) at ``params``, cached
        so that scipy's paired loss and gradient calls cost one
        evaluation."""
        params = np.asarray(params)
        key = params.tobytes()
        if state["cache_key"] == key:
            return state["cache_val"]
        controls = prepare(params)
        clipped_flat = as_flat(controls).requires_grad_(True)
        error, final_evolved = loss_flat(clipped_flat)
        grads, = torch.autograd.grad(error, clipped_flat)
        error = float(error.detach())
        if np.isnan(error):
            print("qoc_tpu_torch: loss evaluated to NaN. If this is a "
                  "Lindblad RKDP5 run, the adaptive integrator likely "
                  "exceeded rkdp5_max_steps — raise it, relax atol, or "
                  "switch to LindbladMethod.MAGNUS_EXPM.")
        val = (controls, error, final_evolved.detach().cpu().numpy(),
               grads.cpu().numpy())
        state["cache_key"], state["cache_val"] = key, val
        return val

    if getattr(optimizer, "needs_loss", False):
        # The line search's trial points want the loss alone: a forward
        # without the backward. At the current iterate the cache answers.
        def function_wrap(params):
            params = np.asarray(params)
            if state["cache_key"] == params.tobytes():
                error = state["cache_val"][1]
            else:
                with torch.no_grad():
                    error = float(loss_flat(as_flat(prepare(params)))[0])
            return error, error <= pstate.min_error
    else:
        def function_wrap(params):
            error = evaluate(params)[1]
            return error, error <= pstate.min_error

    def jacobian_wrap(params):
        controls, error, final_evolved, grads_flat = evaluate(params)
        iteration = state["iteration"]
        if error < result.best_error:
            result.best_controls = controls
            result.best_error = error
            setattr(result, "best_final_" + evolved, final_evolved)
            result.best_iteration = iteration
        _log_row(pstate, iteration, error, float(np.linalg.norm(grads_flat)))
        errors.append(error)
        state["iteration"] = iteration + 1
        meter.tick()
        return grads_flat, error <= pstate.min_error

    x0 = strip_controls(cc, np.asarray(pstate.initial_controls))
    iterations = max(0, pstate.iteration_count)
    if iterations == 0:
        # Nothing to run: evaluate the initial controls once so that the
        # result is filled.
        if pstate.should_log:
            print("qoc_tpu_torch: iteration_count is 0; evaluating the "
                  "initial controls without optimizing.")
        controls, error, final_evolved, _ = evaluate(x0)
        result.best_controls = controls
        result.best_error = error
        setattr(result, "best_final_" + evolved, final_evolved)
        result.best_iteration = 0
        result.iteration_count_ran = 0
        result.iterations_per_s = 0.0
        result.errors = np.zeros((0,))
        return
    with trace_annotation("qoc_tpu_torch.grape.host_loop"):
        optimizer.run(function_wrap, iterations, x0, jacobian_wrap)
    result.iteration_count_ran = state["iteration"]
    # The steady rate leaves out the first iteration, which carries the
    # kernel build and warm-up.
    result.iterations_per_s = meter.steady_rate
    result.iterations_per_s_mean = meter.mean_rate
    result.errors = np.asarray(errors)


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

    def projected_loss(flat_params):
        """The scalar loss through the same clip projection: the line
        search's view of the objective for ``needs_loss`` optimizers."""
        clipped = clip_control_norms_torch(
            slap_controls_torch(cc, flat_params, shape), mcn)
        return loss_flat(strip_controls_torch(cc, clipped))[0]

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
        new_opt_state, new_params = optimizer.update(
            opt_state, grads, params, error, projected_loss)
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
