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

Save files and resume, as ``qoc_tpu``'s runner writes and reads them
(``io/h5.py``, ``io/resume.py``):
- the H5 row of a save iteration (``save_iteration_step``'s cadence and
  the final iteration; ``models/programstate.py`` ``save_step``): the
  fused loop keeps the rows of a chunk's save iterations (clipped
  controls, error, gradients, final states or densities) on the device
  and pulls them once a chunk, with the errors; the host loop writes each
  as it evaluates it;
- with ``save_intermediate_states`` / ``save_intermediate_densities``,
  ``collect_fn`` (the trajectory form of the loss, forward only) runs
  once a save row at its clipped controls;
- the optimizer snapshot (the ``optimizer_state`` group), at each chunk's
  end in the fused loop and each save iteration in the host loop:
  ``__params__``, ``__iteration__`` (the next iteration to run),
  ``checkpoint_kind`` (``single:<Optimizer>``), and ``opt`` followed by
  JAX's ``keystr`` of each leaf of the device state (``opt['m']``) or
  ``host_`` and each key of the optimizer's ``state_dict`` (host loop);
- ``pstate.resume_state`` (``apply_resume``) restores the params, the
  state and the iteration, cast to the run's dtype and device, so a
  float64 CPU checkpoint resumes in float32 on the card and the reverse,
  and a multistart checkpoint is refused. A resumed fused run repeats the
  uninterrupted run's trajectory from its chunk boundary on.
"""

import numpy as np
import torch

from qoc_tpu_torch.config import complex_dtype
from qoc_tpu_torch.core.common import (clip_control_norms,
                                       clip_control_norms_torch,
                                       slap_controls, slap_controls_torch,
                                       strip_controls, strip_controls_torch)
from qoc_tpu_torch.models.programstate import save_step
from qoc_tpu_torch.profiler import RateMeter, trace_annotation

__all__ = ["checkpoint_kind", "opt_key", "restore_tensors", "run_grape"]

_DEFAULT_CHUNK = 200

# Keys of the save file's optimizer_state group that are not optimizer
# state leaves (qoc_tpu graperunner.py).
RESUME_PARAMS = "__params__"
RESUME_ITERATION = "__iteration__"
RESUME_KIND = "checkpoint_kind"
_HOST_PREFIX = "host_"
_OPT_PREFIX = "opt"


def run_grape(pstate, result, loss_flat, device, dtype, evolved="states",
              collect_fn=None):
    """Run the optimization described by ``pstate`` and fill ``result``.

    ``loss_flat`` maps flat real params (already clipped; a tensor that
    requires grad) to (error, final evolved): the final states, or with
    ``evolved="densities"`` the final densities, of shape
    ``pstate.evolved_shape``, which go to ``result.best_final_<evolved>``
    and the save file's ``final_<evolved>`` rows (``qoc_tpu``'s runner
    takes the field names; its Lindblad entry point passes
    ``best_final_densities``). For an ensemble the error is the members'
    mean and the final states keep the member axis. ``collect_fn`` maps
    flat clipped params to the intermediate stack (system_eval_count, ...)
    that ``pstate.save_intermediate_<evolved>`` writes on save iterations
    (module docstring)."""
    if (getattr(pstate.optimizer, "supports_fused", False)
            and pstate.impose_control_conditions is None):
        _run_fused(pstate, result, loss_flat, device, dtype, evolved,
                   collect_fn)
    else:
        _run_host(pstate, result, loss_flat, device, dtype, evolved,
                  collect_fn)


def checkpoint_kind(resume_state):
    """The ``checkpoint_kind`` tag ("single:<Optimizer>" /
    "multistart:<Optimizer>") of a loaded optimizer-state dict, or None
    for a file without it."""
    raw = resume_state.get(RESUME_KIND)
    if raw is None:
        return None
    val = np.asarray(raw).reshape(()).item()
    return val.decode() if isinstance(val, bytes) else str(val)


def opt_key(name):
    """The save file's key of the optimizer state's leaf ``name``: "opt"
    and JAX's keystr of a dict key, so that ``qoc_tpu`` reads it."""
    return "{}[{!r}]".format(_OPT_PREFIX, name)


def restore_tensors(template, resume_state, keys):
    """Each tensor of ``template`` replaced by ``resume_state[key]`` of
    its key, cast to the template's dtype and device."""
    return {name: torch.as_tensor(np.asarray(resume_state[keys[name]])).to(
        dtype=leaf.dtype, device=leaf.device).reshape(leaf.shape)
        for name, leaf in template.items()}


def _resume_start(pstate):
    """(iteration to start at, resume state): (0, None) for a fresh run.
    A multistart checkpoint is refused (its params carry a candidate
    axis)."""
    resume_state = getattr(pstate, "resume_state", None)
    if resume_state is None:
        return 0, None
    kind = checkpoint_kind(resume_state)
    if ((kind or "").startswith("multistart")
            or (kind is None and "ms_best_err" in resume_state)):
        raise ValueError(
            "resume_from file holds a multistart checkpoint, not a "
            "single-run one — resume it through the matching "
            "grape_*_multistart entry point (same n_starts) or start this "
            "run fresh.")
    ckpt_opt = kind.split(":", 1)[1] if kind and ":" in kind else None
    if (ckpt_opt is not None
            and ckpt_opt != type(pstate.optimizer).__name__
            and pstate.should_log):
        print("qoc_tpu_torch: resume checkpoint was written by {}; this run "
              "uses {} — restoring params only, optimizer state starts "
              "fresh.".format(ckpt_opt, type(pstate.optimizer).__name__))
    if RESUME_ITERATION not in resume_state:
        return 0, resume_state
    return int(np.asarray(resume_state[RESUME_ITERATION])), resume_state


def _snapshot_optimizer(pstate, snap):
    if pstate.should_save:
        snap.setdefault(RESUME_KIND, np.bytes_(
            "single:" + type(pstate.optimizer).__name__))
        pstate.checkpointer.save_optimizer_state(snap)


def _restore_opt_state(opt_state, resume_state):
    """The device optimizer state with its leaves from a checkpoint, or
    the fresh state where the checkpoint lacks any of them (a
    controls-only resume, or another optimizer's file)."""
    if resume_state is None or not opt_state:
        return opt_state
    keys = {name: opt_key(name) for name in opt_state}
    if not all(key in resume_state for key in keys.values()):
        return opt_state
    return restore_tensors(opt_state, resume_state, keys)


def _save_intermediate(pstate, evolved):
    """``pstate.save_intermediate_states`` or ``_densities``."""
    return getattr(pstate, "save_intermediate_" + evolved)


def _fill_unrun(result, evolved, iteration_start, controls, error,
                final_evolved):
    """The result of a run that ran no iteration (``iteration_count`` 0,
    or a checkpoint already at it): one evaluation of the current
    controls."""
    result.best_controls = controls
    result.best_error = error
    setattr(result, "best_final_" + evolved, final_evolved)
    result.best_iteration = max(0, iteration_start - 1)
    result.iteration_count_ran = 0
    result.iterations_per_s = 0.0
    result.errors = np.zeros((0,))


def _log_unrun(pstate, iteration_start, resume_state):
    if not pstate.should_log:
        return
    if resume_state is not None:
        print("qoc_tpu_torch: resume checkpoint is already at iteration {} "
              ">= iteration_count {}; evaluating the restored controls "
              "without optimizing.".format(iteration_start,
                                           pstate.iteration_count))
    else:
        print("qoc_tpu_torch: iteration_count is 0; evaluating the initial "
              "controls without optimizing.")


def _run_host(pstate, result, loss_flat, device, dtype, evolved,
              collect_fn=None):
    cc = pstate.complex_controls
    shape = pstate.controls_shape
    mcn = np.asarray(pstate.max_control_norms)
    optimizer = pstate.optimizer
    evolved_key = "final_" + evolved
    iteration_start, resume_state = _resume_start(pstate)
    meter = RateMeter().start()
    state = {"iteration": iteration_start, "cache_key": None,
             "cache_val": None}
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
        step = save_step(pstate, iteration)
        if step is not None:
            pstate.checkpointer.save_grape_iteration(
                step, controls, error, final_evolved,
                slap_controls(cc, grads_flat, shape), evolved_key)
            if collect_fn is not None:
                with torch.no_grad():
                    stack = collect_fn(as_flat(controls))
                _save_intermediate(pstate, evolved)(iteration, stack)
            snap = {RESUME_PARAMS: np.asarray(params),
                    RESUME_ITERATION: np.asarray(iteration)}
            if hasattr(optimizer, "state_dict"):
                for key, value in optimizer.state_dict().items():
                    if value is not None:
                        snap[_HOST_PREFIX + key] = np.asarray(value)
            _snapshot_optimizer(pstate, snap)
        errors.append(error)
        state["iteration"] = iteration + 1
        meter.tick()
        return grads_flat, error <= pstate.min_error

    if resume_state is not None and RESUME_PARAMS in resume_state:
        x0 = np.asarray(resume_state[RESUME_PARAMS], dtype=np.float64)
        host_state = {key[len(_HOST_PREFIX):]: value
                      for key, value in resume_state.items()
                      if key.startswith(_HOST_PREFIX)}
        if host_state and hasattr(optimizer, "load_state_dict"):
            optimizer.load_state_dict(host_state)
            optimizer._warm_start = True
    else:
        x0 = strip_controls(cc, np.asarray(pstate.initial_controls))
    iterations = max(0, pstate.iteration_count - iteration_start)
    if iterations == 0:
        # Nothing to run: evaluate the current controls once so that the
        # result is filled (no update, no H5 row).
        _log_unrun(pstate, iteration_start, resume_state)
        controls, error, final_evolved, _ = evaluate(x0)
        _fill_unrun(result, evolved, iteration_start, controls, error,
                    final_evolved)
        return
    with trace_annotation("qoc_tpu_torch.grape.host_loop"):
        optimizer.run(function_wrap, iterations, x0, jacobian_wrap)
    result.iteration_count_ran = state["iteration"] - iteration_start
    # The steady rate leaves out the first iteration, which carries the
    # kernel build and warm-up.
    result.iterations_per_s = meter.steady_rate
    result.iterations_per_s_mean = meter.mean_rate
    result.errors = np.asarray(errors)


def _run_fused(pstate, result, loss_flat, device, dtype, evolved,
               collect_fn=None):
    cc = pstate.complex_controls
    shape = pstate.controls_shape
    mcn = torch.as_tensor(np.asarray(pstate.max_control_norms),
                          dtype=dtype, device=device)
    optimizer = pstate.optimizer
    min_error = pstate.min_error
    iteration_start, resume_state = _resume_start(pstate)
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

    if resume_state is not None and RESUME_PARAMS in resume_state:
        x0 = np.asarray(resume_state[RESUME_PARAMS], dtype=np.float64)
    else:
        x0 = strip_controls(cc, np.asarray(pstate.initial_controls))
    params = torch.as_tensor(x0, dtype=dtype, device=device)
    opt_state = _restore_opt_state(optimizer.init_state(params),
                                   resume_state)
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
        "count": torch.full((), iteration_start, dtype=torch.int64,
                            device=device),
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
        save_row = (clipped_flat, grads, final_states)
        return (params, opt_state, new_done, (error, grads_norm, valid),
                save_row)

    chunk = int(pstate.fused_chunk or _DEFAULT_CHUNK)
    iterations_left = max(0, pstate.iteration_count - iteration_start)
    global_iter = iteration_start
    all_errors = []
    while iterations_left > 0:
        length = min(chunk, iterations_left)
        rows = torch.empty((3, length), dtype=dtype, device=device)
        # The save iterations' rows stay on the device until the chunk's
        # pull: {chunk index: (clipped params, grads, final evolved)}.
        saves = {}
        with trace_annotation("qoc_tpu_torch.grape.chunk"):
            for i in range(length):
                params, opt_state, done, row, save_row = iteration_step(
                    params, opt_state, done)
                rows[:, i] = torch.stack([r.to(dtype) for r in row])
                if save_step(pstate, global_iter + i) is not None:
                    saves[i] = save_row
        errors, gnorms, valids = rows.cpu().numpy()
        n_valid = int(np.sum(valids > 0.5))
        if n_valid:
            meter.tick(n_valid)
        all_errors.append(errors[:n_valid])
        for j in range(n_valid):
            _log_row(pstate, global_iter + j, float(errors[j]),
                     float(gnorms[j]))
        _save_rows(pstate, {i: row for i, row in saves.items()
                            if i < n_valid}, global_iter, errors,
                   evolved, collect_fn)
        global_iter += n_valid
        iterations_left -= length
        if pstate.should_save:
            snap = {RESUME_PARAMS: params, RESUME_ITERATION:
                    np.asarray(global_iter)}
            snap.update({opt_key(name): leaf
                         for name, leaf in opt_state.items()})
            _snapshot_optimizer(pstate, snap)
        if bool(done):
            break

    if global_iter == iteration_start:
        # Nothing ran: fill the result from one evaluation of the current
        # params instead of returning the sentinel best.
        _log_unrun(pstate, iteration_start, resume_state)
        error0, states0, clipped0, _ = evaluate(params)
        _fill_unrun(result, evolved, iteration_start,
                    slap_controls(cc, clipped0.cpu().numpy(), shape),
                    float(error0), states0.cpu().numpy())
        return

    result.best_controls = slap_controls(
        cc, best["controls_flat"].cpu().numpy(), shape)
    result.best_error = float(best["error"])
    setattr(result, "best_final_" + evolved,
            best["final_states"].cpu().numpy())
    result.best_iteration = int(best["iteration"])
    result.iteration_count_ran = global_iter - iteration_start
    result.iterations_per_s = meter.steady_rate
    result.iterations_per_s_mean = meter.mean_rate
    result.errors = np.concatenate(all_errors)


def _save_rows(pstate, saves, first, errors, evolved, collect_fn):
    """Write a chunk's save rows ``saves`` ({chunk index: (clipped params,
    grads, final evolved)} on the device) to the save file: one pull of
    them all, one locked write, then the intermediate stack of each row
    (``collect_fn``, the trajectory form)."""
    if not saves:
        return
    cc, shape = pstate.complex_controls, pstate.controls_shape
    order = sorted(saves)
    controls, grads, finals = (torch.stack(x).cpu().numpy() for x in
                               zip(*(saves[i] for i in order)))
    pstate.checkpointer.save_grape_rows(
        [(save_step(pstate, first + i), slap_controls(cc, c, shape),
          float(errors[i]), f, slap_controls(cc, g, shape))
         for i, c, g, f in zip(order, controls, grads, finals)],
        "final_" + evolved)
    if collect_fn is not None:
        for i in order:
            with torch.no_grad():
                stack = collect_fn(saves[i][0])
            _save_intermediate(pstate, evolved)(first + i, stack)


def _log_row(pstate, iteration, error, grads_norm):
    if not pstate.should_log or iteration > pstate.final_iteration:
        return
    if (iteration % pstate.log_iteration_step == 0
            or iteration == pstate.final_iteration):
        print("{:^6d} | {:^1.8e} | {:^1.8e}".format(iteration, error,
                                                    grads_norm))
