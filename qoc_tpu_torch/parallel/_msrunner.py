"""The multistart optimization loop, on device.

Counterpart of ``qoc_tpu/parallel/_msrunner.py``: every candidate carries
its own controls and optimizer state (Adam's, LBFGS's, or SGD's none),
and each iteration (clip, loss and gradient of all candidates, update) runs
on the card for the whole batch.
The candidates' errors and gradients come from one backward of the sum of
their errors (candidates are independent, so d(Σ_c err_c)/d(params_c') is
d err_c'/d params_c'). As in ``core/graperunner.py`` the per-iteration
rows (errors, active flags) stay on the device and are pulled to the host
once a chunk (``fused_chunk`` iterations), for the log and the rate meter.

Semantics of ``qoc_tpu``'s runner: candidate 0 starts from the flat
initial controls (or the given ones), the rest from white noise; controls
are clipped to ``max_control_norms`` outside the differentiation; a
candidate whose error reaches ``min_error`` is frozen (its parameters and
Adam state kept) and the run stops at the end of that chunk when
``min_error > 0``; each candidate's best error and clipped controls are
tracked, and the winner is the best of them. Every update is also given
all candidates' clip-projected loss, which only the line search of an
optimizer that ``needs_loss`` (LBFGS) calls, one batched forward a rung; frozen candidates ride through the
ladder too, and the freeze discards their step.

Save files and resume, as ``qoc_tpu``'s runner writes and reads them: on
a save iteration the row of that iteration's best candidate (its clipped
controls, error and gradients stay on the device until the chunk's pull;
its final states or densities come from one batched forward of a chunk's
winners, ``winner_states``); with ``save_file_path`` the whole candidate
carry (params, the per-candidate optimizer state, done flags, best errors,
controls and iterations, the next iteration) is snapshotted at every
chunk's end under ``checkpoint_kind`` ``multistart:<Optimizer>``, and
``pstate.resume_state`` restores it, so a resumed run repeats the
uninterrupted one from that chunk boundary on. A single-run checkpoint,
or one with another candidate count, is refused.
"""

import numpy as np
import torch

from qoc_tpu_torch.core.common import (clip_control_norms_torch,
                                       gen_controls_white, slap_controls,
                                       slap_controls_torch, strip_controls,
                                       strip_controls_torch)
from qoc_tpu_torch.core.graperunner import (RESUME_ITERATION, RESUME_KIND,
                                            RESUME_PARAMS, checkpoint_kind,
                                            opt_key, restore_tensors)
from qoc_tpu_torch.models import EnsembleLinearHamiltonian
from qoc_tpu_torch.models.programstate import save_step
from qoc_tpu_torch.profiler import RateMeter, trace_annotation

__all__ = ["candidate_seeds", "run_multistart", "validate_multistart_entry"]

_DEFAULT_CHUNK = 100

# The multistart's checkpoint keys beside the single run's (qoc_tpu
# _msrunner.py).
_MS_DONE = "ms_done"
_MS_BEST_ERR = "ms_best_err"
_MS_BEST_FLAT = "ms_best_flat"
_MS_BEST_ITER = "ms_best_iter"


def validate_multistart_entry(optimizer, entry_name, hamiltonian=None,
                              hamiltonian_params=None):
    """Fail fast on an optimizer without a device update (every candidate
    updates on the card; ``qoc_tpu``'s ValueError) and on an
    ensemble-contract Hamiltonian used without member parameters."""
    if not getattr(optimizer, "supports_fused", False):
        raise ValueError(
            "{} requires an optimizer with a device update rule "
            "(optimizer.supports_fused, e.g. Adam/SGD/LBFGS): every "
            "candidate's update runs on the device. {} is host-loop only — "
            "run it through {} per candidate instead.".format(
                entry_name, type(optimizer).__name__,
                entry_name.replace("_multistart", "_discrete")))
    if (isinstance(hamiltonian, EnsembleLinearHamiltonian)
            and hamiltonian_params is None):
        raise ValueError(
            "{}: an EnsembleLinearHamiltonian takes (params_row, controls, "
            "time) and needs hamiltonian_params=(n_members, {}) member rows; "
            "pass hamiltonian_params or use a plain LinearHamiltonian."
            "".format(entry_name, hamiltonian.param_count))


def candidate_seeds(pstate, n_starts, seed):
    """(n_starts, n_flat) float64: candidate 0 the initial controls, the
    rest white-noise seeds, ``gen_controls_white`` with seed + i
    (``qoc_tpu`` _msrunner.py:94-106)."""
    cc = pstate.complex_controls
    mcn = np.asarray(pstate.max_control_norms)
    seeds = [strip_controls(cc, np.asarray(pstate.initial_controls))]
    for i in range(1, n_starts):
        noise = gen_controls_white(cc, pstate.control_count,
                                   pstate.control_eval_count,
                                   pstate.evolution_time, mcn, seed=seed + i)
        seeds.append(strip_controls(cc, noise))
    return np.stack(seeds).astype(np.float64)


def _resume_carry(pstate, n_starts, carry):
    """(carry, iteration to start at) from ``pstate.resume_state``, or the
    fresh ``carry`` and 0."""
    resume_state = getattr(pstate, "resume_state", None)
    if resume_state is None:
        return carry, 0
    kind = checkpoint_kind(resume_state)
    if ((kind or "").startswith("single")
            or _MS_BEST_ERR not in resume_state):
        raise ValueError(
            "resume_from file holds a single-run checkpoint, not a "
            "multistart one — resume it through the single-run entry point "
            "or start the multistart fresh.")
    params, opt_state, done, best_err, best_flat, best_iter, it = carry
    if np.shape(resume_state[RESUME_PARAMS])[0] != n_starts:
        raise ValueError(
            "resume_from checkpoint has {} candidates; this call asks for "
            "n_starts={}.".format(np.shape(resume_state[RESUME_PARAMS])[0],
                                  n_starts))
    keys = {name: opt_key(name) for name in opt_state}
    if not all(key in resume_state for key in keys.values()):
        raise ValueError("resume_from checkpoint is missing optimizer-state "
                         "leaves (was it written by a different optimizer?)")
    fixed = restore_tensors(
        {RESUME_PARAMS: params, _MS_DONE: done, _MS_BEST_ERR: best_err,
         _MS_BEST_FLAT: best_flat, _MS_BEST_ITER: best_iter}, resume_state,
        {key: key for key in (RESUME_PARAMS, _MS_DONE, _MS_BEST_ERR,
                              _MS_BEST_FLAT, _MS_BEST_ITER)})
    start = int(np.asarray(resume_state[RESUME_ITERATION]))
    return (fixed[RESUME_PARAMS], restore_tensors(opt_state, resume_state,
                                                  keys),
            fixed[_MS_DONE], fixed[_MS_BEST_ERR], fixed[_MS_BEST_FLAT],
            fixed[_MS_BEST_ITER], torch.full_like(it, start)), start


def _snapshot(pstate, carry, next_iteration):
    """Write the candidate carry to the save file's optimizer_state."""
    params, opt_state, done, best_err, best_flat, best_iter, _ = carry
    snap = {RESUME_KIND: np.bytes_(
                "multistart:" + type(pstate.optimizer).__name__),
            RESUME_PARAMS: params,
            RESUME_ITERATION: np.asarray(next_iteration),
            _MS_DONE: done, _MS_BEST_ERR: best_err,
            _MS_BEST_FLAT: best_flat,
            # qoc_tpu's dtype for the iterations.
            _MS_BEST_ITER: best_iter.to(torch.int32)}
    snap.update({opt_key(name): leaf for name, leaf in opt_state.items()})
    pstate.checkpointer.save_optimizer_state(snap)


def _save_winner_rows(pstate, winners, first, winner_states, evolved):
    """The save rows of a chunk: ``winners`` {chunk index: (error, clipped
    params, grads)} of each save iteration's best candidate, on the device;
    one pull, one batched forward for their final states or densities and
    one locked write."""
    cc, shape = pstate.complex_controls, pstate.controls_shape
    order = sorted(winners)
    errors, flats, grads = (torch.stack(x) for x in
                            zip(*(winners[i] for i in order)))
    finals = winner_states(flats).cpu().numpy()
    errors, flats, grads = (x.cpu().numpy() for x in (errors, flats, grads))
    pstate.checkpointer.save_grape_rows(
        [(save_step(pstate, first + i), slap_controls(cc, f, shape),
          float(e), final, slap_controls(cc, g, shape))
         for i, e, f, g, final in zip(order, errors, flats, grads, finals)],
        "final_" + evolved)


def run_multistart(pstate, result, loss_sum, n_starts, device, dtype,
                   seed=0, winner_states=None, evolved="states"):
    """Run the candidate-batch optimization described by ``pstate``.

    ``loss_sum`` maps clipped flat candidate params (N, n_flat), a tensor
    that requires grad, to (Σ_c err_c, errors (N,)). Fills
    ``result.best_controls/best_error/best_iteration/errors/
    iteration_count_ran/iterations_per_s`` (the steady rate of
    candidate-iterations, frozen candidates not counted) and returns the
    winner's flat params (numpy). ``winner_states`` maps clipped flat
    params (R, n_flat) to their final ``evolved`` (R, ...), for the save
    rows (module docstring)."""
    optimizer = pstate.optimizer
    cc, shape = pstate.complex_controls, pstate.controls_shape
    mcn = torch.as_tensor(np.asarray(pstate.max_control_norms), dtype=dtype,
                          device=device)
    min_error = pstate.min_error
    slap = torch.func.vmap(lambda p: slap_controls_torch(cc, p, shape))
    strip = torch.func.vmap(lambda c: strip_controls_torch(cc, c))

    params = torch.as_tensor(candidate_seeds(pstate, n_starts, seed),
                             dtype=dtype, device=device)
    opt_state = optimizer.init_state_batch(params)
    done = torch.zeros((n_starts,), dtype=torch.bool, device=device)
    best_err = torch.full((n_starts,), torch.finfo(dtype).max, dtype=dtype,
                          device=device)
    best_flat = torch.zeros_like(params)
    best_iter = torch.zeros((n_starts,), dtype=torch.int64, device=device)
    it = torch.zeros((), dtype=torch.int64, device=device)

    def batch_projected_loss(params_batch):
        """(N, n_flat) candidate params -> (N,) clip-projected losses: the
        line search's view for ``needs_loss`` optimizers."""
        return loss_sum(strip(clip_control_norms_torch(slap(params_batch),
                                                       mcn)))[1]

    def iteration_step(params, opt_state, done, best_err, best_flat,
                       best_iter, it):
        clipped_flat = strip(clip_control_norms_torch(slap(params), mcn))
        clipped_flat = clipped_flat.detach().requires_grad_(True)
        total, errors = loss_sum(clipped_flat)
        grads, = torch.autograd.grad(total, clipped_flat)
        errors, clipped_flat = errors.detach(), clipped_flat.detach()
        new_done = done | (errors <= min_error)
        opt_state, params = optimizer.update_batch(
            opt_state, grads, params, new_done, errors, batch_projected_loss)
        valid = ~done
        improved = valid & (errors < best_err)
        best_err = torch.where(improved, errors, best_err)
        best_flat = torch.where(improved[:, None], clipped_flat, best_flat)
        best_iter = torch.where(improved, it, best_iter)
        return (params, opt_state, new_done, best_err, best_flat, best_iter,
                it + 1), (errors, valid.to(dtype)), (errors, clipped_flat,
                                                     grads)

    carry, iteration_start = _resume_carry(
        pstate, n_starts,
        (params, opt_state, done, best_err, best_flat, best_iter, it))
    chunk = int(pstate.fused_chunk or _DEFAULT_CHUNK)
    meter = RateMeter().start()
    iterations_left = max(0, pstate.iteration_count - iteration_start)
    iteration = iteration_start
    while iterations_left > 0:
        length = min(chunk, iterations_left)
        rows = torch.empty((2, length, n_starts), dtype=dtype, device=device)
        # Each save iteration's best candidate, on the device until the
        # chunk's pull.
        winners = {}
        with trace_annotation("qoc_tpu_torch.multistart.chunk"):
            for i in range(length):
                carry, row, evaluated = iteration_step(*carry)
                rows[:, i] = torch.stack(row)
                if save_step(pstate, iteration + i) is not None:
                    best = torch.argmin(evaluated[0])
                    winners[i] = tuple(x[best] for x in evaluated)
        err_rows, active_rows = rows.cpu().numpy()
        n_active = int(np.sum(active_rows > 0.5))
        if n_active:
            meter.tick(n_active)
        for j in range(length):
            _log_row(pstate, iteration + j, err_rows[j])
        if winners and winner_states is not None:
            _save_winner_rows(pstate, winners, iteration, winner_states,
                              evolved)
        iteration += length
        iterations_left -= length
        if pstate.save_file_path is not None:
            _snapshot(pstate, carry, iteration)
        if np.min(err_rows) <= min_error and min_error > 0:
            break

    best_err, best_flat, best_iter = (x.cpu().numpy() for x in carry[3:6])
    winner = int(np.argmin(best_err))
    result.best_controls = slap_controls(cc, best_flat[winner], shape)
    result.best_error = float(best_err[winner])
    result.best_iteration = int(best_iter[winner])
    result.errors = best_err
    result.iteration_count_ran = iteration - iteration_start
    result.iterations_per_s = meter.steady_rate
    result.iterations_per_s_mean = meter.mean_rate
    return best_flat[winner]


def _log_row(pstate, iteration, errors):
    if pstate.should_log and (iteration % pstate.log_iteration_step == 0
                              or iteration == pstate.iteration_count - 1):
        print("{:^6d} | best {:^1.8e} | median {:^1.8e}".format(
            iteration, float(np.min(errors)), float(np.median(errors))))
