"""Multi-start GRAPE: many pulse candidates optimized in parallel on one
card.

Counterpart of ``qoc_tpu/parallel/multistart.py``. The candidate axis is a
batch dimension: every candidate carries its own controls and Adam state,
the whole iteration runs on the device for all of them
(``parallel/_msrunner.py``), and the best candidate wins. With
``hamiltonian_params`` each candidate optimizes the ensemble-mean error of
the members (robust multistart).

Propagation is the ensemble's chain loss (``parallel/ensemble.py``) over
candidates x members, candidate-major (``qoc_tpu``'s ``jnp.repeat`` at
multistart.py:439): for a ``LinearHamiltonian`` or an
``EnsembleLinearHamiltonian`` under Magnus-M2 every chain goes through a
chain op's member axis, one K1 and one K2 launch a time block for all
chains at d <= 64, one K6 forward and one K6 adjoint at 256 < padded d <=
512 (step costs through the trajectory form, the adjoint per step);
anything else takes the blocked route, all chains' planes in one K3/K4
batch a time block. :func:`run_chain_multistart` is the body it shares with
the Lindblad multistart (``parallel/lindblad.py``), save file and resume
included (``parallel/_msrunner.py``). ``qoc_tpu`` shards the candidates
over a mesh; on one card ``mesh`` other than None raises (ROADMAP Queue 1,
item 8).
"""

import numpy as np
import torch

from qoc_tpu_torch.config import resolve
from qoc_tpu_torch.core.common import initialize_controls, slap_controls_torch
from qoc_tpu_torch.io.resume import apply_resume
from qoc_tpu_torch.models import (GrapeSchroedingerDiscreteState,
                                  GrapeSchroedingerResult,
                                  InterpolationPolicy, MagnusPolicy)
from qoc_tpu_torch.optim import Adam
from qoc_tpu_torch.parallel._msrunner import (run_multistart,
                                              validate_multistart_entry)
from qoc_tpu_torch.parallel.ensemble import (build_chain_loss,
                                             describe_route, refuse_mesh)

__all__ = ["grape_schroedinger_multistart", "run_chain_multistart"]


def grape_schroedinger_multistart(control_count, control_eval_count, costs,
                                  evolution_time, hamiltonian,
                                  initial_states, system_eval_count,
                                  n_starts=8, complex_controls=False,
                                  cost_eval_step=1,
                                  hamiltonian_params=None,
                                  initial_controls=None,
                                  interpolation_policy=InterpolationPolicy.LINEAR,
                                  iteration_count=1000,
                                  log_iteration_step=10,
                                  magnus_policy=MagnusPolicy.M2,
                                  max_control_norms=None, mesh=None,
                                  min_error=0, optimizer=None,
                                  resume_from=None, save_file_path=None,
                                  save_iteration_step=0, seed=0,
                                  fused_chunk=None, device=None, dtype=None):
    """Optimize ``n_starts`` pulse candidates in parallel and return the
    best (``qoc_tpu`` multistart.py:57-223).

    Candidate 0 starts from the flat initial controls (or
    ``initial_controls``), the others from white noise (seeds ``seed + i``).
    With ``hamiltonian_params`` (n_members, P) and an ensemble-contract
    ``hamiltonian(params_row, controls, t)`` (e.g. an
    :class:`EnsembleLinearHamiltonian`) each candidate optimizes the
    ensemble-mean error. ``min_error`` freezes a candidate that reaches it
    and stops the run at the end of that chunk of ``fused_chunk``
    iterations. ``device``/``dtype`` as :func:`grape_schroedinger_discrete`'s.

    Returns a ``GrapeSchroedingerResult`` for the winner, with
    ``result.errors`` every candidate's best error and
    ``result.iterations_per_s`` the steady candidate-iteration rate.
    ``save_file_path`` with ``save_iteration_step`` writes ``qoc_tpu``'s
    file: each save iteration's best candidate a row (its final states
    (n_members, K, d, 1) and ``hamiltonian_params`` for a robust
    multistart), and the candidate carry at every chunk's end, which
    ``resume_from`` (a multistart file, the same ``n_starts``) restores.
    One card: ``mesh`` other than None raises (ROADMAP Queue 1, item 8); a
    host-loop-only optimizer (LBFGSB) raises ``ValueError``."""
    refuse_mesh(mesh)
    device, dtype = resolve(device, dtype)
    costs = list(costs)
    if optimizer is None:
        optimizer = Adam()
    validate_multistart_entry(optimizer, "grape_schroedinger_multistart",
                              hamiltonian, hamiltonian_params)
    base_controls, max_control_norms = initialize_controls(
        complex_controls, control_count, control_eval_count, evolution_time,
        initial_controls, max_control_norms)
    pstate = GrapeSchroedingerDiscreteState(
        complex_controls, control_count, control_eval_count, cost_eval_step,
        costs, evolution_time, hamiltonian, None, base_controls,
        initial_states, interpolation_policy, iteration_count,
        log_iteration_step, max_control_norms, magnus_policy, min_error,
        optimizer, save_file_path, False, save_iteration_step,
        system_eval_count)
    pstate.fused_chunk = fused_chunk
    return run_chain_multistart(pstate, hamiltonian, hamiltonian_params,
                                n_starts, seed, GrapeSchroedingerResult(),
                                device, dtype, resume_from=resume_from)


def run_chain_multistart(pstate, hamiltonian, hamiltonian_params, n_starts,
                         seed, result, device, dtype, evolved="states",
                         resume_from=None):
    """The multistart on a GRAPE state: the chain loss over candidates x
    members (``parallel/ensemble.py``), the runner
    (``parallel/_msrunner.py``) and one forward of the winner for its
    final states, or densities (``evolved="densities"``), per member for a
    robust multistart; the save file and ``resume_from``; the body of
    :func:`grape_schroedinger_multistart` and of
    ``grape_lindblad_multistart``."""
    ensemble = hamiltonian_params is not None
    if ensemble:
        pstate.set_ensemble(hamiltonian_params)
    if resume_from is not None:
        apply_resume(pstate, resume_from)
    if pstate.should_save:
        if pstate.checkpointer._writes_enabled:
            print("QOC is saving this optimization run to {}."
                  "".format(pstate.save_file_path))
        if not getattr(pstate, "resuming_same_file", False):
            pstate.checkpointer.create_grape_file(pstate,
                                                  pstate._save_count())
    chain_loss = build_chain_loss(
        pstate, hamiltonian, hamiltonian_params, device, dtype,
        n_candidates=n_starts)
    n_members = 1 if not ensemble else np.asarray(
        hamiltonian_params).shape[0]
    if pstate.should_log:
        path, kernels, packing = describe_route(chain_loss, device,
                                                n_starts * n_members)
        print("qoc_tpu_torch: {}multistart propagation path = {}, {} "
              "(candidate{}-batched: {}, block={}).".format(
                  "Lindblad " if chain_loss.lindblad else "", path, kernels,
                  " x member" if ensemble else "", packing,
                  chain_loss.block))
    cc, shape = pstate.complex_controls, pstate.controls_shape
    slap = torch.func.vmap(lambda p: slap_controls_torch(cc, p, shape))

    def loss_sum(clipped_flat):
        errors = chain_loss(slap(clipped_flat))[0].mean(dim=1)
        return errors.sum(), errors

    def winner_states(clipped_flat):
        """Final states (R, [M,] ...) of R candidates' clipped params, in
        one forward (the save rows)."""
        with torch.no_grad():
            final = chain_loss(slap(clipped_flat))[1]
        return final if ensemble else final[:, 0]

    winning_flat = run_multistart(pstate, result, loss_sum, n_starts, device,
                                  dtype, seed=seed,
                                  winner_states=winner_states,
                                  evolved=evolved)
    # One forward of the winner gives its final states (per member for a
    # robust multistart).
    with torch.no_grad():
        flat = torch.as_tensor(winning_flat, dtype=dtype, device=device)
        final = chain_loss(slap(flat[None]))[1][0]
    setattr(result, "best_final_" + evolved,
            (final if ensemble else final[0]).cpu().numpy())
    return result
