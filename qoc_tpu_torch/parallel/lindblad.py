"""Ensemble-robust GRAPE and multistart for open systems, on one card.

Counterpart of ``qoc_tpu/parallel/lindblad.py``: the Lindblad twins of
``parallel/ensemble.py`` and ``parallel/multistart.py``. Every member (or
candidate x member) integrates the whole master equation, and the
optimized error is the members' mean. The dissipator data
(``lindblad_data``) is shared by all members.

Both entry points run the ensemble's chain loss (``parallel/ensemble.py``
``build_chain_loss``) on a Lindblad state. Under ``LindbladMethod.RKDP5``
(the default) every candidate x member is a lane of one adaptive
integration an interval (``core/lindblad.py`` ``rkdp5_loss``; plain torch,
float64 allowed on CUDA), each lane with its own mesh, as ``qoc_tpu``'s
generic route runs them under ``jax.vmap``. Under
``LindbladMethod.MAGNUS_EXPM`` the densities, vectorized row-major (K,
d²), propagate by the superoperator chain of dimension n = d², routed by n
as ``qoc_tpu`` routes its members:

- the fused route, for an :class:`EnsembleLinearHamiltonian` (or, in a
  plain multistart, a :class:`LinearHamiltonian`) with a
  :class:`ConstantLindblad` or no dissipation under Magnus-M2 with
  controls (``qoc_tpu``'s ``_fused_eligibility``, less its kernel test):
  the affine superoperator S(c, δ) = S0 + Σ_p δ_p S_p + Σ_i Re(c_i)
  S_{P_i} + Im(c_i) S_{Q_i} gives weight rows [1, δ_m, Re c, Im c] against
  ``superoperator_basis``; at d ≤ 8 (n ≤ 64) K1/K2's member axis, at
  d = 17...22 (256 < padded n ≤ 512) K6's member axis, one forward and
  one adjoint launch a time block for every chain;
- the blocked route, for everything else and for d = 9...16: each
  member's superoperator Magnus planes (``core/lindblad.py``
  ``superoperator_builder``) are built under ``torch.func.vmap`` over the
  candidates and member rows, and all planes go through the batched expm
  (K3/K4 up to padded n = 256, ``torch.matmul`` above 512).

Final density costs and the density step costs
(``TargetDensityInfidelityTime``, ``ForbidDensities``) run on every route,
the step costs through the trajectory form (the adjoint in its per-step
mode). ``qoc_tpu``'s fused Lindblad multistart drops the step costs
(``_make_fused_lindblad_shard_loss`` sums only the final costs); its
generic route and its fused ensemble keep them, and so does the port on
every route.

Save files and ``resume_from`` work as in the Schrödinger twins (the
ensemble's rows carry the member axis and ``hamiltonian_params``; with
``save_intermediate_densities`` the trajectory a save row). ``mesh`` is
not ported yet, and raises ``NotImplementedError`` naming its ROADMAP item
(Queue 1 item 8). As in the port's single-member Lindblad GRAPE, without
a save file ``save_intermediate_densities`` is ignored.
"""

from qoc_tpu_torch.config import resolve
from qoc_tpu_torch.core.common import initialize_controls
from qoc_tpu_torch.models import (GrapeLindbladDiscreteState,
                                  GrapeLindbladResult, InterpolationPolicy,
                                  LindbladMethod, MagnusPolicy)
from qoc_tpu_torch.optim import Adam
from qoc_tpu_torch.parallel._msrunner import validate_multistart_entry
from qoc_tpu_torch.parallel.ensemble import (build_ensemble_loss,
                                             refuse_mesh, run_ensemble)
from qoc_tpu_torch.parallel.multistart import run_chain_multistart

__all__ = ["build_lindblad_ensemble_loss", "grape_lindblad_ensemble",
           "grape_lindblad_multistart"]


def build_lindblad_ensemble_loss(pstate, hamiltonian, hamiltonian_params,
                                 mesh=None, log_path=False,
                                 time_block_size=None, device=None,
                                 dtype=None):
    """The Lindblad ensemble loss (``qoc_tpu`` lindblad.py:120-190):
    controls (E, C) -> (mean_m error_m, final densities (M, K, d, d)),
    differentiable w.r.t. the controls. ``pstate`` is a
    :class:`GrapeLindbladDiscreteState` with ``method_`` (and
    ``magnus_policy_``, or RKDP5's ``atol``, ``rtol`` and
    ``rkdp5_max_steps``); ``hamiltonian(params_row, controls, t) -> (d, d)``
    is one member's Hamiltonian, one member a row of ``hamiltonian_params``.
    ``uses_fused_chain`` and ``route`` say which route it took (module
    docstring). ``device``/``dtype`` as the entry points'."""
    return build_ensemble_loss(pstate, hamiltonian, hamiltonian_params,
                               mesh=mesh, time_block_size=time_block_size,
                               log_path=log_path, device=device, dtype=dtype)


def _lindblad_pstate(method, magnus_policy, fused_chunk, rkdp5, *args):
    """The GRAPE state of the entry points: ``rkdp5`` (atol, rtol,
    rkdp5_max_steps) set on it as ``qoc_tpu`` sets them."""
    pstate = GrapeLindbladDiscreteState(*args)
    pstate.method_ = method
    pstate.atol, pstate.rtol, pstate.rkdp5_max_steps = rkdp5
    pstate.magnus_policy_ = magnus_policy
    pstate.fused_chunk = fused_chunk
    return pstate


def grape_lindblad_ensemble(control_count, control_eval_count, costs,
                            evolution_time, hamiltonian, hamiltonian_params,
                            initial_densities, system_eval_count,
                            complex_controls=False, cost_eval_step=1,
                            impose_control_conditions=None,
                            initial_controls=None,
                            interpolation_policy=InterpolationPolicy.LINEAR,
                            iteration_count=1000, lindblad_data=None,
                            log_iteration_step=10,
                            magnus_policy=MagnusPolicy.M2,
                            max_control_norms=None, mesh=None, min_error=0,
                            optimizer=None, resume_from=None,
                            save_file_path=None,
                            save_intermediate_densities=False,
                            save_iteration_step=0,
                            method=LindbladMethod.RKDP5, atol=1e-12,
                            rtol=0.0, rkdp5_max_steps=16384,
                            fused_chunk=None, fused_mode=None,
                            time_block_size=None, device=None, dtype=None):
    """Robust GRAPE over an ensemble of Hamiltonians with Lindblad dynamics
    (``qoc_tpu`` lindblad.py:334-443).

    The contract of :func:`grape_lindblad_discrete` except:
    ``hamiltonian(params_row, controls, time) -> (d, d)`` takes a member's
    parameter row first; ``hamiltonian_params`` (n_members, ...) holds one
    row per member, and the optimized error is the members' mean; the
    dissipator data is shared by all members. ``result.best_final_densities``
    is (n_members, K, d, d). ``atol``, ``rtol`` and ``rkdp5_max_steps`` are
    RKDP5's (the default method), ``fused_mode`` picks ``qoc_tpu``'s
    compiled loop form (the port has one loop). Save files, resume and
    refusals: module docstring."""
    refuse_mesh(mesh)
    device, dtype = resolve(device, dtype, float64_ok=(
        method != LindbladMethod.MAGNUS_EXPM))
    costs = list(costs)
    if optimizer is None:
        optimizer = Adam()
    initial_controls, max_control_norms = initialize_controls(
        complex_controls, control_count, control_eval_count, evolution_time,
        initial_controls, max_control_norms)
    pstate = _lindblad_pstate(
        method, magnus_policy, fused_chunk, (atol, rtol, rkdp5_max_steps),
        complex_controls, control_count,
        control_eval_count, cost_eval_step, costs, evolution_time, None,
        impose_control_conditions, initial_controls, initial_densities,
        interpolation_policy, iteration_count, lindblad_data,
        log_iteration_step, max_control_norms, min_error, optimizer,
        save_file_path, save_intermediate_densities, save_iteration_step,
        system_eval_count)
    return run_ensemble(pstate, hamiltonian, hamiltonian_params,
                        GrapeLindbladResult(), device, dtype,
                        time_block_size, evolved="densities",
                        resume_from=resume_from)


def grape_lindblad_multistart(control_count, control_eval_count, costs,
                              evolution_time, initial_densities,
                              system_eval_count, n_starts=8,
                              complex_controls=False, cost_eval_step=1,
                              hamiltonian=None, hamiltonian_params=None,
                              initial_controls=None,
                              interpolation_policy=InterpolationPolicy.LINEAR,
                              iteration_count=1000, lindblad_data=None,
                              log_iteration_step=10,
                              magnus_policy=MagnusPolicy.M2,
                              max_control_norms=None, mesh=None, min_error=0,
                              optimizer=None, resume_from=None,
                              save_file_path=None, save_iteration_step=0,
                              seed=0, method=LindbladMethod.RKDP5,
                              atol=1e-12, rtol=0.0, rkdp5_max_steps=16384,
                              fused_chunk=None, fused_mode=None, device=None,
                              dtype=None):
    """Optimize ``n_starts`` pulse candidates of a Lindblad GRAPE problem in
    parallel and return the best (``qoc_tpu`` lindblad.py:450-599; the
    open-system twin of :func:`grape_schroedinger_multistart`, sharing its
    runner, ``parallel/_msrunner.py``).

    With ``hamiltonian_params`` (n_members, P) and an ensemble-contract
    ``hamiltonian(params_row, controls, t)`` each candidate optimizes the
    ensemble-mean error (robust multistart). Returns a
    ``GrapeLindbladResult`` for the winner, with ``result.errors`` every
    candidate's best error, ``result.iterations_per_s`` the steady
    candidate-iteration rate and ``best_final_densities`` (K, d, d), or
    (n_members, K, d, d) for a robust multistart. Save files, resume and
    refusals: module docstring, and a host-loop-only optimizer (LBFGSB)
    with ``ValueError``."""
    refuse_mesh(mesh)
    device, dtype = resolve(device, dtype, float64_ok=(
        method != LindbladMethod.MAGNUS_EXPM))
    costs = list(costs)
    if optimizer is None:
        optimizer = Adam()
    validate_multistart_entry(optimizer, "grape_lindblad_multistart",
                              hamiltonian, hamiltonian_params)
    base_controls, max_control_norms = initialize_controls(
        complex_controls, control_count, control_eval_count, evolution_time,
        initial_controls, max_control_norms)
    pstate = _lindblad_pstate(
        method, magnus_policy, fused_chunk, (atol, rtol, rkdp5_max_steps),
        complex_controls, control_count,
        control_eval_count, cost_eval_step, costs, evolution_time,
        hamiltonian, None, base_controls, initial_densities,
        interpolation_policy, iteration_count, lindblad_data,
        log_iteration_step, max_control_norms, min_error, optimizer,
        save_file_path, False, save_iteration_step, system_eval_count)
    return run_chain_multistart(pstate, hamiltonian, hamiltonian_params,
                                n_starts, seed, GrapeLindbladResult(),
                                device, dtype, evolved="densities",
                                resume_from=resume_from)
