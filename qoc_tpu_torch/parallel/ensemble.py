"""Ensemble-robust GRAPE on one card.

Counterpart of ``qoc_tpu/parallel/ensemble.py``. Every ensemble member (a
Hamiltonian parameter row: detuning, amplitude miscalibration, ...) rolls
out the whole propagation, the optimized error is the members' mean, and
one optimizer step updates the shared controls. ``qoc_tpu`` shards the
members over a device mesh; the port runs them all on one card, so
``mesh`` other than None raises (ROADMAP Queue 1, item 8).

Two routes, chosen by the problem alone as ``qoc_tpu`` chooses them:

- the fused route, for an :class:`EnsembleLinearHamiltonian` under
  Magnus-M2 with controls at d <= 64: member m's weight rows are
  [1, δ_m, Re c, Im c] against the shared generator basis
  [h0, param_ops..., P_i, Q_i], and all members' chains go through the
  chain op's member axis (``ops/chain.py``), one K1 and one K2 launch a
  time block on the card;
- the blocked route, for everything else (Magnus M4/M6, any torch
  callable ``hamiltonian(params_row, controls, t)``, and 64 < padded d):
  each member's Magnus planes are built under ``torch.func.vmap`` over the
  member rows, and all members' planes reach the batched expm (K3/K4 up to
  padded d = 256) as one batch a time block, then a tree product (or the
  prefix scan with step costs) per member. This is ``qoc_tpu``'s generic
  route (``allow_plane_chain=False`` under ``vmap``).

At 256 < padded d <= 512 ``qoc_tpu`` runs K6's member axis on the fused
route; the port raises there (ROADMAP Queue 2, item 4).

The same chain loss carries the multistart (``parallel/multistart.py``):
candidates x members, candidate-major, are the chains of one call.
"""

import numpy as np
import torch

from qoc_tpu_torch.config import complex_dtype, resolve
from qoc_tpu_torch.core.common import initialize_controls, slap_controls_torch
from qoc_tpu_torch.core.graperunner import run_grape
from qoc_tpu_torch.core.schroedinger import (_not_ported, _route_names,
                                             _step_cost, cost_steps,
                                             fused_weights, make_propagator,
                                             plane_builder)
from qoc_tpu_torch.models import (EnsembleLinearHamiltonian,
                                  GrapeSchroedingerDiscreteState,
                                  GrapeSchroedingerResult,
                                  InterpolationPolicy, LinearHamiltonian,
                                  MagnusPolicy)
from qoc_tpu_torch.ops.chain import (KERNEL_DP, chain_block_plan,
                                     segment_plan, uses_stream)
from qoc_tpu_torch.optim import Adam

__all__ = ["build_chain_loss", "build_ensemble_loss",
           "grape_schroedinger_ensemble"]


def refuse_mesh(mesh):
    """The port runs on one card: a mesh raises, naming its ROADMAP
    item."""
    if mesh is not None:
        raise _not_ported("mesh (members or candidates sharded over "
                          "devices)", "6d, Queue 1 item 8")


def _fused_ok(pstate, hamiltonian, params):
    """True where the chain of weight rows against a basis applies:
    ``qoc_tpu``'s _build_fused_ensemble_loss / _make_fused_shard_loss
    conditions, less the kernel limits."""
    if (pstate.magnus_policy != MagnusPolicy.M2
            or pstate.control_eval_times is None):
        return False
    if params is None:
        return (isinstance(hamiltonian, LinearHamiltonian)
                and not isinstance(hamiltonian, EnsembleLinearHamiltonian))
    return (isinstance(hamiltonian, EnsembleLinearHamiltonian)
            and params.ndim == 2 and not np.iscomplexobj(params)
            and params.shape[1] == hamiltonian.param_count)


def _member_weights(w, delta):
    """Weight rows (N M, B, 1 + P + 2C), candidate-major, from the
    candidates' rows [1, Re c, Im c] (N, B, 1 + 2C) and the member rows
    ``delta`` (M, P): [1, δ_m, Re c, Im c] (``qoc_tpu``
    ensemble.py:212-231, multistart.py:404-414)."""
    if delta is None:
        return w
    (n, b, _), (m, p) = w.shape, delta.shape
    return torch.cat((
        w[:, None, :, :1].expand(n, m, b, 1),
        delta[None, :, None, :].expand(n, m, b, p),
        w[:, None, :, 1:].expand(n, m, b, w.shape[-1] - 1)),
        dim=-1).reshape(n * m, b, -1)


def build_chain_loss(pstate, hamiltonian, hamiltonian_params, device, dtype,
                     n_candidates=1, time_block_size=None):
    """The loss of N candidates' controls over M members, one chain each.

    ``hamiltonian_params`` (M, ...) are the member rows of an
    ensemble-contract ``hamiltonian(params_row, controls, t)``, or None for
    one member of a plain ``hamiltonian(controls, t)``. Returns
    ``loss(controls)``, which maps complex controls (N, E, C) to (errors
    (N, M), final states (N, M, K, d, 1)), differentiable; its ``route`` is
    "fused" or "blocked" (module docstring) and its ``block`` the time
    block in steps, sized for ``n_candidates`` (``chain_block_plan`` counts
    the N M chains)."""
    params = (None if hamiltonian_params is None
              else np.asarray(hamiltonian_params))
    cdtype = complex_dtype(dtype)
    initial_states = torch.as_tensor(np.asarray(pstate.initial_states),
                                     dtype=cdtype, device=device)
    d = initial_states.shape[-2]
    dt = float(pstate.dt)
    n_steps = pstate.system_eval_count - 1
    final_step = pstate.final_system_eval_step
    step_costs = pstate.step_costs
    final_costs = [cost for cost in pstate.costs
                   if not cost.requires_step_evaluation]
    cost_eval_step = pstate.cost_eval_step
    trajectory = bool(step_costs)
    n_members = 1 if params is None else params.shape[0]
    times = torch.arange(n_steps, dtype=dtype, device=device) * dt
    cet = (torch.as_tensor(pstate.control_eval_times, dtype=dtype,
                           device=device)
           if pstate.control_eval_times is not None else None)
    fused = _fused_ok(pstate, hamiltonian, params)
    if fused and uses_stream(d):
        raise _not_ported("The member axis of the streamed chain (K6, "
                          "256 < padded d <= 512)", "Queue 2, item 4")
    trajectory_steps = n_steps if trajectory else 0
    if fused and d <= KERNEL_DP:
        route = "fused"
        delta = (None if params is None
                 else torch.as_tensor(params, dtype=dtype, device=device))
        propagate, planes_per_step = make_propagator(
            route, pstate.magnus_policy, device, dtype,
            basis=hamiltonian.generator_basis(dt),
            weights=lambda controls, t_block: _member_weights(
                fused_weights(controls, t_block, cet, dt), delta),
            trajectory_steps=trajectory_steps)
    else:
        route = "blocked"
        planes = _member_planes(pstate, hamiltonian, params, cet, dt,
                                device, dtype)
        propagate, planes_per_step = make_propagator(
            route, pstate.magnus_policy, device, dtype, planes=planes,
            trajectory_steps=trajectory_steps)
    block = int(time_block_size or chain_block_plan(
        d, n_steps, cdtype.itemsize, planes_per_step,
        n_candidates * n_members))

    def loss(controls):
        n = controls.shape[0]
        # Each chain's controls, candidate-major (the costs take them).
        chain_controls = controls.repeat_interleave(n_members, dim=0)
        states = initial_states.expand((n * n_members,)
                                       + initial_states.shape)
        errors = torch.zeros((n * n_members,), dtype=dtype, device=device)
        for start in range(0, n_steps, block):
            out = propagate(controls, times[start:start + block])
            if not trajectory:
                states = out[:, None] @ states
                continue
            prod, prefixes = out
            steps = cost_steps(start, prefixes.shape[-3], cost_eval_step,
                               device)
            if steps is not None:
                sel, ks = steps
                # The states after the block's cost steps, every chain:
                # (R, steps, K, d, 1).
                evolved = prefixes[:, sel, None] @ states[:, None]
                errors = errors + torch.func.vmap(
                    lambda c, x: torch.func.vmap(_step_cost(
                        step_costs, c))(x, ks).sum())(chain_controls,
                                                      evolved)
            states = prod[:, None] @ states
        if final_costs:
            errors = errors + torch.func.vmap(
                lambda c, x: _step_cost(final_costs, c)(x, final_step))(
                    chain_controls, states)
        return (errors.reshape(n, n_members),
                states.reshape((n, n_members) + initial_states.shape))

    loss.route, loss.block = route, block
    return loss


def _member_planes(pstate, hamiltonian, params, cet, dt, device, dtype):
    """planes(controls (N, E, C), t_block) -> (N M, B, d, d): every
    candidate's and member's Magnus planes, built under ``torch.func.vmap``
    over the candidates and the member rows (``core/schroedinger.py``
    plane_builder)."""
    policy = pstate.magnus_policy
    if params is None:
        build = plane_builder(hamiltonian, policy, cet, dt)

        def planes(controls, t_block):
            return torch.func.vmap(lambda c: build(c, t_block))(controls)
        return planes
    rows = torch.as_tensor(params, device=device,
                           dtype=(complex_dtype(dtype)
                                  if np.iscomplexobj(params) else dtype))

    def member(row, c, t_block):
        return plane_builder(lambda cc, tt: hamiltonian(row, cc, tt),
                             policy, cet, dt)(c, t_block)

    def planes(controls, t_block):
        out = torch.func.vmap(lambda c: torch.func.vmap(
            lambda row: member(row, c, t_block))(rows))(controls)
        return out.reshape((-1,) + out.shape[2:])
    return planes


def describe_route(route, d, device, n_chains, n_steps, block, trajectory):
    """(path, kernels, packing) of a chain loss for the one-time path log:
    the fused route names its packing, grouped (one segment a chain) or
    segmented (S_m segments a chain)."""
    path, kernels = _route_names(route, d, device, trajectory)
    if route != "fused":
        return path, kernels, "{} chains in one batch".format(n_chains)
    s_count, length = segment_plan(min(block, n_steps), n_chains)
    packing = ("grouped, one segment a chain" if s_count == 1 else
               "segmented, {} segments a chain".format(s_count))
    return path, kernels, "{} chains, {} (S x L = {} x {})".format(
        n_chains, packing, n_chains * s_count, length)


def build_ensemble_loss(pstate, hamiltonian, hamiltonian_params, mesh=None,
                        time_block_size=None, log_path=False, device=None,
                        dtype=None):
    """The ensemble loss (``qoc_tpu`` ensemble.py:60-130): controls (E, C)
    -> (mean_m error_m, final states (M, K, d, 1)), differentiable w.r.t.
    the controls. ``hamiltonian(params_row, controls, t) -> (d, d)`` is one
    member's Hamiltonian (a torch callable, or an
    :class:`EnsembleLinearHamiltonian`), one member a row of
    ``hamiltonian_params``. The loss's ``uses_fused_chain`` says which
    route it took (module docstring). ``device``/``dtype`` as the entry
    points' (default the card in float32); ``block`` is its time block in
    steps."""
    refuse_mesh(mesh)
    device, dtype = resolve(device, dtype)
    params = np.asarray(hamiltonian_params)
    if params.ndim < 1 or params.shape[0] < 1:
        raise ValueError("hamiltonian_params must hold one row per member; "
                         "got shape {}".format(params.shape))
    chain_loss = build_chain_loss(pstate, hamiltonian, params, device, dtype,
                                  time_block_size=time_block_size)
    if log_path:
        d = np.asarray(pstate.initial_states).shape[-2]
        path, kernels, packing = describe_route(
            chain_loss.route, d, device, params.shape[0],
            pstate.system_eval_count - 1, chain_loss.block,
            bool(pstate.step_costs))
        print("qoc_tpu_torch: ensemble propagation path = {}, {} "
              "(member-batched: {}, block={}).".format(
                  path, kernels, packing, chain_loss.block))

    def loss(controls):
        errors, states = chain_loss(controls[None])
        return errors[0].mean(), states[0]

    loss.uses_fused_chain = chain_loss.route == "fused"
    loss.block = chain_loss.block
    return loss


def grape_schroedinger_ensemble(control_count, control_eval_count, costs,
                                evolution_time, hamiltonian,
                                hamiltonian_params, initial_states,
                                system_eval_count, complex_controls=False,
                                cost_eval_step=1,
                                impose_control_conditions=None,
                                initial_controls=None,
                                interpolation_policy=InterpolationPolicy.LINEAR,
                                iteration_count=1000, log_iteration_step=10,
                                magnus_policy=MagnusPolicy.M2,
                                max_control_norms=None, mesh=None,
                                min_error=0, optimizer=None, resume_from=None,
                                save_file_path=None,
                                save_intermediate_states=False,
                                save_iteration_step=0, time_block_size=None,
                                fused_chunk=None, device=None, dtype=None):
    """Robust GRAPE over an ensemble of Hamiltonians (``qoc_tpu``
    ensemble.py:296-400).

    The contract of :func:`grape_schroedinger_discrete` except:
    ``hamiltonian(params_row, controls, time) -> (d, d)`` takes a member's
    parameter row first; ``hamiltonian_params`` (n_members, ...) holds one
    row per member, and the optimized error is the members' mean.
    ``result.best_final_states`` is (n_members, K, d, 1). One card:
    ``mesh`` other than None raises (ROADMAP Queue 1, item 8), as do the
    save file, ``resume_from`` and ``impose_control_conditions`` (items 7
    and 5); ``optimizer=None`` is a fresh ``Adam()``, the port's only
    optimizer."""
    refuse_mesh(mesh)
    if impose_control_conditions is not None:
        raise _not_ported("impose_control_conditions (the host loop)",
                          "3, Queue 1 item 5")
    if resume_from is not None:
        raise _not_ported("resume_from", "4, Queue 1 item 7")
    device, dtype = resolve(device, dtype)
    costs = list(costs)
    if optimizer is None:
        optimizer = Adam()
    initial_controls, max_control_norms = initialize_controls(
        complex_controls, control_count, control_eval_count, evolution_time,
        initial_controls, max_control_norms)
    pstate = GrapeSchroedingerDiscreteState(
        complex_controls, control_count, control_eval_count, cost_eval_step,
        costs, evolution_time, None, impose_control_conditions,
        initial_controls, initial_states, interpolation_policy,
        iteration_count, log_iteration_step, max_control_norms,
        magnus_policy, min_error, optimizer, save_file_path,
        save_intermediate_states, save_iteration_step, system_eval_count)
    pstate.set_ensemble(hamiltonian_params)
    pstate.fused_chunk = fused_chunk
    loss_controls = build_ensemble_loss(pstate, hamiltonian,
                                        hamiltonian_params,
                                        time_block_size=time_block_size,
                                        log_path=pstate.should_log,
                                        device=device, dtype=dtype)
    pstate.log_and_save_initial()
    result = GrapeSchroedingerResult()
    shape = pstate.controls_shape

    def loss_flat(flat_params):
        return loss_controls(
            slap_controls_torch(complex_controls, flat_params, shape))

    run_grape(pstate, result, loss_flat, device, dtype)
    return result
