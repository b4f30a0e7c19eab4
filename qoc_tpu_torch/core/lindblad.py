"""Lindblad master-equation evolution and GRAPE under Magnus-expm.

Counterpart of ``qoc_tpu/core/lindblad.py`` with
``method=LindbladMethod.MAGNUS_EXPM``: the densities are vectorized
(row-major, (K, d^2)), the Lindblad superoperator S of dimension d^2 is
built at the Magnus nodes of each step, and the steps' exponentials
propagate vec <- P vec through the Schrödinger path's machinery
(core/schroedinger.py ``make_propagator``), routed by d^2 as that path
routes d (``_route``):

- fused: a ``LinearHamiltonian`` with constant (``ConstantLindblad``) or no
  dissipation under M2 with controls is affine in [1, Re c, Im c], so its
  superoperators are weight rows against
  ``LinearHamiltonian.superoperator_basis``: at d^2 <= 64 (d <= 8) the
  chain op, K1/K2; at 256 < padded d^2 <= 512 (d = 17...22) the streamed
  route, K6;
- plane: any other problem at those sizes (Hamiltonian callables, M4/M6,
  time-dependent ``lindblad_data``): the superoperator Magnus planes of
  ``ops/lindblad.py`` through the plane chain op, K5 or K6;
- blocked: 64 < padded d^2 <= 256 (d = 9...16) on K3/K4, above 512 on
  ``torch.matmul``, and with ``allow_plane_chain=False`` where the plane
  route would apply.

A time-dependent ``lindblad_data`` is a torch callable ``t -> (rates (n,),
operators (n, d, d))``, evaluated under ``torch.func.vmap`` over the
Magnus nodes, as Hamiltonian callables are.

Density step costs and intermediate densities take the routes' trajectory
form, as the Schrödinger path's step costs do: the block's prefixes P_t
give the vectorized densities after every step, ``vec @ P_t^T``.

Not ported yet, and refused with ``NotImplementedError`` naming the ROADMAP
slice: ``LindbladMethod.RKDP5`` (``qoc_tpu``'s default, so a call that
leaves ``method`` out raises and names ``MAGNUS_EXPM``), save files (H5),
``impose_control_conditions`` (the host loop), resume and ``mesh``.
"""

import numpy as np
import torch

from qoc_tpu_torch.config import complex_dtype, resolve
from qoc_tpu_torch.core.common import initialize_controls, slap_controls_torch
from qoc_tpu_torch.core.graperunner import run_grape
from qoc_tpu_torch.core.schroedinger import (_MAGNUS, _not_ported, _route,
                                             _route_names, fused_weights,
                                             hamiltonian_sampler,
                                             make_propagator, step_cost_sum)
from qoc_tpu_torch.models import (ConstantLindblad, EvolveLindbladDiscreteState,
                                  EvolveLindbladResult,
                                  GrapeLindbladDiscreteState,
                                  GrapeLindbladResult, InterpolationPolicy,
                                  LindbladMethod, LinearHamiltonian,
                                  MagnusPolicy)
from qoc_tpu_torch.ops.chain import chain_block_plan
from qoc_tpu_torch.ops.lindblad import lindblad_superoperator
from qoc_tpu_torch.optim import Adam

__all__ = ["build_lindblad_loss", "evolve_lindblad_discrete",
           "grape_lindblad_discrete"]


def _check_method(method):
    if method != LindbladMethod.MAGNUS_EXPM:
        raise NotImplementedError(
            "method={} (the adaptive Dormand-Prince integrator, "
            "ops/rkdp5.py) is not ported to qoc_tpu_torch yet (ROADMAP "
            "slice 5, Queue 1 item 4); pass method=LindbladMethod.MAGNUS_EXPM, or use "
            "qoc_tpu.".format(method))


def superoperator_builder(hamiltonian, lindblad_data, magnus_policy,
                          control_eval_times, dt, hilbert_size, device,
                          cdtype):
    """planes(controls, times) -> (B, d^2, d^2): the Magnus term of each
    step's Lindblad superoperator for the step start times ``times`` (B,)
    (``qoc_tpu`` lindblad.py make_superop_generator). Constant dissipation
    is built once."""
    magnus = _MAGNUS[magnus_policy][0]
    hamiltonian_at = (hamiltonian_sampler(hamiltonian, control_eval_times)
                      if hamiltonian is not None else None)
    constant = lindblad_data is None or isinstance(lindblad_data,
                                                   ConstantLindblad)
    dissipation = None
    if isinstance(lindblad_data, ConstantLindblad):
        rates, operators = lindblad_data(0.0)
        if rates is not None and operators is not None:
            dissipation = lindblad_superoperator(
                torch.as_tensor(rates, device=device),
                operators=torch.as_tensor(operators, dtype=cdtype,
                                          device=device),
                hilbert_size=hilbert_size)

    def superoperator_at(controls, t):
        s = torch.zeros((hilbert_size ** 2,) * 2, dtype=cdtype,
                        device=device)
        if hamiltonian_at is not None:
            s = s + lindblad_superoperator(
                hamiltonian=hamiltonian_at(controls, t).to(cdtype),
                hilbert_size=hilbert_size)
        if constant:
            if dissipation is not None:
                s = s + dissipation
        else:
            rates, operators = torch.func.vmap(lindblad_data)(t)
            s = s + lindblad_superoperator(
                rates, operators=operators.to(cdtype),
                hilbert_size=hilbert_size)
        return torch.broadcast_to(s, t.shape + s.shape[-2:])

    def planes(controls, times):
        return magnus(lambda t: superoperator_at(controls, t), dt, times)

    return planes


def build_lindblad_loss(pstate, device, dtype, time_block_size=None,
                        log_path=False, allow_plane_chain=True,
                        collect_intermediates=False):
    """The loss: controls (a (E, C) tensor, or None) -> (error,
    final_densities), differentiable w.r.t. the controls; with
    ``collect_intermediates`` (error, final_densities,
    intermediate_densities), the densities at every system step, step 0
    included (system_eval_count, K, d, d).

    Mirrors ``qoc_tpu``'s build_lindblad_loss under
    ``LindbladMethod.MAGNUS_EXPM`` (reference
    _evaluate_lindblad_discrete, lindbladdiscrete.py:357-441) on the route
    of the module docstring, in the trajectory form where step costs or
    intermediate densities need it. ``pstate.method_`` and
    ``pstate.magnus_policy_`` carry the method and the Magnus order, as in
    ``qoc_tpu``."""
    _check_method(getattr(pstate, "method_", LindbladMethod.RKDP5))
    magnus_policy = getattr(pstate, "magnus_policy_", MagnusPolicy.M2)
    if pstate.interpolation_policy != InterpolationPolicy.LINEAR:
        raise NotImplementedError(
            "The interpolation policy {} is not yet supported for this "
            "method.".format(pstate.interpolation_policy))
    if magnus_policy not in _MAGNUS:
        raise ValueError("Unrecognized magnus policy {}.".format(
            magnus_policy))

    cdtype = complex_dtype(dtype)
    initial_densities = torch.as_tensor(
        np.asarray(pstate.initial_densities), dtype=cdtype, device=device)
    density_count, d = initial_densities.shape[0], initial_densities.shape[-1]
    sop_dim = d * d
    dt = float(pstate.dt)
    n_steps = pstate.system_eval_count - 1
    final_step = pstate.final_system_eval_step
    step_costs = pstate.step_costs
    final_costs = [cost for cost in pstate.costs
                   if not cost.requires_step_evaluation]
    cost_eval_step = pstate.cost_eval_step
    trajectory = bool(step_costs) or collect_intermediates
    hamiltonian = pstate.hamiltonian
    lindblad_data = pstate.lindblad_data
    times = torch.arange(n_steps, dtype=dtype, device=device) * dt
    cet = (torch.as_tensor(pstate.control_eval_times, dtype=dtype,
                           device=device)
           if pstate.control_eval_times is not None else None)
    route = _route(sop_dim, isinstance(hamiltonian, LinearHamiltonian)
                   and isinstance(lindblad_data, (ConstantLindblad,
                                                  type(None)))
                   and magnus_policy == MagnusPolicy.M2
                   and cet is not None, allow_plane_chain)
    trajectory_steps = n_steps if trajectory else 0
    if route in ("fused", "stream"):
        rates, operators = (lindblad_data(0.0) if lindblad_data is not None
                            else (None, None))
        propagate, planes_per_step = make_propagator(
            route, magnus_policy, device, dtype,
            basis=hamiltonian.superoperator_basis(dt, rates, operators),
            weights=lambda controls, t_block: fused_weights(
                controls, t_block, cet, dt),
            trajectory_steps=trajectory_steps)
    else:
        propagate, planes_per_step = make_propagator(
            route, magnus_policy, device, dtype,
            planes=superoperator_builder(hamiltonian, lindblad_data,
                                         magnus_policy, cet, dt, d, device,
                                         cdtype),
            trajectory_steps=trajectory_steps)
    path, kernels = _route_names(route, sop_dim, device, trajectory)
    block = int(time_block_size
                or chain_block_plan(sop_dim, n_steps, cdtype.itemsize,
                                    planes_per_step))
    if log_path:
        print("qoc_tpu_torch: Lindblad propagation path = {}, {} ({}, {}, "
              "d^2={}, block={}{}).".format(
                  path, kernels, type(hamiltonian).__name__, magnus_policy,
                  sop_dim, block,
                  ", per-step prefixes" if trajectory else ""))

    def densities_at(vec, prefixes):
        """The densities (B, K, d, d) of vectorized densities ``vec`` (K, d^2)
        propagated by each of ``prefixes`` (B, d^2, d^2)."""
        return (vec @ prefixes.mT).reshape(-1, density_count, d, d)

    def loss(controls):
        vec = initial_densities.reshape(density_count, sop_dim)
        error = torch.zeros((), dtype=dtype, device=device)
        intermediates = [initial_densities[None]]
        for start in range(0, n_steps, block):
            out = propagate(controls, times[start:start + block])
            if not trajectory:
                vec = vec @ out.mT
                continue
            prod, prefixes = out
            if step_costs:
                error = error + step_cost_sum(
                    step_costs, controls,
                    lambda sel: densities_at(vec, prefixes[sel]), start,
                    prefixes.shape[0], cost_eval_step, device)
            if collect_intermediates:
                intermediates.append(densities_at(vec, prefixes))
            vec = vec @ prod.mT
        densities = vec.reshape(density_count, d, d)
        for cost in final_costs:
            error = error + cost.cost(controls, densities, final_step)
        if collect_intermediates:
            return error, densities, torch.cat(intermediates)
        return error, densities

    return loss


def evolve_lindblad_discrete(evolution_time, initial_densities,
                             system_eval_count, controls=None,
                             cost_eval_step=1, costs=(), hamiltonian=None,
                             interpolation_policy=InterpolationPolicy.LINEAR,
                             lindblad_data=None, save_file_path=None,
                             save_intermediate_densities=False,
                             method=LindbladMethod.RKDP5, atol=1e-12,
                             rtol=0.0, magnus_policy=MagnusPolicy.M2,
                             mesh=None, device=None, dtype=None):
    """Evolve density matrices under the Lindblad equation and compute the
    total cost.

    API parity: reference lindbladdiscrete.py:31-107 and ``qoc_tpu``'s
    signature (``atol``/``rtol`` are RKDP5's and unused here), plus
    ``device`` and ``dtype`` (default: the current
    CUDA device in float32, raising ``RuntimeError`` where there is none;
    ``device="cpu"`` runs float64). Only
    ``method=LindbladMethod.MAGNUS_EXPM`` is ported (module docstring).
    Returns an ``EvolveLindbladResult`` with ``error`` and
    ``final_densities`` (host numpy), and with
    ``save_intermediate_densities`` the densities at every system step,
    step 0 included, ``intermediate_densities`` (system_eval_count, K, d,
    d), as ``qoc_tpu`` returns them without a save file."""
    _check_method(method)
    if mesh is not None:
        raise _not_ported("mesh (density sharding)", 6)
    device, dtype = resolve(device, dtype)
    costs = list(costs)
    control_eval_count = controls.shape[0] if controls is not None else 0
    pstate = EvolveLindbladDiscreteState(
        control_eval_count, cost_eval_step, costs, evolution_time,
        hamiltonian, initial_densities, interpolation_policy, lindblad_data,
        save_file_path, save_intermediate_densities, system_eval_count)
    pstate.method_ = method
    pstate.magnus_policy_ = magnus_policy
    loss = build_lindblad_loss(
        pstate, device, dtype,
        collect_intermediates=save_intermediate_densities)
    if controls is not None:
        controls = torch.as_tensor(np.asarray(controls),
                                   dtype=complex_dtype(dtype), device=device)
    with torch.no_grad():
        out = loss(controls)
    result = EvolveLindbladResult()
    result.error = float(out[0])
    result.final_densities = out[1].cpu().numpy()
    if save_intermediate_densities:
        result.intermediate_densities = out[2].cpu().numpy()
    return result


def grape_lindblad_discrete(control_count, control_eval_count, costs,
                            evolution_time, initial_densities,
                            system_eval_count, complex_controls=False,
                            cost_eval_step=1, hamiltonian=None,
                            impose_control_conditions=None,
                            initial_controls=None,
                            interpolation_policy=InterpolationPolicy.LINEAR,
                            iteration_count=1000, lindblad_data=None,
                            log_iteration_step=10, max_control_norms=None,
                            min_error=0, optimizer=None, resume_from=None,
                            save_file_path=None,
                            save_intermediate_densities=False,
                            save_iteration_step=0,
                            method=LindbladMethod.RKDP5, atol=1e-12,
                            rtol=0.0, rkdp5_max_steps=16384,
                            magnus_policy=MagnusPolicy.M2, fused_chunk=None,
                            fused_mode=None, mesh=None, device=None,
                            dtype=None):
    """Optimize time-discrete controls for Lindblad evolution (GRAPE).

    API parity: reference lindbladdiscrete.py:110-256 and ``qoc_tpu``'s
    signature (``atol``, ``rtol`` and ``rkdp5_max_steps`` are RKDP5's;
    ``fused_mode`` picks ``qoc_tpu``'s compiled loop form, and the port has
    one loop), plus ``device`` and ``dtype`` as
    :func:`evolve_lindblad_discrete`. Only
    ``method=LindbladMethod.MAGNUS_EXPM`` is ported. ``optimizer=None`` is
    a fresh ``Adam()``; the loop runs on the device (core/graperunner.py).
    Without a save file ``save_intermediate_densities`` is ignored, as in
    ``qoc_tpu``. Returns a ``GrapeLindbladResult`` with the best-seen
    controls, error, final densities and iteration (host numpy)."""
    _check_method(method)
    if impose_control_conditions is not None:
        raise _not_ported("impose_control_conditions (the host loop)", 3)
    if resume_from is not None:
        raise _not_ported("resume_from", 4)
    if mesh is not None:
        raise _not_ported("mesh (density sharding)", 6)
    device, dtype = resolve(device, dtype)
    costs = list(costs)
    if optimizer is None:
        optimizer = Adam()
    initial_controls, max_control_norms = initialize_controls(
        complex_controls, control_count, control_eval_count, evolution_time,
        initial_controls, max_control_norms)
    pstate = GrapeLindbladDiscreteState(
        complex_controls, control_count, control_eval_count, cost_eval_step,
        costs, evolution_time, hamiltonian, impose_control_conditions,
        initial_controls, initial_densities, interpolation_policy,
        iteration_count, lindblad_data, log_iteration_step,
        max_control_norms, min_error, optimizer, save_file_path,
        save_intermediate_densities, save_iteration_step, system_eval_count)
    pstate.method_ = method
    pstate.magnus_policy_ = magnus_policy
    if fused_chunk is not None:
        pstate.fused_chunk = fused_chunk
    loss_controls = build_lindblad_loss(pstate, device, dtype,
                                        log_path=pstate.should_log)
    pstate.log_and_save_initial()
    result = GrapeLindbladResult()
    shape = pstate.controls_shape

    def loss_flat(flat_params):
        return loss_controls(
            slap_controls_torch(complex_controls, flat_params, shape))

    run_grape(pstate, result, loss_flat, device, dtype, evolved="densities")
    return result
