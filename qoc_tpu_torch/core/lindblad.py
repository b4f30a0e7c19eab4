"""Lindblad master-equation evolution and GRAPE.

Counterpart of ``qoc_tpu/core/lindblad.py``, with its two methods:

- ``LindbladMethod.RKDP5`` (the default, reference parity): the adaptive
  Dormand-Prince integrator of ``ops/rkdp5.py``, restarted at every
  system interval with accuracy set by ``atol`` and ``rtol``; evolve runs
  the forward-only integrator, GRAPE the bounded differentiable one
  (``rkdp5_max_steps`` attempts an interval, NaN where an interval does not
  converge). The right-hand side is the Lindbladian of ``ops/lindblad.py``
  with the controls interpolated at each attempt's stage times; it is plain
  torch (on CUDA a few hundred small launches an attempt, no kernel of
  ``csrc/``), and it takes float64 on CUDA as well (``qoc_tpu``'s x64
  mode). Its lanes carry the candidates x members of the ensembles and
  multistarts (``parallel/``; :func:`rkdp5_loss`).
- ``LindbladMethod.MAGNUS_EXPM``: the densities are vectorized
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

Save files and ``resume_from`` work as on the Schrödinger path. ``mesh``
is not ported yet, and raises ``NotImplementedError`` naming its ROADMAP
item (Queue 1 item 8).
"""

import numpy as np
import torch
import torch.utils.checkpoint

from qoc_tpu_torch.config import complex_dtype, resolve
from qoc_tpu_torch.core.common import initialize_controls, slap_controls_torch
from qoc_tpu_torch.core.graperunner import run_grape
from qoc_tpu_torch.io.resume import apply_resume
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
from qoc_tpu_torch.ops import rkdp5
from qoc_tpu_torch.ops.chain import chain_block_plan
from qoc_tpu_torch.ops.interpolate import lane_interpolator
from qoc_tpu_torch.ops.lindblad import (apply_lindbladian, dissipation,
                                        lindblad_superoperator)
from qoc_tpu_torch.optim import Adam

__all__ = ["build_lindblad_loss", "evolve_lindblad_discrete",
           "grape_lindblad_discrete", "rkdp5_loss"]

# qoc_tpu's remat rule for the RKDP5 GRAPE (core/lindblad.py:417-423):
# recompute an interval in the backward where the residuals would pass it.
_RKDP5_RESIDUAL_LIMIT = 4 * 1024 ** 3


def lindblad_method(pstate):
    """The method of a Lindblad program state: ``pstate.method_``, or
    ``qoc_tpu``'s default, RKDP5, where it sets none."""
    return getattr(pstate, "method_", LindbladMethod.RKDP5)


def _lane_hamiltonian(hamiltonian, rows):
    """h_at(c, x) -> (L, d, d) or None: each lane's Hamiltonian at its time
    x (L,) for its interpolated controls c (L, C) (None without controls).
    ``rows`` (M, P), where given, are the member rows of an
    ensemble-contract ``hamiltonian(row, controls, t)``, lane l taking row
    l % M (the lanes are candidate-major). A callable is evaluated under
    ``torch.func.vmap`` over the lanes; a ``LinearHamiltonian`` broadcasts
    over them."""
    if hamiltonian is None:
        return lambda c, x: None

    def h_at(c, x):
        if rows is not None:
            lane_rows = rows.repeat((x.shape[0] // rows.shape[0],)
                                    + (1,) * (rows.dim() - 1))
            if c is None:
                return torch.func.vmap(
                    lambda r, t: hamiltonian(r, None, t))(lane_rows, x)
            return torch.func.vmap(hamiltonian)(lane_rows, c, x)
        if c is not None and isinstance(hamiltonian, LinearHamiltonian):
            return hamiltonian(c, x)
        if c is None:
            return torch.func.vmap(lambda t: hamiltonian(None, t))(x)
        return torch.func.vmap(hamiltonian)(c, x)

    return h_at


def _lane_rhs(hamiltonian, lindblad_data, control_eval_times, rows, device,
              cdtype):
    """rhs_for(lane_controls) -> rhs(x (L,), densities (L, K, d, d)): each
    lane's Lindbladian at its own time (``qoc_tpu`` lindblad.py:52-76
    ``_make_rhs``, one lane a ``jax.vmap`` member). ``lane_controls`` is
    None or (L, E, C), each lane's controls, interpolated at its time
    (``ops/interpolate.py`` ``lane_interpolator``). ``lindblad_data`` is
    None, a ``ConstantLindblad`` (its dissipator built once) or a torch
    callable t -> (rates (n,), operators (n, d, d)) evaluated under
    ``torch.func.vmap`` over the lanes."""
    h_at = _lane_hamiltonian(hamiltonian, rows)
    terms = None
    if isinstance(lindblad_data, ConstantLindblad):
        rates, operators = lindblad_data(0.0)
        if rates is not None and operators is not None:
            terms = dissipation(
                torch.as_tensor(rates, device=device),
                torch.as_tensor(operators, dtype=cdtype, device=device))
    per_lane = not isinstance(lindblad_data, (ConstantLindblad, type(None)))

    def lane_lindbladian(densities, h, rates, operators):
        return apply_lindbladian(densities, h, dissipation(
            rates, None if operators is None else operators.to(cdtype)))

    def rhs_for(lane_controls):
        controls_at = (lane_interpolator(control_eval_times, lane_controls)
                       if lane_controls is not None
                       and control_eval_times is not None else None)

        def rhs(x, densities):
            h = h_at(None if controls_at is None else controls_at(x), x)
            if h is not None:
                h = torch.broadcast_to(h.to(device=device, dtype=cdtype),
                                       x.shape + densities.shape[-2:])
            if per_lane:
                rates, operators = torch.func.vmap(lindblad_data)(x)
                return torch.func.vmap(
                    lane_lindbladian,
                    in_dims=(0, None if h is None else 0, 0, 0))(
                        densities, h, rates, operators)
            return apply_lindbladian(densities,
                                     None if h is None else h[:, None],
                                     terms)
        return rhs

    return rhs_for


def _lane_costs(costs, lane_controls, densities, step):
    """Σ_costs cost(controls, densities, step) of each lane (L,): one lane
    called directly, as ``qoc_tpu`` calls it, more under
    ``torch.func.vmap`` over the lanes' controls and densities."""
    def total(controls, x):
        error = 0.0
        for cost in costs:
            error = error + cost.cost(controls, x, step)
        return error
    if densities.shape[0] == 1:
        return total(None if lane_controls is None else lane_controls[0],
                     densities[0]).reshape(1)
    return torch.func.vmap(total)(lane_controls, densities)


def rkdp5_loss(pstate, device, dtype, hamiltonian, params=None,
               differentiable=True, collect_intermediates=False):
    """The RKDP5 loss of lanes: controls (None, or (N, E, C) of N
    candidates) -> (errors (L,), final densities (L, K, d, d)) for L = N M
    lanes, candidate-major, M the rows of ``params`` (None: one member of
    a plain ``hamiltonian(controls, t)``); with ``collect_intermediates``
    also the densities at every system step, step 0 included (S, L, K, d,
    d).

    Mirrors the RKDP5 branch of ``qoc_tpu``'s build_lindblad_loss
    (core/lindblad.py:409-479; its ensembles' generic route under
    ``jax.vmap``, parallel/lindblad.py:160-175, 636-680): one integration
    of all lanes an interval, the step costs on the steps k with k %
    cost_eval_step == 0, the final costs at the end, each lane's costs on
    its own controls. ``differentiable`` takes the bounded integrator
    (``pstate.rkdp5_max_steps`` attempts), else the forward-only one;
    ``pstate.atol`` and ``pstate.rtol`` set the accuracy. Where an
    interval's autograd residuals would pass 4 GiB (``qoc_tpu``'s rule,
    counted for all lanes) each interval is recomputed in the backward
    (``torch.utils.checkpoint``); the values do not change."""
    if pstate.interpolation_policy != InterpolationPolicy.LINEAR:
        raise NotImplementedError(
            "The interpolation policy {} is not yet supported for this "
            "method.".format(pstate.interpolation_policy))
    cdtype = complex_dtype(dtype)
    initial = torch.as_tensor(np.asarray(pstate.initial_densities),
                              dtype=cdtype, device=device)
    density_count, d = initial.shape[0], initial.shape[-1]
    dt = float(pstate.dt)
    n_steps = pstate.system_eval_count - 1
    final_step = pstate.final_system_eval_step
    step_costs = pstate.step_costs
    final_costs = [cost for cost in pstate.costs
                   if not cost.requires_step_evaluation]
    cost_eval_step = pstate.cost_eval_step
    rows = None if params is None else torch.as_tensor(
        np.asarray(params), device=device,
        dtype=cdtype if np.iscomplexobj(params) else dtype)
    n_members = 1 if rows is None else rows.shape[0]
    cet = (torch.as_tensor(pstate.control_eval_times, dtype=dtype,
                           device=device)
           if pstate.control_eval_times is not None else None)
    rhs_for = _lane_rhs(hamiltonian, pstate.lindblad_data, cet, rows,
                        device, cdtype)
    kwargs = dict(atol=getattr(pstate, "atol", 1e-12),
                  rtol=getattr(pstate, "rtol", 0.0), lanes=True)
    if differentiable:
        integrate = rkdp5.integrate_rkdp5_scan
        kwargs["max_steps"] = getattr(pstate, "rkdp5_max_steps", 16384)
    else:
        integrate = rkdp5.integrate_rkdp5

    def advance(densities, lane_controls, k):
        time = torch.tensor(k - 1, dtype=dtype, device=device) * dt
        return integrate(rhs_for(lane_controls), (time + dt).reshape(1),
                         time, densities, **kwargs)[0]

    def loss(controls):
        lanes = n_members * (1 if controls is None else controls.shape[0])
        lane_controls = (None if controls is None
                         else controls.repeat_interleave(n_members, dim=0))
        dim = d * density_count * 60
        remat = differentiable and torch.is_grad_enabled() and (
            10 * cdtype.itemsize * n_steps * dim * dim * lanes
            > _RKDP5_RESIDUAL_LIMIT)
        densities = initial.expand((lanes,) + initial.shape)
        errors = torch.zeros((lanes,), dtype=dtype, device=device)
        intermediates = [densities]
        for k in range(1, n_steps + 1):
            if remat:
                densities = torch.utils.checkpoint.checkpoint(
                    advance, densities, lane_controls, k,
                    use_reentrant=False)
            else:
                densities = advance(densities, lane_controls, k)
            if step_costs and k % cost_eval_step == 0:
                errors = errors + _lane_costs(step_costs, lane_controls,
                                              densities, k)
            if collect_intermediates:
                intermediates.append(densities)
        if final_costs:
            errors = errors + _lane_costs(final_costs, lane_controls,
                                          densities, final_step)
        if collect_intermediates:
            return errors, densities, torch.stack(intermediates)
        return errors, densities

    return loss


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
                        collect_intermediates=False, differentiable=True):
    """The loss: controls (a (E, C) tensor, or None) -> (error,
    final_densities), differentiable w.r.t. the controls; with
    ``collect_intermediates`` (error, final_densities,
    intermediate_densities), the densities at every system step, step 0
    included (system_eval_count, K, d, d).

    Mirrors ``qoc_tpu``'s build_lindblad_loss (reference
    _evaluate_lindblad_discrete, lindbladdiscrete.py:357-441).
    ``pstate.method_`` and ``pstate.magnus_policy_`` carry the method and
    the Magnus order, as in ``qoc_tpu``. Under ``MAGNUS_EXPM`` the loss
    takes the route of the module docstring, in the trajectory form where
    step costs or intermediate densities need it; under RKDP5 it is
    :func:`rkdp5_loss` on one lane, with the bounded integrator, or with
    ``differentiable=False`` the forward-only one (evolve)."""
    if lindblad_method(pstate) != LindbladMethod.MAGNUS_EXPM:
        lanes_loss = rkdp5_loss(
            pstate, device, dtype, pstate.hamiltonian,
            differentiable=differentiable,
            collect_intermediates=collect_intermediates)
        if log_path:
            print("qoc_tpu_torch: Lindblad propagation path = adaptive "
                  "RKDP5 integrator (plain torch on {}, a host read every "
                  "4, then {} attempts; method=LindbladMethod.MAGNUS_EXPM "
                  "takes the CUDA kernels).".format(device.type,
                                                   rkdp5.CHUNK))

        def loss(controls):
            out = lanes_loss(None if controls is None else controls[None])
            if collect_intermediates:
                return out[0][0], out[1][0], out[2][:, 0]
            return out[0][0], out[1][0]
        return loss
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
    signature (``atol``/``rtol`` set RKDP5's accuracy, the forward-only
    integrator), plus ``device`` and ``dtype`` (default: the current
    CUDA device in float32, raising ``RuntimeError`` where there is none;
    ``device="cpu"`` runs float64; under RKDP5 CUDA takes float64 too).
    Returns an ``EvolveLindbladResult`` with ``error`` and
    ``final_densities`` (host numpy), and with
    ``save_intermediate_densities`` the densities at every system step,
    step 0 included, ``intermediate_densities`` (system_eval_count, K, d,
    d), as ``qoc_tpu`` returns them; with ``save_file_path`` the evolve
    file is written (``qoc_tpu``'s schema), with the intermediate
    densities when asked."""
    if mesh is not None:
        raise _not_ported("mesh (density sharding)", "6d, Queue 1 item 8")
    device, dtype = resolve(device, dtype, float64_ok=(
        method != LindbladMethod.MAGNUS_EXPM))
    costs = list(costs)
    control_eval_count = controls.shape[0] if controls is not None else 0
    pstate = EvolveLindbladDiscreteState(
        control_eval_count, cost_eval_step, costs, evolution_time,
        hamiltonian, initial_densities, interpolation_policy, lindblad_data,
        save_file_path, save_intermediate_densities, system_eval_count)
    pstate.method_ = method
    pstate.atol = atol
    pstate.rtol = rtol
    pstate.magnus_policy_ = magnus_policy
    pstate.save_initial(controls)
    loss = build_lindblad_loss(
        pstate, device, dtype,
        collect_intermediates=save_intermediate_densities,
        differentiable=False)
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
        pstate.save_intermediate_densities(result.intermediate_densities)
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
    signature (``atol``, ``rtol`` and ``rkdp5_max_steps`` are RKDP5's: the
    bounded integrator's accuracy and its attempts an interval, NaN errors
    where an interval does not converge; ``fused_mode`` picks
    ``qoc_tpu``'s compiled loop form, and the port has one loop), plus
    ``device`` and ``dtype`` as :func:`evolve_lindblad_discrete`.
    ``optimizer=None`` is a fresh ``Adam()``; Adam, SGD and LBFGS run on
    the device, LBFGSB and any optimizer under an
    ``impose_control_conditions`` hook on the host loop
    (core/graperunner.py).
    Save files and ``resume_from`` as :func:`grape_schroedinger_discrete`'s
    (``save_intermediate_densities`` the trajectory a save row); without a
    save file ``save_intermediate_densities`` is ignored, as in
    ``qoc_tpu``. Returns a ``GrapeLindbladResult`` with the best-seen
    controls, error, final densities and iteration (host numpy)."""
    if mesh is not None:
        raise _not_ported("mesh (density sharding)", "6d, Queue 1 item 8")
    device, dtype = resolve(device, dtype, float64_ok=(
        method != LindbladMethod.MAGNUS_EXPM))
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
    pstate.atol = atol
    pstate.rtol = rtol
    pstate.rkdp5_max_steps = rkdp5_max_steps
    pstate.magnus_policy_ = magnus_policy
    if fused_chunk is not None:
        pstate.fused_chunk = fused_chunk
    if resume_from is not None:
        apply_resume(pstate, resume_from)
    loss_controls = build_lindblad_loss(pstate, device, dtype,
                                        log_path=pstate.should_log)
    pstate.log_and_save_initial()
    result = GrapeLindbladResult()
    shape = pstate.controls_shape

    def loss_flat(flat_params):
        return loss_controls(
            slap_controls_torch(complex_controls, flat_params, shape))

    collect_fn = None
    if pstate.save_intermediate_densities_:
        collect_loss = build_lindblad_loss(pstate, device, dtype,
                                           collect_intermediates=True,
                                           differentiable=False)

        def collect_fn(flat):
            return collect_loss(
                slap_controls_torch(complex_controls, flat, shape))[2]

    run_grape(pstate, result, loss_flat, device, dtype, evolved="densities",
              collect_fn=collect_fn)
    return result
