"""Schrödinger-equation evolution and GRAPE.

Counterpart of ``qoc_tpu/core/schroedinger.py``. Steps run in time blocks
(``chain_block_plan``; the Table-3 headline is one block) composed by a
Python loop, and autograd chains the blocks' exact gradients. A block
propagates by one of three routes, chosen by the problem alone, so the
CPU walks the route the card takes:

- the fused route, for a ``LinearHamiltonian`` under Magnus-M2 with
  controls at d <= 64: weight rows against a constant generator basis
  through the chain op (``ops/chain.py``), carried on CUDA by K1/K2;
- the streamed route, for the same problems at 256 < padded d <= 512: the
  weight rows times the basis give the step planes (a plain product, as
  ``qoc_tpu``'s ``_stream_planes``; autograd through it gives the weight
  gradient), and the planes go through the plane chain op, carried on
  CUDA by K6;
- the plane route, for everything else at d <= 64 and at 256 < padded
  d <= 512: any Hamiltonian callable under Magnus M2, M4 or M6, with or
  without controls, and a ``LinearHamiltonian`` under M4 or M6. Each
  step's Magnus term is built as a complex plane by plain torch operations
  (differentiated by autograd) and the planes go through the plane chain
  op, carried on CUDA by K5 (d <= 64) or K6;
- the blocked route, for 64 < padded d <= 256, for d above 512, and where
  the plane route would apply with ``allow_plane_chain=False``
  (``qoc_tpu``'s generic route): the block's planes, built as on the plane
  route, go through the batched ``ops/expm.py`` expm (K3/K4 up to padded
  d = 256, ``expm_taylor`` on ``torch.matmul`` above) and a log-depth
  pairwise tree product. For 64 < d <= 256 ``qoc_tpu`` takes its chain
  kernels instead; the numbers agree.

Step costs (``requires_step_evaluation``) and intermediate states need the
state after every step: then each route runs in its trajectory form, which
also returns the block's prefixes P_t = U_t ··· U_0 (the chain ops'
``return_prefixes``, whose backward runs K2, K5 or K6 in the per-step-seed
mode; on the blocked route a log-depth prefix scan in place of the tree
product), and the states after each step are ``prefixes @ states``.

The Lindblad entry points (``core/lindblad.py``) take the same routes by
the superoperator's dimension d².

The Hamiltonian contract of the port: a callable written with ``torch``
operations, ``(controls (C,) complex tensor or None, t 0-dim real tensor)
-> (d, d) tensor``, on the controls' device. It is evaluated under
``torch.func.vmap`` over every Magnus node of a block, so it must not call
``.item()``, numpy functions on its arguments, or write into them in place.
Constants it closes over may be numpy arrays or tensors of any complex
dtype: on CUDA the planes are cast to complex64 at the op boundary.

Save files (``save_file_path``, ``save_iteration_step``,
``save_intermediate_states``) and ``resume_from`` work as in ``qoc_tpu``
(``io/``, ``core/graperunner.py``). ``mesh`` is not ported yet, and
raises ``NotImplementedError`` naming its ROADMAP item (Queue 1 item 8).
"""

import numpy as np
import torch

from qoc_tpu_torch.config import complex_dtype, resolve
from qoc_tpu_torch.core.common import initialize_controls, slap_controls_torch
from qoc_tpu_torch.core.graperunner import run_grape
from qoc_tpu_torch.io.resume import apply_resume
from qoc_tpu_torch.models import (EvolveSchroedingerDiscreteState,
                                  EvolveSchroedingerResult,
                                  GrapeSchroedingerDiscreteState,
                                  GrapeSchroedingerResult,
                                  InterpolationPolicy, LinearHamiltonian,
                                  MagnusPolicy)
from qoc_tpu_torch.ops.chain import (KERNEL_DP, ChainExpmPropagate,
                                     _prefix_products, chain_block_plan,
                                     kernel_dp, plane_chain_propagate,
                                     plane_chain_propagate_prefixes,
                                     uses_stream)
from qoc_tpu_torch.ops.expm import approximant, expm
from qoc_tpu_torch.ops.expm_cuda import KERNEL_MAX_DP
from qoc_tpu_torch.ops.interpolate import interpolate_linear_set
from qoc_tpu_torch.ops.magnus import magnus_m2, magnus_m4, magnus_m6
from qoc_tpu_torch.optim import Adam

__all__ = ["build_schroedinger_loss", "cost_steps",
           "evolve_schroedinger_discrete", "fused_weights",
           "grape_schroedinger_discrete",
           "hamiltonian_sampler", "make_propagator", "plane_builder",
           "step_cost_sum"]


# Magnus term of each policy, and the (d, d) planes a step's build holds at
# its peak, its output included, which bounds what its autograd graph keeps
# for the backward: M2 the term; M4 a1, a2, the commutator's two products
# and the term; M6 three nodes, b1..b3, [b1, b2], the outer commutator's
# arguments, an inner term, its two products and the term. A callable's own
# temporaries are not counted.
_MAGNUS = {
    MagnusPolicy.M2: (magnus_m2, 1),
    MagnusPolicy.M4: (magnus_m4, 5),
    MagnusPolicy.M6: (magnus_m6, 13),
}
# What the plane op keeps a step besides the build: its padded input
# plane, the prefix and the gradient plane its backward writes.
_PLANE_OP_PLANES = 3
# What the blocked route keeps a step besides the build: the expm input
# (saved for K4), U and about one tree product.
_BLOCKED_PLANES = 3
# What the trajectory form keeps a step on top of that: the global prefix,
# its gradient and the per-step seed (on the blocked route, also one plane
# a level of the prefix scan).
_TRAJECTORY_PLANES = 3


def _not_ported(what, roadmap_slice):
    return NotImplementedError(
        "{} is not ported to qoc_tpu_torch yet (ROADMAP slice {}); use "
        "qoc_tpu for it.".format(what, roadmap_slice))


def fused_weights(controls, times, control_eval_times, dt):
    """Weight rows [1, Re c_1, Im c_1, ...] (B, 1 + 2C) of the chain op,
    with the controls (E, C) interpolated at the step midpoints
    ``times + dt/2`` (``qoc_tpu`` schroedinger.py fused_weights); controls
    (N, E, C) of N candidates give (N, B, 1 + 2C)."""
    c_mid = torch.movedim(interpolate_linear_set(
        times + dt / 2, control_eval_times, torch.movedim(controls, -2, 0)),
        0, -2)
    imag = (torch.imag(c_mid) if c_mid.is_complex()
            else torch.zeros_like(c_mid))
    ri = torch.stack((torch.real(c_mid), imag), dim=-1).reshape(
        c_mid.shape[:-1] + (2 * c_mid.shape[-1],))
    ones = torch.ones(c_mid.shape[:-1] + (1,), dtype=ri.dtype,
                      device=ri.device)
    return torch.cat((ones, ri), dim=-1)


def hamiltonian_sampler(hamiltonian, control_eval_times):
    """hamiltonian_at(controls, t) -> (B, d, d): H at the node times ``t``
    (B,), the controls interpolated there; a callable is evaluated under
    ``torch.func.vmap`` (module docstring)."""

    def hamiltonian_at(controls, t):
        """H at the node times ``t`` (B,), controls interpolated there."""
        if controls is None:
            c_t = None
        else:
            c_t = interpolate_linear_set(t, control_eval_times, controls)
        if isinstance(hamiltonian, LinearHamiltonian):
            # Its __call__ broadcasts over the controls' leading axis: one
            # call gives the same planes as the vmapped one below.
            h = hamiltonian(c_t, t)
        elif c_t is None:
            h = torch.func.vmap(lambda t_j: hamiltonian(None, t_j))(t)
        else:
            h = torch.func.vmap(hamiltonian)(c_t, t)
        h = h.to(t.device)
        return torch.broadcast_to(h, t.shape + h.shape[-2:])

    return hamiltonian_at


def plane_builder(hamiltonian, magnus_policy, control_eval_times, dt):
    """planes(controls, times) -> (B, d, d): the Magnus term of each step
    [t, t + dt] for the step start times ``times`` (B,), in the dtype the
    Hamiltonian gives (``qoc_tpu`` schroedinger.py magnus_term_at)."""
    magnus = _MAGNUS[magnus_policy][0]
    hamiltonian_at = hamiltonian_sampler(hamiltonian, control_eval_times)

    def planes(controls, times):
        return magnus(lambda t: -1j * hamiltonian_at(controls, t), dt, times)

    return planes


def _tree_product(us):
    """us[B-1] ··· us[1] us[0] of a (..., B, d, d) stack by a log-depth
    pairwise reduction along B, an odd level padded with the identity
    (qoc_tpu schroedinger.py:349-357): (..., d, d)."""
    d = us.shape[-1]
    while us.shape[-3] > 1:
        if us.shape[-3] % 2:
            eye = torch.eye(d, dtype=us.dtype, device=us.device)
            us = torch.cat((us, eye.expand(us.shape[:-3] + (1, d, d))),
                           dim=-3)
        pairs = us.reshape(us.shape[:-3] + (us.shape[-3] // 2, 2, d, d))
        us = pairs[..., 1, :, :] @ pairs[..., 0, :, :]
    return us[..., 0, :, :]


def _route(d, fused_ok, allow_plane_chain):
    """'fused', 'stream', 'plane' or 'blocked' for a problem of dimension d
    (module docstring): ``fused_ok`` where the chain of weight rows against
    a basis applies."""
    chain = d <= KERNEL_DP or uses_stream(d)
    if chain and fused_ok:
        return "fused" if d <= KERNEL_DP else "stream"
    return "plane" if chain and allow_plane_chain else "blocked"


_APPROXIMANT_NAMES = {"kernels": "CUDA kernels K3/K4",
                      "taylor": "torch.matmul Taylor",
                      "pade": "Padé-13 on torch.linalg.solve"}


def _route_names(route, d, device, trajectory=False):
    """(path, what carries it) for the one-time path log line."""
    if route == "blocked":
        path = "blocked expm + " + ("prefix scan" if trajectory
                                    else "tree product")
        method = approximant(d, device)
        kernels = _APPROXIMANT_NAMES[method]
        if method != "kernels" and kernel_dp(d) > KERNEL_MAX_DP:
            kernels += " (d > 256)"
    else:
        path = {"fused": "fused chain", "stream": "streamed chain",
                "plane": "plane chain"}[route]
        kernels = ("CUDA kernels K1/K2" if route == "fused"
                   else "CUDA kernels K5" if d <= KERNEL_DP
                   else "CUDA kernels K6")
    if device.type != "cuda" and kernels.startswith("CUDA"):
        kernels = "plain torch on " + device.type
    return path, kernels


def make_propagator(route, magnus_policy, device, dtype, basis=None,
                    weights=None, planes=None, trajectory_steps=0):
    """(propagate(controls, t_block) -> the block's ordered product of step
    exponentials, planes a step holds for chain_block_plan) on ``route``:
    ``basis`` (numpy (n_b, n, n)) and ``weights(controls, t_block)`` ->
    (B, n_b) rows on the fused and streamed routes, ``planes(controls,
    t_block)`` -> (B, n, n) Magnus planes on the plane and blocked routes.
    ``trajectory_steps`` > 0 gives the trajectory form, for blocks of at
    most that many steps: propagate returns (product, prefixes (B, n, n)).
    Weights (R, B, n_b) or planes (R, B, n, n) of R chains give R products
    and prefixes (R, B, n, n) (``parallel/``). The Lindblad loss shares it
    (core/lindblad.py)."""
    cdtype = complex_dtype(dtype)
    build_planes = _MAGNUS[magnus_policy][1]
    trajectory = trajectory_steps > 0
    kept = _TRAJECTORY_PLANES if trajectory else 0
    if route == "fused":
        chain = ChainExpmPropagate(basis, device, dtype,
                                   return_prefixes=trajectory)
        return (lambda controls, t_block: chain(weights(controls, t_block)),
                2 + kept)
    plane_op = (plane_chain_propagate_prefixes if trajectory
                else plane_chain_propagate)
    if route == "stream":
        n_b, n = basis.shape[0], basis.shape[-1]
        flat_basis = torch.as_tensor(basis, dtype=cdtype,
                                     device=device).reshape(n_b, n * n)

        def propagate(controls, t_block):
            # Weights (B, n_b), or (R, B, n_b) of R chains: planes (..., B,
            # n, n) on the plane op's member axis.
            a = weights(controls, t_block).to(cdtype) @ flat_basis
            return plane_op(a.reshape(a.shape[:-1] + (n, n)))
        return propagate, _PLANE_OP_PLANES + 1 + kept
    if route == "plane":
        return (lambda controls, t_block: plane_op(
            planes(controls, t_block).to(cdtype)),
            _PLANE_OP_PLANES + build_planes + kept)
    if trajectory:
        def propagate(controls, t_block):
            prefixes = _prefix_products(expm(
                planes(controls, t_block).to(cdtype)))
            return prefixes[..., -1, :, :], prefixes
        return propagate, (_BLOCKED_PLANES + build_planes + kept
                           + (trajectory_steps - 1).bit_length())
    return (lambda controls, t_block: _tree_product(expm(
        planes(controls, t_block).to(cdtype))),
        _BLOCKED_PLANES + build_planes)


def cost_steps(start, block_steps, cost_eval_step, device):
    """(sel, ks) of a block of ``block_steps`` steps starting after step
    ``start``: the slice of its cost steps (global k = start + j + 1 with
    k % cost_eval_step == 0) and their global indices k, or None where the
    block holds no cost step."""
    sel = slice(-(start + 1) % cost_eval_step, block_steps, cost_eval_step)
    if not range(block_steps)[sel]:
        return None
    return sel, torch.arange(start + 1, start + 1 + block_steps,
                             device=device)[sel]


def _step_cost(step_costs, controls):
    """x, k -> Σ_costs cost(controls, x, k)."""
    def one_step(x, k):
        error = 0.0
        for cost in step_costs:
            error = error + cost.cost(controls, x, k)
        return error
    return one_step


def step_cost_sum(step_costs, controls, evolved, start, block_steps,
                  cost_eval_step, device):
    """The step costs of one block of ``block_steps`` steps starting after
    step ``start``: Σ over its cost steps k (:func:`cost_steps`) of
    Σ_costs cost(controls, x_k, k), evaluated under ``torch.func.vmap``.
    ``evolved(sel)`` gives the evolved states or densities at the block's
    steps ``sel`` (a slice). Only the cost steps are evaluated (``qoc_tpu``
    evaluates every step and masks: the values agree). Zero where the block
    holds no cost step."""
    steps = cost_steps(start, block_steps, cost_eval_step, device)
    if steps is None:
        return 0.0
    sel, ks = steps
    return torch.func.vmap(_step_cost(step_costs, controls))(
        evolved(sel), ks).sum()


def build_schroedinger_loss(pstate, device, dtype, time_block_size=None,
                            log_path=False, allow_plane_chain=True,
                            collect_intermediates=False):
    """The loss: controls (a (E, C) tensor, or None) -> (error,
    final_states), differentiable w.r.t. the controls; with
    ``collect_intermediates`` (error, final_states, intermediate_states),
    the states at every system step, step 0 included
    (system_eval_count, K, d, 1).

    Mirrors ``qoc_tpu``'s build_schroedinger_loss (reference
    _evaluate_schroedinger_discrete, schroedingerdiscrete.py:356-438): the
    fused, plane or blocked route by the problem (module docstring), in the
    trajectory form where step costs or intermediate states need it.
    ``allow_plane_chain=False`` sends what would take the plane route to
    the blocked route, as in ``qoc_tpu``."""
    if pstate.interpolation_policy != InterpolationPolicy.LINEAR:
        raise NotImplementedError(
            "The interpolation policy {} is not yet supported for this "
            "method.".format(pstate.interpolation_policy))
    if pstate.magnus_policy not in _MAGNUS:
        raise ValueError("Unrecognized magnus policy {}.".format(
            pstate.magnus_policy))

    cdtype = complex_dtype(dtype)
    initial_states = torch.as_tensor(np.asarray(pstate.initial_states),
                                     dtype=cdtype, device=device)
    dt = float(pstate.dt)
    n_steps = pstate.system_eval_count - 1
    final_step = pstate.final_system_eval_step
    step_costs = pstate.step_costs
    final_costs = [cost for cost in pstate.costs
                   if not cost.requires_step_evaluation]
    cost_eval_step = pstate.cost_eval_step
    trajectory = bool(step_costs) or collect_intermediates
    d = initial_states.shape[-2]
    hamiltonian = pstate.hamiltonian
    times = torch.arange(n_steps, dtype=dtype, device=device) * dt
    cet = (torch.as_tensor(pstate.control_eval_times, dtype=dtype,
                           device=device)
           if pstate.control_eval_times is not None else None)
    route = _route(d, isinstance(hamiltonian, LinearHamiltonian)
                   and pstate.magnus_policy == MagnusPolicy.M2
                   and cet is not None, allow_plane_chain)
    trajectory_steps = n_steps if trajectory else 0
    if route in ("fused", "stream"):
        propagate, planes_per_step = make_propagator(
            route, pstate.magnus_policy, device, dtype,
            basis=hamiltonian.generator_basis(dt),
            weights=lambda controls, t_block: fused_weights(
                controls, t_block, cet, dt),
            trajectory_steps=trajectory_steps)
    else:
        propagate, planes_per_step = make_propagator(
            route, pstate.magnus_policy, device, dtype,
            planes=plane_builder(hamiltonian, pstate.magnus_policy, cet, dt),
            trajectory_steps=trajectory_steps)
    path, kernels = _route_names(route, d, device, trajectory)
    block = int(time_block_size
                or chain_block_plan(d, n_steps, cdtype.itemsize,
                                    planes_per_step))
    if log_path:
        print("qoc_tpu_torch: propagation path = {}, {} ({}, {}, d={}, "
              "block={}{}).".format(
                  path, kernels, type(hamiltonian).__name__,
                  pstate.magnus_policy, d, block,
                  ", per-step prefixes" if trajectory else ""))

    def loss(controls):
        states = initial_states
        error = torch.zeros((), dtype=dtype, device=device)
        intermediates = [initial_states[None]]
        for start in range(0, n_steps, block):
            out = propagate(controls, times[start:start + block])
            if not trajectory:
                states = out @ states
                continue
            # The states after each step of the block: prefixes @ states.
            prod, prefixes = out
            if step_costs:
                error = error + step_cost_sum(
                    step_costs, controls,
                    lambda sel: prefixes[sel, None] @ states, start,
                    prefixes.shape[0], cost_eval_step, device)
            if collect_intermediates:
                intermediates.append(prefixes[:, None] @ states)
            states = prod @ states
        for cost in final_costs:
            error = error + cost.cost(controls, states, final_step)
        if collect_intermediates:
            return error, states, torch.cat(intermediates)
        return error, states

    return loss


def evolve_schroedinger_discrete(evolution_time, hamiltonian, initial_states,
                                 system_eval_count, controls=None,
                                 cost_eval_step=1, costs=(),
                                 interpolation_policy=InterpolationPolicy.LINEAR,
                                 magnus_policy=MagnusPolicy.M2,
                                 save_file_path=None,
                                 save_intermediate_states=False,
                                 time_block_size=None, mesh=None,
                                 device=None, dtype=None):
    """Evolve state vectors under the Schrödinger equation and compute the
    total cost.

    API parity: reference schroedingerdiscrete.py:28-103, plus ``device``
    and ``dtype`` (default: the current CUDA device in float32, raising
    ``RuntimeError`` where there is none; ``device="cpu"`` runs float64).
    ``hamiltonian`` follows the port's contract (module docstring).
    Returns an ``EvolveSchroedingerResult`` with ``error`` and
    ``final_states`` (host numpy), and with ``save_intermediate_states``
    the states at every system step, step 0 included,
    ``intermediate_states`` (system_eval_count, K, d, 1), as ``qoc_tpu``
    returns them; with ``save_file_path`` the evolve file is written
    (``qoc_tpu``'s schema), with the intermediate states when asked."""
    if mesh is not None:
        raise _not_ported("mesh (state sharding)", "6d, Queue 1 item 8")
    device, dtype = resolve(device, dtype)
    costs = list(costs)
    control_eval_count = controls.shape[0] if controls is not None else 0
    pstate = EvolveSchroedingerDiscreteState(
        control_eval_count, cost_eval_step, costs, evolution_time,
        hamiltonian, initial_states, interpolation_policy, magnus_policy,
        save_file_path, save_intermediate_states, system_eval_count)
    pstate.save_initial(controls)
    loss = build_schroedinger_loss(
        pstate, device, dtype, time_block_size=time_block_size,
        collect_intermediates=save_intermediate_states)
    if controls is not None:
        controls = torch.as_tensor(np.asarray(controls),
                                   dtype=complex_dtype(dtype), device=device)
    with torch.no_grad():
        out = loss(controls)
    result = EvolveSchroedingerResult()
    result.error = float(out[0])
    result.final_states = out[1].cpu().numpy()
    if save_intermediate_states:
        result.intermediate_states = out[2].cpu().numpy()
        pstate.save_intermediate_states(result.intermediate_states)
    return result


def grape_schroedinger_discrete(control_count, control_eval_count, costs,
                                evolution_time, hamiltonian, initial_states,
                                system_eval_count, complex_controls=False,
                                cost_eval_step=1,
                                impose_control_conditions=None,
                                initial_controls=None,
                                interpolation_policy=InterpolationPolicy.LINEAR,
                                iteration_count=1000, log_iteration_step=10,
                                magnus_policy=MagnusPolicy.M2,
                                max_control_norms=None, min_error=0,
                                optimizer=None, resume_from=None,
                                save_file_path=None,
                                save_intermediate_states=False,
                                save_iteration_step=0,
                                time_block_size=None, fused_chunk=None,
                                mesh=None, device=None, dtype=None):
    """Optimize time-discrete controls for Schrödinger evolution (GRAPE).

    API parity: reference schroedingerdiscrete.py:106-252 and ``qoc_tpu``'s
    signature, plus ``device`` and ``dtype`` (default: the current CUDA
    device in float32, raising ``RuntimeError`` where there is none;
    ``device="cpu"`` runs float64). ``hamiltonian`` follows the port's
    contract (module docstring). ``optimizer=None`` is a fresh ``Adam()``.
    Adam, SGD and LBFGS run on the device, LBFGSB and any optimizer under
    an ``impose_control_conditions`` hook (controls (E, C) numpy ->
    controls) on the host loop (core/graperunner.py).
    ``save_file_path`` with ``save_iteration_step`` > 0 writes ``qoc_tpu``'s
    GRAPE file (rows on the cadence and at the final iteration, the
    optimizer snapshot, with ``save_intermediate_states`` the trajectory
    a row); without a save file ``save_intermediate_states`` is ignored,
    as in ``qoc_tpu``. ``resume_from`` names a save file of either package:
    its checkpointed params, optimizer state and iteration are restored
    and the run continues (into the same file, grown for a larger
    ``iteration_count``, when it is also ``save_file_path``). Returns a
    ``GrapeSchroedingerResult`` with the best-seen controls, error, final
    states and iteration (host numpy)."""
    if mesh is not None:
        raise _not_ported("mesh (state sharding)", "6d, Queue 1 item 8")
    device, dtype = resolve(device, dtype)
    costs = list(costs)
    if optimizer is None:
        optimizer = Adam()
    initial_controls, max_control_norms = initialize_controls(
        complex_controls, control_count, control_eval_count, evolution_time,
        initial_controls, max_control_norms)
    pstate = GrapeSchroedingerDiscreteState(
        complex_controls, control_count, control_eval_count, cost_eval_step,
        costs, evolution_time, hamiltonian, impose_control_conditions,
        initial_controls, initial_states, interpolation_policy,
        iteration_count, log_iteration_step, max_control_norms,
        magnus_policy, min_error, optimizer, save_file_path,
        save_intermediate_states, save_iteration_step, system_eval_count)
    if fused_chunk is not None:
        pstate.fused_chunk = fused_chunk
    if resume_from is not None:
        apply_resume(pstate, resume_from)
    loss_controls = build_schroedinger_loss(pstate, device, dtype,
                                            time_block_size=time_block_size,
                                            log_path=pstate.should_log)
    pstate.log_and_save_initial()
    result = GrapeSchroedingerResult()
    shape = pstate.controls_shape

    def loss_flat(flat_params):
        return loss_controls(
            slap_controls_torch(complex_controls, flat_params, shape))

    collect_fn = None
    if pstate.save_intermediate_states_:
        collect_loss = build_schroedinger_loss(
            pstate, device, dtype, time_block_size=time_block_size,
            collect_intermediates=True)

        def collect_fn(flat):
            return collect_loss(
                slap_controls_torch(complex_controls, flat, shape))[2]

    run_grape(pstate, result, loss_flat, device, dtype,
              collect_fn=collect_fn)
    return result
