"""Ensemble-robust GRAPE on one card.

Counterpart of ``qoc_tpu/parallel/ensemble.py``. Every ensemble member (a
Hamiltonian parameter row: detuning, amplitude miscalibration, ...) rolls
out the whole propagation, the optimized error is the members' mean, and
one optimizer step updates the shared controls. ``qoc_tpu`` shards the
members over a device mesh; the port runs them all on one card, so
``mesh`` other than None raises (ROADMAP Queue 1, item 8).

One chain loss (:func:`build_chain_loss`) carries every member of a
Schrödinger problem (states evolve as U ψ) and of a Lindblad problem
(``parallel/lindblad.py``): under ``MAGNUS_EXPM`` densities evolve
vectorized, vec ← vec P^T, by superoperator chains of dimension n = d²;
under RKDP5, the default, the chains are the lanes of one adaptive
integration an interval (route "rkdp5", ``core/lindblad.py``
``rkdp5_loss``). The chain routes, chosen by the problem alone as
``qoc_tpu`` chooses them, by n:

- the fused route, for an :class:`EnsembleLinearHamiltonian` (or, without
  member rows, a :class:`LinearHamiltonian`) under Magnus-M2 with controls
  and, for Lindblad, constant or no dissipation: member m's weight rows
  are [1, δ_m, Re c, Im c] against the shared generator basis [h0,
  param_ops..., P_i, Q_i] (or its superoperator basis), and all members'
  chains go through a chain op's member axis (``ops/chain.py``): at
  n <= 64 the weight chain, one K1 and one K2 launch a time block on the
  card; at 256 < padded n <= 512 the streamed route, the weights x basis
  planes (M, B, n, n) through the plane chain op, one K6 forward and one
  K6 adjoint launch a time block;
- the blocked route, for everything else (Magnus M4/M6, any torch
  callable ``hamiltonian(params_row, controls, t)``, time-dependent
  dissipation, and 64 < padded n <= 256 or n above 512): each member's
  Magnus planes (or superoperator planes) are built under
  ``torch.func.vmap`` over the member rows, and all members' planes reach
  the batched expm (K3/K4 up to padded n = 256) as one batch a time block,
  then a tree product (or the prefix scan with step costs) per member.
  This is ``qoc_tpu``'s generic route (``allow_plane_chain=False`` under
  ``vmap``).

Step costs run on every route through the trajectory form, as in
``qoc_tpu``'s fused ensemble and its generic route, and so do the
intermediate states or densities a save file asks for
(``collect_intermediates``). The same chain loss carries the multistart
(``parallel/multistart.py``): candidates x members, candidate-major, are
the chains of one call. Save files carry the member axis on the evolved
datasets and the member rows as ``hamiltonian_params`` (``io/h5.py``).
"""

import numpy as np
import torch

from qoc_tpu_torch.config import complex_dtype, resolve
from qoc_tpu_torch.core.common import initialize_controls, slap_controls_torch
from qoc_tpu_torch.core.graperunner import run_grape
from qoc_tpu_torch.core.lindblad import (lindblad_method, rkdp5_loss,
                                         superoperator_builder)
from qoc_tpu_torch.core.schroedinger import (_not_ported, _route,
                                             _route_names, _step_cost,
                                             cost_steps, fused_weights,
                                             make_propagator, plane_builder)
from qoc_tpu_torch.io.resume import apply_resume
from qoc_tpu_torch.models import (ConstantLindblad,
                                  EnsembleLinearHamiltonian,
                                  GrapeLindbladDiscreteState,
                                  GrapeSchroedingerDiscreteState,
                                  GrapeSchroedingerResult,
                                  InterpolationPolicy, LindbladMethod,
                                  LinearHamiltonian, MagnusPolicy)
from qoc_tpu_torch.ops.chain import (chain_block_plan, segment_plan,
                                     stream_segment_plan)
from qoc_tpu_torch.optim import Adam

__all__ = ["build_chain_loss", "build_ensemble_loss",
           "grape_schroedinger_ensemble", "run_ensemble"]


def refuse_mesh(mesh):
    """The port runs on one card: a mesh raises, naming its ROADMAP
    item."""
    if mesh is not None:
        raise _not_ported("mesh (members or candidates sharded over "
                          "devices)", "6d, Queue 1 item 8")


def _fused_ok(magnus_policy, has_controls, hamiltonian, params):
    """True where the chain of weight rows against a basis applies:
    ``qoc_tpu``'s _build_fused_ensemble_loss / _make_fused_shard_loss
    (and Lindblad's _fused_eligibility) conditions, less the kernel
    limits."""
    if magnus_policy != MagnusPolicy.M2 or not has_controls:
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


class _Evolved:
    """What a chain loss evolves: a Schrödinger state's states (K, d, 1),
    propagated in dimension n = d, or a Lindblad state's densities (K, d,
    d), vectorized row-major and propagated by superoperators in n = d²
    (``core/lindblad.py``), and how each route builds its chains."""

    def __init__(self, pstate):
        self.lindblad = isinstance(pstate, GrapeLindbladDiscreteState)
        self.rkdp5 = (self.lindblad and lindblad_method(pstate)
                      != LindbladMethod.MAGNUS_EXPM)
        if self.lindblad:
            if pstate.interpolation_policy != InterpolationPolicy.LINEAR:
                raise NotImplementedError(
                    "The interpolation policy {} is not yet supported for "
                    "this method.".format(pstate.interpolation_policy))
            self.initial = np.asarray(pstate.initial_densities)
            self.magnus_policy = getattr(pstate, "magnus_policy_",
                                         MagnusPolicy.M2)
            self.lindblad_data = pstate.lindblad_data
            self.constant = isinstance(self.lindblad_data,
                                       (ConstantLindblad, type(None)))
            self.dim = self.initial.shape[-1] ** 2
        else:
            self.initial = np.asarray(pstate.initial_states)
            self.magnus_policy = pstate.magnus_policy
            self.constant = True
            self.dim = self.initial.shape[-2]

    def basis(self, hamiltonian, dt):
        """The fused and streamed routes' generator basis."""
        if not self.lindblad:
            return hamiltonian.generator_basis(dt)
        rates, operators = (self.lindblad_data(0.0)
                            if self.lindblad_data is not None
                            else (None, None))
        return hamiltonian.superoperator_basis(dt, rates, operators)

    def builder(self, cet, dt, device, cdtype):
        """h -> planes(controls, times): the blocked route's Magnus planes
        of one member's Hamiltonian h."""
        if not self.lindblad:
            return lambda h: plane_builder(h, self.magnus_policy, cet, dt)
        d = self.initial.shape[-1]
        return lambda h: superoperator_builder(
            h, self.lindblad_data, self.magnus_policy, cet, dt, d, device,
            cdtype)


def build_chain_loss(pstate, hamiltonian, hamiltonian_params, device, dtype,
                     n_candidates=1, time_block_size=None,
                     collect_intermediates=False):
    """The loss of N candidates' controls over M members, one chain each.

    ``pstate`` is a Schrödinger or a Lindblad GRAPE state
    (:class:`_Evolved`; under RKDP5 the lanes' loss,
    :func:`_rkdp5_chain_loss`). ``hamiltonian_params`` (M, ...) are the member
    rows of an ensemble-contract ``hamiltonian(params_row, controls, t)``,
    or None for one member of a plain ``hamiltonian(controls, t)``. Returns
    ``loss(controls)``, which maps complex controls (N, E, C) to (errors
    (N, M), final states (N, M, K, d, 1) or densities (N, M, K, d, d)),
    differentiable; with ``collect_intermediates`` also the states or
    densities at every system step, step 0 included, (N, M,
    system_eval_count, ...) (the trajectory form, forward only under
    RKDP5); its ``route`` is "fused", "stream", "blocked" or "rkdp5"
    (module docstring), ``dim`` the propagated dimension n, ``lindblad``
    the kind, ``n_steps``, ``trajectory`` (step costs) and ``block`` the
    time block in steps, sized for ``n_candidates`` (``chain_block_plan``
    counts the N M chains)."""
    params = (None if hamiltonian_params is None
              else np.asarray(hamiltonian_params))
    cdtype = complex_dtype(dtype)
    kind = _Evolved(pstate)
    if kind.rkdp5:
        return _rkdp5_chain_loss(pstate, hamiltonian, params, device, dtype,
                                 collect_intermediates)
    initial = torch.as_tensor(kind.initial, dtype=cdtype, device=device)
    shape, n = tuple(initial.shape), kind.dim
    dt = float(pstate.dt)
    n_steps = pstate.system_eval_count - 1
    final_step = pstate.final_system_eval_step
    step_costs = pstate.step_costs
    final_costs = [cost for cost in pstate.costs
                   if not cost.requires_step_evaluation]
    cost_eval_step = pstate.cost_eval_step
    trajectory = bool(step_costs) or collect_intermediates
    n_members = 1 if params is None else params.shape[0]
    times = torch.arange(n_steps, dtype=dtype, device=device) * dt
    cet = (torch.as_tensor(pstate.control_eval_times, dtype=dtype,
                           device=device)
           if pstate.control_eval_times is not None else None)
    route = _route(n, kind.constant and _fused_ok(
        kind.magnus_policy, cet is not None, hamiltonian, params), False)
    trajectory_steps = n_steps if trajectory else 0
    if route in ("fused", "stream"):
        delta = (None if params is None
                 else torch.as_tensor(params, dtype=dtype, device=device))
        propagate, planes_per_step = make_propagator(
            route, kind.magnus_policy, device, dtype,
            basis=kind.basis(hamiltonian, dt),
            weights=lambda controls, t_block: _member_weights(
                fused_weights(controls, t_block, cet, dt), delta),
            trajectory_steps=trajectory_steps)
    else:
        planes = _member_planes(kind.builder(cet, dt, device, cdtype),
                                hamiltonian, params, device, dtype)
        propagate, planes_per_step = make_propagator(
            route, kind.magnus_policy, device, dtype, planes=planes,
            trajectory_steps=trajectory_steps)
    block = int(time_block_size or chain_block_plan(
        n, n_steps, cdtype.itemsize, planes_per_step,
        n_candidates * n_members))
    # Each chain's states or densities as rows (R, K, n): x <- x P^T.
    x0 = initial.reshape(shape[0], n)

    def loss(controls):
        n_c = controls.shape[0]
        # Each chain's controls, candidate-major (the costs take them).
        chain_controls = controls.repeat_interleave(n_members, dim=0)
        x = x0.expand((n_c * n_members,) + x0.shape)
        errors = torch.zeros((n_c * n_members,), dtype=dtype, device=device)
        intermediates = [x[:, None]]
        for start in range(0, n_steps, block):
            out = propagate(controls, times[start:start + block])
            if not trajectory:
                x = x @ out.mT
                continue
            prod, prefixes = out
            if collect_intermediates:
                intermediates.append(x[:, None] @ prefixes.mT)
            steps = step_costs and cost_steps(
                start, prefixes.shape[-3], cost_eval_step, device)
            if steps:
                sel, ks = steps
                # The states or densities after the block's cost steps,
                # every chain: (R, steps, K, ...).
                evolved = (x[:, None] @ prefixes[:, sel].mT).reshape(
                    (x.shape[0], -1) + shape)
                errors = errors + torch.func.vmap(
                    lambda c, y: torch.func.vmap(_step_cost(
                        step_costs, c))(y, ks).sum())(chain_controls,
                                                      evolved)
            x = x @ prod.mT
        final = x.reshape((-1,) + shape)
        if final_costs:
            errors = errors + torch.func.vmap(
                lambda c, y: _step_cost(final_costs, c)(y, final_step))(
                    chain_controls, final)
        out = (errors.reshape(n_c, n_members),
               final.reshape((n_c, n_members) + shape))
        if collect_intermediates:
            out += (torch.cat(intermediates, dim=1).reshape(
                (n_c, n_members, -1) + shape),)
        return out

    loss.route, loss.block, loss.dim = route, block, n
    loss.lindblad, loss.n_steps, loss.trajectory = (kind.lindblad, n_steps,
                                                    trajectory)
    return loss


def _rkdp5_chain_loss(pstate, hamiltonian, params, device, dtype,
                      collect_intermediates=False):
    """The chain loss of a Lindblad state under RKDP5: the N M chains are
    the lanes of one adaptive integration an interval (``core/lindblad.py``
    ``rkdp5_loss``; ``qoc_tpu``'s generic route, its members and candidates
    under ``jax.vmap``; with ``collect_intermediates`` the forward-only
    integrator). Its ``route`` is "rkdp5", ``block`` 1 (one interval a
    step of the loop)."""
    lanes_loss = rkdp5_loss(pstate, device, dtype, hamiltonian, params,
                            differentiable=not collect_intermediates,
                            collect_intermediates=collect_intermediates)
    n_members = 1 if params is None else params.shape[0]
    shape = tuple(np.shape(pstate.initial_densities))

    def loss(controls):
        out = lanes_loss(controls)
        n_c = controls.shape[0]
        chains = (n_c, n_members)
        if collect_intermediates:
            return (out[0].reshape(chains), out[1].reshape(chains + shape),
                    out[2].movedim(0, 1).reshape(chains + (-1,) + shape))
        return out[0].reshape(chains), out[1].reshape(chains + shape)

    loss.route, loss.block, loss.dim = "rkdp5", 1, shape[-1] ** 2
    loss.lindblad, loss.n_steps = True, pstate.system_eval_count - 1
    loss.trajectory = bool(pstate.step_costs)
    return loss


def _member_planes(build, hamiltonian, params, device, dtype):
    """planes(controls (N, E, C), t_block) -> (N M, B, n, n): every
    candidate's and member's Magnus planes, ``build(h)(controls, times)``
    of each member's Hamiltonian h, built under ``torch.func.vmap`` over
    the candidates and the member rows."""
    if params is None:
        one = build(hamiltonian)

        def planes(controls, t_block):
            return torch.func.vmap(lambda c: one(c, t_block))(controls)
        return planes
    rows = torch.as_tensor(params, device=device,
                           dtype=(complex_dtype(dtype)
                                  if np.iscomplexobj(params) else dtype))

    def member(row, c, t_block):
        return build(lambda cc, tt: hamiltonian(row, cc, tt))(c, t_block)

    def planes(controls, t_block):
        out = torch.func.vmap(lambda c: torch.func.vmap(
            lambda row: member(row, c, t_block))(rows))(controls)
        return out.reshape((-1,) + out.shape[2:])
    return planes


def describe_route(chain_loss, device, n_chains):
    """(path, kernels, packing) of a chain loss for the one-time path log:
    the chain routes name their packing, grouped (one segment a chain) or
    segmented (S_m segments a chain), and the rows S x L of one launch."""
    if chain_loss.route == "rkdp5":
        return ("adaptive RKDP5 integrator", "plain torch on " + device.type,
                "{} chains as lanes".format(n_chains))
    path, kernels = _route_names(chain_loss.route, chain_loss.dim, device,
                                 chain_loss.trajectory)
    if chain_loss.route == "blocked":
        return path, kernels, "{} chains in one batch".format(n_chains)
    plan = segment_plan if chain_loss.route == "fused" else \
        stream_segment_plan
    s_count, length = plan(min(chain_loss.block, chain_loss.n_steps),
                           n_chains)
    packing = ("grouped, one segment a chain" if s_count == 1 else
               "segmented, {} segments a chain".format(s_count))
    return path, kernels, "{} chains, {} (S x L = {} x {})".format(
        n_chains, packing, n_chains * s_count, length)


def build_ensemble_loss(pstate, hamiltonian, hamiltonian_params, mesh=None,
                        time_block_size=None, log_path=False, device=None,
                        dtype=None):
    """The ensemble loss (``qoc_tpu`` ensemble.py:60-130): controls (E, C)
    -> (mean_m error_m, final states (M, K, d, 1)), differentiable w.r.t.
    the controls; for a Lindblad state the final densities (M, K, d, d)
    (``parallel/lindblad.py``). ``hamiltonian(params_row, controls, t) ->
    (d, d)`` is one member's Hamiltonian (a torch callable, or an
    :class:`EnsembleLinearHamiltonian`), one member a row of
    ``hamiltonian_params``. The loss's ``uses_fused_chain`` says whether it
    took a chain route, fused or streamed, and ``route`` which (module
    docstring). ``device``/``dtype`` as the entry points' (default the card
    in float32); ``block`` is its time block in steps."""
    refuse_mesh(mesh)
    device, dtype = resolve(device, dtype, float64_ok=_Evolved(pstate).rkdp5)
    params = np.asarray(hamiltonian_params)
    if params.ndim < 1 or params.shape[0] < 1:
        raise ValueError("hamiltonian_params must hold one row per member; "
                         "got shape {}".format(params.shape))
    chain_loss = build_chain_loss(pstate, hamiltonian, params, device, dtype,
                                  time_block_size=time_block_size)
    if log_path:
        path, kernels, packing = describe_route(chain_loss, device,
                                                params.shape[0])
        print("qoc_tpu_torch: {}ensemble propagation path = {}, {} "
              "(member-batched: {}, block={}).".format(
                  "Lindblad " if chain_loss.lindblad else "", path, kernels,
                  packing, chain_loss.block))

    def loss(controls):
        errors, evolved = chain_loss(controls[None])
        return errors[0].mean(), evolved[0]

    loss.uses_fused_chain = chain_loss.route in ("fused", "stream")
    loss.route, loss.block = chain_loss.route, chain_loss.block
    return loss


def run_ensemble(pstate, hamiltonian, hamiltonian_params, result, device,
                 dtype, time_block_size=None, evolved="states",
                 resume_from=None):
    """Mark ``pstate`` as the ensemble's, build its loss and run the GRAPE
    loop (``core/graperunner.py``) into ``result``, the save file and
    ``resume_from`` included (the intermediate stack of a save row (S, M,
    ...) by the chain loss's trajectory form): the body of
    :func:`grape_schroedinger_ensemble` and of
    ``grape_lindblad_ensemble`` (``evolved="densities"``)."""
    pstate.set_ensemble(hamiltonian_params)
    if resume_from is not None:
        apply_resume(pstate, resume_from)
    loss_controls = build_ensemble_loss(pstate, hamiltonian,
                                        hamiltonian_params,
                                        time_block_size=time_block_size,
                                        log_path=pstate.should_log,
                                        device=device, dtype=dtype)
    pstate.log_and_save_initial()
    cc, shape = pstate.complex_controls, pstate.controls_shape

    def loss_flat(flat_params):
        return loss_controls(slap_controls_torch(cc, flat_params, shape))

    collect_fn = None
    if getattr(pstate, "save_intermediate_{}_".format(evolved)):
        collect_loss = build_chain_loss(
            pstate, hamiltonian, np.asarray(hamiltonian_params), device,
            dtype, time_block_size=time_block_size,
            collect_intermediates=True)

        def collect_fn(flat):
            controls = slap_controls_torch(cc, flat, shape)
            return collect_loss(controls[None])[2][0].movedim(1, 0)

    run_grape(pstate, result, loss_flat, device, dtype, evolved=evolved,
              collect_fn=collect_fn)
    return result


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
    ``result.best_final_states`` is (n_members, K, d, 1), and so are the
    save file's rows, beside ``hamiltonian_params``. One card: ``mesh``
    other than None raises (ROADMAP Queue 1, item 8); ``optimizer=None`` is
    a fresh ``Adam()``, and every optimizer, ``impose_control_conditions``
    hook, save file and ``resume_from`` of
    :func:`grape_schroedinger_discrete` runs."""
    refuse_mesh(mesh)
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
    pstate.fused_chunk = fused_chunk
    return run_ensemble(pstate, hamiltonian, hamiltonian_params,
                        GrapeSchroedingerResult(), device, dtype,
                        time_block_size, resume_from=resume_from)
