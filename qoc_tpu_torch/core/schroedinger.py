"""Schrödinger-equation evolution and GRAPE.

Counterpart of ``qoc_tpu/core/schroedinger.py``, fused route: a
``LinearHamiltonian`` under Magnus-M2 with final-state costs propagates
through the expm-product chain op (``ops/chain.py``), whose kernels K1/K2
carry it on CUDA. Steps run in time blocks (``chain_block_plan``; the
Table-3 headline is one block) composed by a Python loop, and autograd
chains the blocks' exact gradients.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP slice: other Hamiltonians and Magnus M4/M6 (the generic expm
route, slice 2), step costs and intermediate states (the per-step-seed
chain, slice 2), ``impose_control_conditions`` (the host loop, slice 3),
save files and resume (slice 4) and ``mesh`` (slice 6).
"""

import numpy as np
import torch

from qoc_tpu_torch.config import complex_dtype, resolve
from qoc_tpu_torch.core.common import initialize_controls, slap_controls_torch
from qoc_tpu_torch.core.graperunner import run_grape
from qoc_tpu_torch.models import (EvolveSchroedingerDiscreteState,
                                  EvolveSchroedingerResult,
                                  GrapeSchroedingerDiscreteState,
                                  GrapeSchroedingerResult,
                                  InterpolationPolicy, LinearHamiltonian,
                                  MagnusPolicy)
from qoc_tpu_torch.ops.chain import ChainExpmPropagate, chain_block_plan
from qoc_tpu_torch.ops.interpolate import interpolate_linear_set
from qoc_tpu_torch.optim import Adam

__all__ = ["build_schroedinger_loss", "evolve_schroedinger_discrete",
           "fused_weights", "grape_schroedinger_discrete"]


def _not_ported(what, roadmap_slice):
    return NotImplementedError(
        "{} is not ported to qoc_tpu_torch yet (ROADMAP slice {}); use "
        "qoc_tpu for it.".format(what, roadmap_slice))


def fused_weights(controls, times, control_eval_times, dt):
    """Weight rows [1, Re c_1, Im c_1, ...] of the chain op, with the
    controls interpolated at the step midpoints ``times + dt/2``
    (``qoc_tpu`` schroedinger.py fused_weights)."""
    c_mid = interpolate_linear_set(times + dt / 2, control_eval_times,
                                   controls)
    imag = (torch.imag(c_mid) if c_mid.is_complex()
            else torch.zeros_like(c_mid))
    ri = torch.stack((torch.real(c_mid), imag), dim=-1).reshape(
        c_mid.shape[0], 2 * c_mid.shape[-1])
    ones = torch.ones((c_mid.shape[0], 1), dtype=ri.dtype,
                      device=ri.device)
    return torch.cat((ones, ri), dim=-1)


def build_schroedinger_loss(pstate, device, dtype, time_block_size=None,
                            log_path=False):
    """The loss: controls (a (E, C) tensor, or None) -> (error,
    final_states), differentiable w.r.t. the controls.

    Mirrors the fused route of ``qoc_tpu``'s build_schroedinger_loss
    (reference _evaluate_schroedinger_discrete, schroedingerdiscrete.py:
    356-438, without step costs)."""
    if pstate.interpolation_policy != InterpolationPolicy.LINEAR:
        raise NotImplementedError(
            "The interpolation policy {} is not yet supported for this "
            "method.".format(pstate.interpolation_policy))
    hamiltonian = pstate.hamiltonian
    if not isinstance(hamiltonian, LinearHamiltonian):
        raise _not_ported("A Hamiltonian that is not a LinearHamiltonian "
                          "(the generic expm route)", 2)
    if pstate.magnus_policy != MagnusPolicy.M2:
        raise _not_ported("Magnus policy {}".format(pstate.magnus_policy), 2)
    if pstate.step_costs:
        raise _not_ported("Step costs (the per-step-seed chain kernels)", 2)

    cdtype = complex_dtype(dtype)
    initial_states = torch.as_tensor(np.asarray(pstate.initial_states),
                                     dtype=cdtype, device=device)
    dt = float(pstate.dt)
    n_steps = pstate.system_eval_count - 1
    final_step = pstate.final_system_eval_step
    costs = pstate.costs
    d = initial_states.shape[-2]
    with_controls = pstate.control_eval_times is not None
    basis = hamiltonian.generator_basis(dt)
    if not with_controls:
        basis = basis[:1]            # the drift alone: weight rows [1]
    chain = ChainExpmPropagate(basis, device, dtype)
    block = int(time_block_size
                or chain_block_plan(d, n_steps, cdtype.itemsize))
    times = torch.arange(n_steps, dtype=dtype, device=device) * dt
    cet = (torch.as_tensor(pstate.control_eval_times, dtype=dtype,
                           device=device) if with_controls else None)
    if log_path:
        print("qoc_tpu_torch: propagation path = fused chain, {} "
              "(LinearHamiltonian, M2, no step costs; d={}, block={})."
              "".format("CUDA kernels K1/K2" if device.type == "cuda"
                        else "plain torch on " + device.type, d, block))

    def loss(controls):
        states = initial_states
        for start in range(0, n_steps, block):
            t_block = times[start:start + block]
            if controls is None:
                w = torch.ones((t_block.shape[0], 1), dtype=dtype,
                               device=device)
            else:
                w = fused_weights(controls, t_block, cet, dt)
            states = chain(w) @ states
        error = torch.zeros((), dtype=dtype, device=device)
        for cost in costs:
            error = error + cost.cost(controls, states, final_step)
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
    and ``dtype`` (default: the CPU in float64; CUDA runs float32).
    Returns an ``EvolveSchroedingerResult`` with ``error`` and
    ``final_states`` (host numpy)."""
    if mesh is not None:
        raise _not_ported("mesh (state sharding)", 6)
    device, dtype = resolve(device, dtype)
    costs = list(costs)
    control_eval_count = controls.shape[0] if controls is not None else 0
    pstate = EvolveSchroedingerDiscreteState(
        control_eval_count, cost_eval_step, costs, evolution_time,
        hamiltonian, initial_states, interpolation_policy, magnus_policy,
        save_file_path, save_intermediate_states, system_eval_count)
    loss = build_schroedinger_loss(pstate, device, dtype,
                                   time_block_size=time_block_size)
    if controls is not None:
        controls = torch.as_tensor(np.asarray(controls),
                                   dtype=complex_dtype(dtype), device=device)
    with torch.no_grad():
        error, final_states = loss(controls)
    result = EvolveSchroedingerResult()
    result.error = float(error)
    result.final_states = final_states.cpu().numpy()
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
    signature, plus ``device`` and ``dtype`` (default: the CPU in float64;
    CUDA runs float32). ``optimizer=None`` is a fresh ``Adam()``. The loop
    runs on the device (core/graperunner.py). Returns a
    ``GrapeSchroedingerResult`` with the best-seen controls, error, final
    states and iteration (host numpy)."""
    if impose_control_conditions is not None:
        raise _not_ported("impose_control_conditions (the host loop)", 3)
    if resume_from is not None:
        raise _not_ported("resume_from", 4)
    if mesh is not None:
        raise _not_ported("mesh (state sharding)", 6)
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
    loss_controls = build_schroedinger_loss(pstate, device, dtype,
                                            time_block_size=time_block_size,
                                            log_path=pstate.should_log)
    pstate.log_and_save_initial()
    result = GrapeSchroedingerResult()
    shape = pstate.controls_shape

    def loss_flat(flat_params):
        return loss_controls(
            slap_controls_torch(complex_controls, flat_params, shape))

    run_grape(pstate, result, loss_flat, device, dtype)
    return result
