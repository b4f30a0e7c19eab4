"""Step costs and trajectories in the port against qoc_tpu (float64, CPU).

- The chain ops' trajectory form (``return_prefixes``): the plain K2/K5
  per-step-seed paths at d <= 8 (3 and 37 steps) and K6's segmented plan at
  d = 260 (3 steps) against ``chain_expm_propagate_reference(...,
  return_prefixes=True)`` with ``jax.vjp`` on both outputs (relative 1e-6
  forward, 1e-5 gradient: tests/test_torch_chain.py's tolerances, the
  port's f32-calibrated ladder against an f64 expm); ``gradcheck`` through
  both outputs and either alone; and the invariant that per-step seeds
  zero but at the last step give the last-step mode bitwise.
- The step costs (TargetStateInfidelityTime, ForbidStates,
  TargetDensityInfidelityTime, ForbidDensities) and their conversions:
  1e-12 against qoc_tpu's (the same float64 arithmetic).
- build_schroedinger_loss with step costs at cost_eval_step 1 and 3 on the
  fused, plane and blocked routes, and build_lindblad_loss with density
  step costs on the fused and plane routes: atol 1e-8 on losses, relative
  1e-6 on gradients. evolve's intermediate states and densities: atol
  1e-8. A 5-iteration step-cost GRAPE and grape_unitary: per-iteration
  errors atol 1e-6, best controls 1e-5 (tests/test_torch_schroedinger.py's
  GRAPE tolerances).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import LindbladProblem, Problem, anti_hermitian_basis
from torch_parity import f32_exact, random_density

torch.set_num_threads(1)

FWD_RTOL = 1e-6
GRAD_RTOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_trajectory(w, basis, cotangents):
    """qoc_tpu's reference chain (total, prefixes) and, by jax.vjp, the
    weight gradient for PyTorch-convention output gradients (the JAX
    cotangents are their conjugates)."""
    from qoc_tpu.ops.chain_pallas import chain_expm_propagate_reference

    @jax.jit
    def trajectory_and_grad(ww, cts):
        out, vjp = jax.vjp(lambda x: chain_expm_propagate_reference(
            x, basis, return_prefixes=True), ww)
        return out, vjp(cts)[0]

    out, grad = trajectory_and_grad(jnp.asarray(w), tuple(
        jnp.conjugate(jnp.asarray(c)) for c in cotangents))
    return [np.asarray(x) for x in out], np.asarray(grad)


def _port_trajectory(op, w, cotangents):
    wt = torch.tensor(w, requires_grad=True)
    out = op(wt)
    grad, = torch.autograd.grad(out, wt, [torch.as_tensor(c)
                                          for c in cotangents])
    return [x.detach().numpy() for x in out], grad.numpy()


def _chain_case(seed, d, n_steps, n_b, target_norm, general=False):
    """f32-exact weights, a basis scaled to batch-max 1-norm
    ``target_norm`` (anti-Hermitian, or ``general`` complex matrices), and
    random output gradients for the total and every prefix."""
    rng = np.random.default_rng(seed)
    if general:
        base = rng.normal(size=(n_b, d, d)) + 1j * rng.normal(
            size=(n_b, d, d))
    else:
        base = anti_hermitian_basis(rng, n_b, d)
    w = f32_exact(rng.normal(size=(n_steps, n_b)))
    norm1 = np.abs(np.einsum("jk,kab->jab", w, base)).sum(-2).max()
    basis = base * (target_norm / norm1)
    cotangents = [rng.normal(size=shape) + 1j * rng.normal(size=shape)
                  for shape in ((d, d), (n_steps, d, d))]
    return w, basis, cotangents


def _planes_op(basis):
    """The plane op's trajectory form on the planes w @ basis."""
    from qoc_tpu_torch.ops.chain import plane_chain_propagate_prefixes
    n_b, d = basis.shape[0], basis.shape[-1]
    g = torch.as_tensor(basis).reshape(n_b, d * d)
    return lambda wt: plane_chain_propagate_prefixes(
        (wt.to(g.dtype) @ g).reshape(-1, d, d))


@functools.lru_cache(maxsize=None)
def _reference_case(d, n_steps, target_norm):
    """A _chain_case and qoc_tpu's reference trajectory for it, computed
    once for both ops."""
    w, basis, cotangents = _chain_case(10 * d + n_steps, d, n_steps, 3,
                                       target_norm)
    return (w, basis, cotangents) + tuple(_jax_trajectory(w, basis,
                                                          cotangents))


@pytest.mark.parametrize("op", ("chain", "plane"))
@pytest.mark.parametrize("d,n_steps,target_norm", ((4, 3, 0.3),
                                                   (8, 37, 7.0)))
def test_trajectory_ops_match_jax_reference(op, d, n_steps, target_norm):
    """The plain per-step-seed K2 (chain op) and K5 (plane op) paths: total,
    prefixes and the weight gradient from gradients on both outputs, on
    ladder levels 1 and 4 (squarings), at 1 and 5 segments."""
    from qoc_tpu_torch.ops.chain import ChainExpmPropagate
    w, basis, cotangents, (want_total, want_pref), g_want = \
        _reference_case(d, n_steps, target_norm)
    port = (ChainExpmPropagate(basis, "cpu", torch.float64,
                               return_prefixes=True)
            if op == "chain" else _planes_op(basis))
    (total, pref), g_got = _port_trajectory(port, w, cotangents)
    assert pref.shape == (n_steps, d, d)
    assert _rel(total, want_total) < FWD_RTOL
    assert _rel(pref, want_pref) < FWD_RTOL
    assert _rel(g_got, g_want) < GRAD_RTOL


def test_stream_plan_trajectory_matches_jax_reference():
    """The plane op at d = 260 (K6's segment plan: 3 segments of 1 step)
    on general, non-normal planes."""
    from qoc_tpu_torch.ops.chain import stream_segment_plan
    assert stream_segment_plan(3) == (3, 1)
    w, basis, cotangents = _chain_case(5, 260, 3, 2, 0.5, general=True)
    (want_total, want_pref), g_want = _jax_trajectory(w, basis, cotangents)
    (total, pref), g_got = _port_trajectory(_planes_op(basis), w, cotangents)
    assert _rel(total, want_total) < FWD_RTOL
    assert _rel(pref, want_pref) < FWD_RTOL
    assert _rel(g_got, g_want) < GRAD_RTOL


@pytest.mark.parametrize("outputs", ("both", "total", "prefixes"))
@pytest.mark.parametrize("op", ("chain", "plane"))
def test_trajectory_ops_gradcheck(op, outputs):
    """Exact gradients (finite differences, float64) through both outputs
    and through either alone (the other output's gradient is None), at 3
    segments with padded steps, on general complex generators."""
    from qoc_tpu_torch.ops.chain import (ChainExpmPropagate,
                                         plane_chain_propagate_prefixes)
    rng = np.random.default_rng(4)
    d, n_steps = 3, 21
    if op == "chain":
        basis = 0.3 * (rng.normal(size=(2, d, d))
                       + 1j * rng.normal(size=(2, d, d)))
        fn = ChainExpmPropagate(basis, "cpu", torch.float64,
                                return_prefixes=True)
        x = torch.tensor(rng.normal(size=(n_steps, 2)), requires_grad=True)
    else:
        fn = plane_chain_propagate_prefixes
        x = torch.tensor(0.3 * (rng.normal(size=(n_steps, d, d))
                                + 1j * rng.normal(size=(n_steps, d, d))),
                         requires_grad=True)
    pick = {"both": lambda out: out, "total": lambda out: out[0],
            "prefixes": lambda out: out[1]}[outputs]
    assert torch.autograd.gradcheck(lambda v: pick(fn(v)), (x,),
                                    fast_mode=True)


@pytest.mark.parametrize("kernel", ("chain", "plane"))
def test_per_step_mode_with_last_seed_only_is_the_last_step_mode(kernel):
    """Seeds zero at every step but the last: the per-step-seed mode of the
    plain K2 / K5 (and K6, whose plain version is K5's) equals the
    last-step mode bitwise."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(8)
    s_count, length, d, n_b = 3, 9, 5, 2
    basis = torch.as_tensor(anti_hermitian_basis(rng, n_b, d) * 0.4)
    w = torch.as_tensor(rng.normal(size=(s_count, length, n_b)))
    norm = torch.tensor(0.9, dtype=torch.float64)
    last = torch.as_tensor(rng.normal(size=(s_count, d, d))
                           + 1j * rng.normal(size=(s_count, d, d)))
    per_step = torch.zeros((s_count, length, d, d), dtype=last.dtype)
    per_step[:, -1] = last
    assert chain.per_step_seeds(per_step)
    assert not chain.per_step_seeds(last)
    if kernel == "chain":
        pref = chain.chain_fwd(w, basis, norm)
        basis_h = basis.mH.contiguous()
        run = lambda seeds: chain.chain_bwd(  # noqa: E731
            w, basis_h, norm, pref, seeds)
    else:
        a = chain._generators(w.reshape(-1, n_b), basis).reshape(
            s_count, length, d, d)
        pref = chain.plane_fwd(a, norm)
        run = lambda seeds: chain.plane_bwd(a, norm, pref, seeds)  # noqa
    assert torch.equal(run(per_step), run(last))


def _jax_states(n, k, d):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(k, d, 1)) + 1j * rng.normal(size=(k, d, 1))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("cost", ("TargetStateInfidelityTime",
                                  "ForbidStates uniform",
                                  "ForbidStates ragged",
                                  "TargetDensityInfidelityTime",
                                  "ForbidDensities uniform",
                                  "ForbidDensities ragged"))
def test_step_costs_and_conversions_match_jax(cost):
    """Each step cost and its convert.py function: the value at a random
    state or density batch (also under torch.func.vmap over a stack of
    them, as the losses evaluate it), the flag, and the normalization."""
    from qoc_tpu import standard
    from qoc_tpu_torch import convert
    rng = np.random.default_rng(1)
    d, k, count, step = 3, 2, 13, 3
    if "Density" in cost:
        x = np.stack([np.stack([random_density(rng, d) for _ in range(k)])
                      for _ in range(4)])
        targets = x[0]
    else:
        x = np.stack([_jax_states(j, k, d) for j in range(4)])
        targets = _jax_states(9, k, d)
    if cost == "TargetStateInfidelityTime":
        jax_cost = standard.TargetStateInfidelityTime(
            count, targets, step, cost_multiplier=0.7,
            neglect_relative_phase=True)
        port = convert.target_state_infidelity_time(jax_cost)
        assert port.cost_eval_count == jax_cost.cost_eval_count == 4
    elif cost == "TargetDensityInfidelityTime":
        jax_cost = standard.TargetDensityInfidelityTime(count, targets, step,
                                                        cost_multiplier=0.7)
        port = convert.target_density_infidelity_time(jax_cost)
        assert port.cost_eval_count == jax_cost.cost_eval_count == 4
    else:
        forbidden = (x[1][:, None] if "uniform" in cost
                     else [x[1][:1], x[1:3, 1]])
        cls = "ForbidDensities" if "Density" in cost else "ForbidStates"
        jax_cost = getattr(standard, cls)(forbidden, count, step,
                                          cost_multiplier=0.7)
        port = {"ForbidStates": convert.forbid_states,
                "ForbidDensities": convert.forbid_densities}[cls](jax_cost)
        assert (port.cost_normalization_constant
                == jax_cost.cost_normalization_constant == 8)
    assert port.requires_step_evaluation and jax_cost.requires_step_evaluation
    assert port.cost_multiplier == jax_cost.cost_multiplier
    want = [float(jax_cost.cost(None, jnp.asarray(xj), 1)) for xj in x]
    got = [float(port.cost(None, torch.as_tensor(xj), 1)) for xj in x]
    vmapped = torch.func.vmap(lambda xj: port.cost(None, xj, 1))(
        torch.as_tensor(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(vmapped.numpy(), want, rtol=0, atol=1e-12)


# qoc_tpu's loss and gradient by problem, computed once for the routes
# that share a problem.
_JAX_RESULTS = {}


def _loss_and_gradient_both(key, jax_pstate, torch_pstate, build, jax_build,
                            n_c, n_steps, controls, **port_kwargs):
    """qoc_tpu's loss and control gradient on its CPU route (once per
    ``key``), and the port's with ``port_kwargs`` (float64)."""
    from qoc_tpu.core.common import slap_controls_jax
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    shape = (n_steps, n_c)
    flat = strip_controls(True, controls)
    if key not in _JAX_RESULTS:
        jax_loss = jax_build(jax_pstate)
        (want, _), g_want = jax.jit(jax.value_and_grad(
            lambda f: jax_loss(slap_controls_jax(True, f, shape)),
            has_aux=True))(jnp.asarray(flat))
        _JAX_RESULTS[key] = float(want), np.asarray(g_want)
    want, g_want = _JAX_RESULTS[key]
    loss = build(torch_pstate, torch.device("cpu"), torch.float64,
                 log_path=True, **port_kwargs)
    flat_t = torch.tensor(flat, requires_grad=True)
    got, _ = loss(slap_controls_torch(True, flat_t, shape))
    g_got, = torch.autograd.grad(got, flat_t)
    return float(got.detach()), want, g_got.numpy(), g_want


@pytest.mark.parametrize("cost_eval_step", (1, 3))
@pytest.mark.parametrize("route,path", (
    ("fused", "fused chain"), ("fused blocks", "fused chain"),
    ("plane", "plane chain"), ("blocked", "blocked expm + prefix scan")))
def test_schroedinger_step_cost_loss_matches_jax(route, path, cost_eval_step,
                                                 capsys):
    """TargetStateInfidelity + ForbidStates + TargetStateInfidelityTime:
    the fused route (d = 4; also in time blocks of 7 steps), the plane route
    (an M4 callable) and the blocked route (the same, allow_plane_chain=
    False, blocks of 5), each on its trajectory form."""
    from qoc_tpu.core.schroedinger import (
        build_schroedinger_loss as jax_build)
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    problem = Problem(n_steps=23)
    magnus, kwargs = "M2", {}
    if route == "fused blocks":
        kwargs = dict(time_block_size=7)
    elif route in ("plane", "blocked"):
        problem.use_callables()
        magnus = "M4"
        if route == "blocked":
            kwargs = dict(allow_plane_chain=False, time_block_size=5)
    problem.add_step_costs(cost_eval_step)
    got, want, g_got, g_want = _loss_and_gradient_both(
        (magnus, cost_eval_step), problem.jax_pstate(magnus=magnus),
        problem.torch_pstate(
            magnus=magnus), build_schroedinger_loss, jax_build, problem.n_c,
        problem.n_steps, problem.controls, **kwargs)
    out = capsys.readouterr().out
    assert "propagation path = " + path in out
    assert "per-step prefixes" in out
    assert got == pytest.approx(want, abs=1e-8)
    assert _rel(g_got, g_want) < GRAD_RTOL / 10


@pytest.mark.parametrize("route,path", (("fused", "fused chain"),
                                        ("plane", "plane chain")))
def test_lindblad_step_cost_loss_matches_jax(route, path, capsys):
    """TargetDensityInfidelity + ForbidDensities (ragged) +
    TargetDensityInfidelityTime at cost_eval_step 2: the fused route
    (d = 2) and the plane route (a d = 3 callable)."""
    from qoc_tpu.core.lindblad import build_lindblad_loss as jax_build
    from qoc_tpu_torch.core.lindblad import build_lindblad_loss
    if route == "fused":
        problem = LindbladProblem(d=2, n_steps=12)
    else:
        problem = LindbladProblem(d=3, n_steps=10).use_callables()
    problem.add_step_costs(2)
    got, want, g_got, g_want = _loss_and_gradient_both(
        route, problem.pstate("jax"), problem.pstate("torch"),
        build_lindblad_loss, jax_build, problem.n_c, problem.n_steps,
        problem.controls)
    out = capsys.readouterr().out
    assert "Lindblad propagation path = " + path in out
    assert "per-step prefixes" in out
    assert got == pytest.approx(want, abs=1e-8)
    assert _rel(g_got, g_want) < GRAD_RTOL / 10


@pytest.mark.parametrize("route", ("fused", "blocked"))
def test_evolve_intermediate_states_match_jax(route):
    """evolve_schroedinger_discrete(save_intermediate_states=True) without a
    save file: the (system_eval_count, K, d, 1) stack, step 0 first, the
    final states and the error with step costs, on the fused route and
    (an M4 callable at d = 72) the blocked route."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.models import MagnusPolicy as JaxMagnus
    from qoc_tpu_torch.models import MagnusPolicy
    problem = Problem(n_steps=17)
    magnus = "M2"
    if route == "blocked":
        problem = Problem(d=72, n_c=1, n_steps=5).use_callables()
        magnus = "M4"
    problem.add_step_costs(2)
    args = (problem.evolution_time, problem.jax_hamiltonian, problem.initial,
            problem.n_steps)
    common = dict(controls=problem.controls, cost_eval_step=2,
                  save_intermediate_states=True)
    want = qoc_tpu.evolve_schroedinger_discrete(
        *args, costs=problem.jax_costs, magnus_policy=JaxMagnus[magnus],
        **common)
    got = qoc_tpu_torch.evolve_schroedinger_discrete(
        problem.evolution_time, problem.torch_hamiltonian,
        problem.torch_initial, problem.n_steps, costs=problem.torch_costs,
        magnus_policy=MagnusPolicy[magnus], device="cpu", **common)
    assert got.intermediate_states.shape == (problem.n_steps, 1,
                                             problem.d, 1)
    np.testing.assert_allclose(got.intermediate_states,
                               np.asarray(want.intermediate_states), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.final_states,
                               got.intermediate_states[-1], rtol=0,
                               atol=1e-12)
    assert got.error == pytest.approx(want.error, abs=1e-8)


def test_evolve_intermediate_densities_match_jax():
    """evolve_lindblad_discrete(save_intermediate_densities=True) without a
    save file, with density step costs: the (system_eval_count, K, d, d)
    stack and the error."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.models import LindbladMethod as JaxMethod
    from qoc_tpu_torch.models import LindbladMethod
    problem = LindbladProblem(d=2, n_steps=9).add_step_costs(1)
    common = dict(controls=problem.controls,
                  save_intermediate_densities=True)
    want = qoc_tpu.evolve_lindblad_discrete(
        problem.evolution_time, problem.initial, problem.n_steps,
        costs=problem.jax_costs, hamiltonian=problem.jax_hamiltonian,
        lindblad_data=problem.jax_lindblad, method=JaxMethod.MAGNUS_EXPM,
        **common)
    got = qoc_tpu_torch.evolve_lindblad_discrete(
        problem.evolution_time, problem.torch_initial, problem.n_steps,
        costs=problem.torch_costs, hamiltonian=problem.torch_hamiltonian,
        lindblad_data=problem.torch_lindblad,
        method=LindbladMethod.MAGNUS_EXPM, device="cpu", **common)
    assert got.intermediate_densities.shape == (9, 2, 2, 2)
    np.testing.assert_allclose(got.intermediate_densities,
                               np.asarray(want.intermediate_densities),
                               rtol=0, atol=1e-8)
    assert got.error == pytest.approx(want.error, abs=1e-8)


_JAX_GRAPES = {}


def _grape_kwargs(problem, iterations, **kwargs):
    return dict(complex_controls=True, iteration_count=iterations,
                log_iteration_step=0, cost_eval_step=problem.cost_eval_step,
                initial_controls=problem.controls,
                max_control_norms=problem.max_control_norms, **kwargs)


def _jax_grape(problem, iterations, key):
    """qoc_tpu's GRAPE result on ``problem``, computed once per ``key`` for
    the tests that share it."""
    import qoc_tpu
    if key not in _JAX_GRAPES:
        _JAX_GRAPES[key] = qoc_tpu.grape_schroedinger_discrete(
            problem.n_c, problem.n_steps, problem.jax_costs,
            problem.evolution_time, problem.jax_hamiltonian,
            problem.initial, problem.n_steps,
            **_grape_kwargs(problem, iterations))
    return _JAX_GRAPES[key]


def _port_grape(problem, iterations, **kwargs):
    import qoc_tpu_torch
    return qoc_tpu_torch.grape_schroedinger_discrete(
        problem.n_c, problem.n_steps, problem.torch_costs,
        problem.evolution_time, problem.torch_hamiltonian,
        problem.torch_initial, problem.n_steps, device="cpu",
        **_grape_kwargs(problem, iterations, **kwargs))


def test_step_cost_grape_trajectory_matches_jax():
    """5 Adam iterations with the step costs (fused route, cost_eval_step
    3): per-iteration errors, the best iterate and its controls."""
    problem = Problem(n_steps=25).add_step_costs(3)
    want = _jax_grape(problem, 5, "step costs")
    got = _port_grape(problem, 5)
    assert got.iteration_count_ran == want.iteration_count_ran == 5
    np.testing.assert_allclose(got.errors, want.errors, rtol=0, atol=1e-6)
    assert got.best_iteration == want.best_iteration
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-5)
    assert got.errors[-1] < got.errors[0]


@pytest.mark.parametrize("case", ("schroedinger step cost",
                                  "schroedinger save_intermediate_states",
                                  "lindblad step cost",
                                  "lindblad save_intermediate_densities"))
def test_formerly_refused_grape_runs_match_jax(case):
    """What the port refused before it had step costs: a step cost in the
    cost list, and the intermediate flag without a save file (ignored, as
    qoc_tpu ignores it), both on a step-cost problem. Two GRAPE iterations
    against qoc_tpu's (its run without the flag, shared between cases)."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.models import LindbladMethod as JaxMethod
    from qoc_tpu_torch.models import LindbladMethod
    flag = {}
    if case.startswith("schroedinger"):
        if "intermediate" in case:
            flag = dict(save_intermediate_states=True)
        # The first two iterations of the 5-iteration step-cost run.
        problem = Problem(n_steps=25).add_step_costs(3)
        want = _jax_grape(problem, 5, "step costs")
        got = _port_grape(problem, 2, **flag)
    else:
        if "intermediate" in case:
            flag = dict(save_intermediate_densities=True)
        problem = LindbladProblem(d=2, n_steps=8).add_step_costs()
        common = dict(complex_controls=True, iteration_count=2,
                      initial_controls=problem.controls, log_iteration_step=0,
                      max_control_norms=problem.max_control_norms)
        args = (problem.n_c, problem.n_steps)
        if "lindblad" not in _JAX_GRAPES:
            _JAX_GRAPES["lindblad"] = qoc_tpu.grape_lindblad_discrete(
                *args, problem.jax_costs, problem.evolution_time,
                problem.initial, problem.n_steps,
                hamiltonian=problem.jax_hamiltonian,
                lindblad_data=problem.jax_lindblad,
                method=JaxMethod.MAGNUS_EXPM, **common)
        want = _JAX_GRAPES["lindblad"]
        got = qoc_tpu_torch.grape_lindblad_discrete(
            *args, problem.torch_costs, problem.evolution_time,
            problem.torch_initial, problem.n_steps,
            hamiltonian=problem.torch_hamiltonian,
            lindblad_data=problem.torch_lindblad,
            method=LindbladMethod.MAGNUS_EXPM, device="cpu", **common,
            **flag)
    assert got.iteration_count_ran == 2
    np.testing.assert_allclose(got.errors, np.asarray(want.errors)[:2],
                               rtol=0, atol=1e-6)


def test_grape_unitary_matches_jax():
    """grape_unitary (a d = 2 X gate, 3 iterations) with a ForbidStates
    step cost among its extra costs: per-iteration errors and the best
    controls against qoc_tpu's."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.standard import ForbidStates
    from qoc_tpu_torch import convert
    problem = Problem(d=2, n_c=1, n_steps=10)
    forbid = ForbidStates(np.array([[[[0.6], [0.8]]], [[[0.8], [-0.6]]]]),
                          problem.n_steps)
    gate = np.array([[0, 1], [1, 0]], dtype=complex)
    common = dict(complex_controls=True, iteration_count=3,
                  log_iteration_step=0, initial_controls=problem.controls,
                  max_control_norms=problem.max_control_norms)
    want = qoc_tpu.grape_unitary(
        1, problem.n_steps, problem.evolution_time, problem.jax_hamiltonian,
        gate, problem.n_steps, extra_costs=[forbid], **common)
    got = qoc_tpu_torch.grape_unitary(
        1, problem.n_steps, problem.evolution_time,
        problem.torch_hamiltonian, gate, problem.n_steps,
        extra_costs=[convert.forbid_states(forbid)], device="cpu", **common)
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-5)
    assert got.best_final_states.shape == (2, 2, 1)
