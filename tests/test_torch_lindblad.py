"""The port's Lindblad path against qoc_tpu (float64, CPU), under
Magnus-expm: the Lindbladian and its superoperator, the superoperator basis,
the density cost, the loss and its control gradient on every route, evolve
(with an analytic T1 decay), a short Adam GRAPE, the refusals of what is
not ported yet, and the conversions (density step costs and intermediate
densities: tests/test_torch_stepcost.py); under RKDP5, the default method:
evolve with intermediate densities, a GRAPE with a density step cost, and
a GRAPE whose rkdp5_max_steps is too small (NaN errors in both packages).

On the CPU in x64 ``qoc_tpu`` takes its generic route (an XLA expm per step
of the superoperator, composed by a tree product). Tolerances: 1e-12 on the
superoperators and the cost (the same float64 arithmetic); relative 1e-8
on losses and 1e-6 on gradients (the port's f32-calibrated Taylor ladder
against an f64-accurate expm, at the small step norms of these problems,
which sit on the ladder's low-degree levels); 1e-8 on GRAPE errors and
1e-6 on the best controls; 1e-10 on evolved densities against qoc_tpu's
and 1e-9 against the analytic decay. RKDP5 at atol 1e-10: 1e-9 on
densities, errors and controls (measured 2e-11 to 5e-11; the two packages
round differently, and a mesh decision that flips on a rounding parts the
results by up to the integrator's own error).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import LindbladProblem, not_a_grape_file, saved_errors
from torch_parity import annihilation as _annihilation
from torch_parity import random_density as _density

torch.set_num_threads(1)

LOSS_RTOL = 1e-8
GRAD_RTOL = 1e-6


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_lindbladian_and_superoperator_match_jax():
    """d = 3, two channels: the Lindbladian of a batch of densities, and
    the superoperator (with and without a Hamiltonian), which applied to
    vec(rho) gives vec(L(rho))."""
    from qoc_tpu.ops.lindblad import get_lindbladian as jax_lindbladian
    from qoc_tpu.ops.lindblad import (
        lindblad_superoperator as jax_superoperator)
    from qoc_tpu_torch.ops.lindblad import (get_lindbladian,
                                            lindblad_superoperator)
    problem = LindbladProblem()
    rho = np.stack([_density(np.random.default_rng(k), 3) for k in range(4)])
    args = (problem.rates, problem.h0, problem.lops)
    want = jax_lindbladian(jnp.asarray(rho), *map(jnp.asarray, args))
    got = get_lindbladian(torch.as_tensor(rho),
                          *(torch.as_tensor(x) for x in args))
    assert _rel(got.numpy(), want) < 1e-12
    for h in (problem.h0, None):
        s_want = jax_superoperator(
            jnp.asarray(problem.rates),
            None if h is None else jnp.asarray(h), jnp.asarray(problem.lops),
            hilbert_size=3)
        s_got = lindblad_superoperator(
            torch.as_tensor(problem.rates),
            None if h is None else torch.as_tensor(h),
            torch.as_tensor(problem.lops), hilbert_size=3)
        assert _rel(s_got.numpy(), s_want) < 1e-12
    s = lindblad_superoperator(*(torch.as_tensor(x) for x in args))
    vec = (s @ torch.as_tensor(rho).reshape(4, 9, 1)).reshape(4, 3, 3)
    assert _rel(vec.numpy(), got.numpy()) < 1e-12


def test_superoperator_basis_matches_jax_and_superoperator():
    """LinearHamiltonian.superoperator_basis against qoc_tpu's, and its
    weighted sum against dt times the superoperator of H(c) with the same
    dissipation."""
    from qoc_tpu_torch.ops.lindblad import lindblad_superoperator
    problem = LindbladProblem()
    dt = 0.1
    want = problem.jax_hamiltonian.superoperator_basis(dt, problem.rates,
                                                       problem.lops)
    basis = problem.torch_hamiltonian.superoperator_basis(
        dt, problem.rates, problem.lops)
    assert _rel(basis, want) < 1e-12
    c = problem.controls[0]
    weights = np.concatenate(([1.0], np.stack((c.real, c.imag), -1).ravel()))
    h = problem.torch_hamiltonian(torch.as_tensor(c), 0.0)
    s = dt * lindblad_superoperator(torch.as_tensor(problem.rates), h,
                                    torch.as_tensor(problem.lops))
    assert _rel(np.einsum("k,kab->ab", weights, basis), s.numpy()) < 1e-12


def test_target_density_infidelity_matches_jax():
    problem = LindbladProblem()
    rho = np.stack([_density(np.random.default_rng(k), 3) for k in range(2)])
    want = problem.jax_costs[0].cost(None, jnp.asarray(rho), 0)
    got = problem.torch_costs[0].cost(None, torch.as_tensor(rho), 0)
    assert float(got) == pytest.approx(float(want), abs=1e-12)


def _jax_loss(problem, magnus):
    """qoc_tpu's loss and control gradient on its default route."""
    from qoc_tpu.core.common import slap_controls_jax
    from qoc_tpu.core.lindblad import build_lindblad_loss as jax_build_loss
    from qoc_tpu_torch.core.common import strip_controls
    shape = (problem.n_steps, problem.n_c)
    jax_loss = jax_build_loss(problem.pstate("jax", magnus))
    (want, _), g_want = jax.jit(jax.value_and_grad(
        lambda f: jax_loss(slap_controls_jax(True, f, shape)),
        has_aux=True))(jnp.asarray(strip_controls(True, problem.controls)))
    return float(want), np.asarray(g_want)


# qoc_tpu's references by (problem key, magnus), shared by the cases that
# run the same problem on two of the port's routes.
_JAX_REFERENCES = {}


def _loss_and_gradient_both(problem, magnus="M2", key=None, **port_kwargs):
    """qoc_tpu's loss and control gradient on its default route (cached
    under ``key``), and the port's with ``port_kwargs`` (CPU, float64)."""
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.core.lindblad import build_lindblad_loss

    shape = (problem.n_steps, problem.n_c)
    flat = strip_controls(True, problem.controls)
    reference = _JAX_REFERENCES.get((key, magnus))
    if reference is None:
        reference = _jax_loss(problem, magnus)
        if key is not None:
            _JAX_REFERENCES[key, magnus] = reference
    want, g_want = reference
    loss = build_lindblad_loss(problem.pstate("torch", magnus),
                               torch.device("cpu"), torch.float64,
                               log_path=True, **port_kwargs)
    flat_t = torch.tensor(flat, requires_grad=True)
    got, _ = loss(slap_controls_torch(True, flat_t, shape))
    g_got, = torch.autograd.grad(got, flat_t)
    return float(got.detach()), want, g_got.numpy(), g_want


@pytest.mark.parametrize("case,path", (
    ("d2 fused", "fused chain"),
    ("d3 callable M2", "plane chain"),
    ("d3 callable M4", "plane chain"),
    ("d3 M4 blocked", "blocked expm + tree product"),
    ("d9 blocked", "blocked expm + tree product"),
    ("d17 streamed", "streamed chain"),
))
def test_loss_and_gradient_match_jax(case, path, capsys):
    """build_lindblad_loss(MAGNUS_EXPM) on every route, each named by its
    path log line: d = 2 (d^2 = 4) the fused chain, d = 3 callables under
    M2 and M4 the plane chain (and the blocked route with
    allow_plane_chain=False), d = 9 (d^2 = 81) the blocked route, d = 17
    (d^2 = 289, padded 320) K6's streamed route."""
    magnus, kwargs, key = "M2", {}, None
    if case == "d2 fused":
        problem = LindbladProblem(d=2, n_steps=12)
    elif case.startswith("d3"):
        problem = LindbladProblem(d=3, n_steps=10).use_callables()
        magnus, key = "M4" if "M4" in case else "M2", "d3 callable"
        if "blocked" in case:
            kwargs = dict(allow_plane_chain=False, time_block_size=4)
    elif case == "d9 blocked":
        problem = LindbladProblem(d=9, n_steps=5)
    else:
        problem = LindbladProblem(d=17, n_steps=2, evolution_time=0.15)
    got, want, g_got, g_want = _loss_and_gradient_both(problem, magnus, key,
                                                       **kwargs)
    assert "Lindblad propagation path = " + path in capsys.readouterr().out
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    assert _rel(g_got, g_want) < GRAD_RTOL


def test_evolve_matches_jax_and_t1_decay():
    """evolve_lindblad_discrete's final densities against qoc_tpu's, and,
    with no Hamiltonian and one decay channel at d = 2, the excited
    population's exp(-gamma t)."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.models import LindbladMethod as JaxMethod
    from qoc_tpu_torch.models import LindbladMethod

    problem = LindbladProblem(d=3, n_steps=20)
    common = dict(controls=problem.controls)
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
    np.testing.assert_allclose(got.final_densities,
                               np.asarray(want.final_densities), rtol=0,
                               atol=1e-10)
    assert got.error == pytest.approx(want.error, abs=1e-10)

    gamma, t_end = 0.3, 2.0
    excited = np.zeros((1, 2, 2), dtype=complex)
    excited[0, 1, 1] = 1
    decay = qoc_tpu_torch.evolve_lindblad_discrete(
        t_end, excited, 41,
        lindblad_data=qoc_tpu_torch.ConstantLindblad(
            np.array([gamma]), _annihilation(2)[None]),
        method=LindbladMethod.MAGNUS_EXPM, device="cpu")
    # The generator is constant, so Magnus is exact; 1e-9 is the degree-4
    # Taylor's truncation over 40 steps of norm 0.03 (the f32 ladder).
    rho = decay.final_densities[0]
    assert rho[1, 1].real == pytest.approx(np.exp(-gamma * t_end), abs=1e-9)
    assert rho[0, 0].real == pytest.approx(1 - np.exp(-gamma * t_end),
                                           abs=1e-9)


def test_grape_trajectory_matches_jax():
    """5 Adam iterations of grape_lindblad_discrete at d = 2 (the fused
    route in the port): per-iteration errors, the best iterate and its
    controls and densities."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.models import LindbladMethod as JaxMethod
    from qoc_tpu_torch.models import LindbladMethod

    problem = LindbladProblem(d=2, n_steps=12)
    common = dict(complex_controls=True, iteration_count=5,
                  initial_controls=problem.controls, log_iteration_step=0,
                  max_control_norms=problem.max_control_norms)
    want = qoc_tpu.grape_lindblad_discrete(
        problem.n_c, problem.n_steps, problem.jax_costs,
        problem.evolution_time, problem.initial, problem.n_steps,
        hamiltonian=problem.jax_hamiltonian,
        lindblad_data=problem.jax_lindblad, method=JaxMethod.MAGNUS_EXPM,
        **common)
    got = qoc_tpu_torch.grape_lindblad_discrete(
        problem.n_c, problem.n_steps, problem.torch_costs,
        problem.evolution_time, problem.torch_initial, problem.n_steps,
        hamiltonian=problem.torch_hamiltonian,
        lindblad_data=problem.torch_lindblad,
        method=LindbladMethod.MAGNUS_EXPM, device="cpu", **common)
    assert got.iteration_count_ran == 5
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=1e-8)
    assert got.best_iteration == want.best_iteration
    assert got.best_error == pytest.approx(want.best_error, abs=1e-8)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.best_final_densities,
                               np.asarray(want.best_final_densities), rtol=0,
                               atol=1e-8)


RKDP5_ATOL = 1e-10


def test_rkdp5_evolve_matches_jax():
    """evolve_lindblad_discrete without ``method`` (RKDP5, the forward-only
    integrator) at d = 3, 4 intervals: the densities at every system step
    and the error against qoc_tpu's."""
    import qoc_tpu
    import qoc_tpu_torch
    problem = LindbladProblem(d=3, n_steps=5)
    common = dict(controls=problem.controls, atol=RKDP5_ATOL,
                  save_intermediate_densities=True)
    want = qoc_tpu.evolve_lindblad_discrete(
        problem.evolution_time, problem.initial, problem.n_steps,
        costs=problem.jax_costs, hamiltonian=problem.jax_hamiltonian,
        lindblad_data=problem.jax_lindblad, **common)
    got = qoc_tpu_torch.evolve_lindblad_discrete(
        problem.evolution_time, problem.torch_initial, problem.n_steps,
        costs=problem.torch_costs, hamiltonian=problem.torch_hamiltonian,
        lindblad_data=problem.torch_lindblad, device="cpu", **common)
    assert got.intermediate_densities.shape == (5, 2, 3, 3)
    np.testing.assert_allclose(got.intermediate_densities,
                               np.asarray(want.intermediate_densities),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.final_densities,
                               got.intermediate_densities[-1], rtol=0,
                               atol=0)
    assert got.error == pytest.approx(want.error, abs=1e-9)


def _rkdp5_grapes(rkdp5_max_steps, iteration_count):
    """qoc_tpu's and the port's grape_lindblad_discrete without ``method``
    (RKDP5) at d = 2, 3 intervals, with TargetDensityInfidelityTime and
    ForbidDensities every step."""
    import qoc_tpu
    import qoc_tpu_torch
    problem = LindbladProblem(d=2, n_steps=4).add_step_costs()
    common = dict(complex_controls=True, iteration_count=iteration_count,
                  initial_controls=problem.controls, log_iteration_step=0,
                  max_control_norms=problem.max_control_norms,
                  atol=RKDP5_ATOL, rkdp5_max_steps=rkdp5_max_steps)
    want = qoc_tpu.grape_lindblad_discrete(
        problem.n_c, problem.n_steps, problem.jax_costs,
        problem.evolution_time, problem.initial, problem.n_steps,
        hamiltonian=problem.jax_hamiltonian,
        lindblad_data=problem.jax_lindblad, **common)
    got = qoc_tpu_torch.grape_lindblad_discrete(
        problem.n_c, problem.n_steps, problem.torch_costs,
        problem.evolution_time, problem.torch_initial, problem.n_steps,
        hamiltonian=problem.torch_hamiltonian,
        lindblad_data=problem.torch_lindblad, device="cpu", **common)
    return want, got


def test_rkdp5_grape_matches_jax():
    """3 Adam iterations through the default method (the bounded
    integrator, at most 64 attempts an interval, where the slowest lane
    takes at most 44): per-iteration errors, the best iterate, its controls and
    densities."""
    want, got = _rkdp5_grapes(64, 3)
    assert got.iteration_count_ran == 3
    assert np.all(np.diff(got.errors) < 0)
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=1e-9)
    assert got.best_iteration == want.best_iteration
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.best_final_densities,
                               np.asarray(want.best_final_densities),
                               rtol=0, atol=1e-9)


def test_rkdp5_grape_unconverged_gives_nan():
    """rkdp5_max_steps=3 cannot cover an interval: every error is NaN in
    both packages, and neither records a best iterate."""
    want, got = _rkdp5_grapes(3, 2)
    assert np.all(np.isnan(np.asarray(want.errors)))
    assert np.all(np.isnan(got.errors)) and got.errors.shape == (2,)
    assert got.best_error == want.best_error == np.finfo(np.float64).max


def _refusals(directory):
    """case: (kwargs, what it does now): the exception it raises, or None
    for a run whose save rows are checked."""
    return {
        "save_file_path": (dict(save_file_path=str(directory / "run.h5"),
                                save_iteration_step=1), None),
        "resume_from": (dict(resume_from=not_a_grape_file(directory)),
                        (ValueError, "not a GRAPE save file")),
        "mesh": (dict(mesh=object()), (NotImplementedError, "slice")),
    }


@pytest.mark.parametrize("case", ("mesh", "resume_from", "save_file_path"))
def test_unported_features_raise_not_implemented(case, tmp_path):
    """``mesh`` is not ported (ROADMAP Queue 1 item 8); save files and
    resume are: a save file gets its rows, and a resume_from without GRAPE
    rows is refused as in qoc_tpu."""
    import qoc_tpu_torch
    from qoc_tpu_torch.models import LindbladMethod

    problem = LindbladProblem(d=2, n_steps=4)
    kwargs, raises = _refusals(tmp_path)[case]

    def run():
        return qoc_tpu_torch.grape_lindblad_discrete(
            problem.n_c, problem.n_steps, problem.torch_costs,
            problem.evolution_time, problem.torch_initial, problem.n_steps,
            complex_controls=True, hamiltonian=problem.torch_hamiltonian,
            lindblad_data=problem.torch_lindblad, iteration_count=1,
            log_iteration_step=0, method=LindbladMethod.MAGNUS_EXPM,
            device="cpu", **kwargs)

    if raises is not None:
        with pytest.raises(raises[0], match=raises[1]):
            run()
        return
    result = run()
    np.testing.assert_array_equal(saved_errors(kwargs["save_file_path"]),
                                  result.errors)


def test_conversions_carry_the_data():
    """convert.constant_lindblad, densities and target_density_infidelity
    read qoc_tpu's objects by duck typing and keep their data."""
    from qoc_tpu_torch import ConstantLindblad, TargetDensityInfidelity
    problem = LindbladProblem()
    lind = problem.torch_lindblad
    assert isinstance(lind, ConstantLindblad)
    np.testing.assert_array_equal(lind.dissipators, problem.rates)
    np.testing.assert_array_equal(lind.operators, problem.lops)
    assert lind.operators.dtype == np.complex128
    assert problem.torch_initial.dtype == np.complex128
    np.testing.assert_array_equal(problem.torch_initial, problem.initial)
    cost = problem.torch_costs[0]
    assert isinstance(cost, TargetDensityInfidelity)
    np.testing.assert_allclose(cost.target_densities_dagger,
                               problem.jax_costs[0].target_densities_dagger,
                               rtol=0, atol=1e-15)
    assert cost.cost_multiplier == problem.jax_costs[0].cost_multiplier
