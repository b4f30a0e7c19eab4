"""The port's plane route against qoc_tpu (float64, CPU): the plane chain op
against an ordered product of ``qoc_tpu.ops.expm.expm`` with ``jax.vjp``,
and the Schrödinger loss, evolve and GRAPE with Hamiltonian callables under
Magnus M2/M4/M6 and with a ``LinearHamiltonian`` under M4/M6.

On the CPU in x64 ``qoc_tpu`` takes its generic route (an XLA expm per
step, composed by a tree product): the JAX package's own plain reference
for its plane-chain kernel. Tolerances: relative 1e-6 on totals and losses
and 1e-5 on gradients (the port's f32-calibrated Taylor ladder against an
f64-accurate expm, as in test_torch_chain.py), 1e-6 on GRAPE errors, 1e-8
on evolved states.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import Problem, anti_hermitian_basis

torch.set_num_threads(1)

# Batch-max 1-norm targets that land on each ladder level: degree 4, 8,
# 12, 19 and per-matrix scaling and squaring.
LEVEL_NORMS = ((0, 0.03), (1, 0.3), (2, 1.0), (3, 2.5), (4, 7.0))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def jax_plane_reference():
    from qoc_tpu.ops.expm import expm

    def loss(a, tgt):
        total = jnp.eye(a.shape[-1], dtype=a.dtype)
        for u in expm(a):
            total = u @ total
        return jnp.sum(jnp.abs(total - tgt) ** 2), total

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _planes(rng, b, d):
    """(B, d, d) anti-Hermitian planes with unit batch-max 1-norm."""
    base = anti_hermitian_basis(rng, b, d)
    return base / np.abs(base).sum(-2).max()


@pytest.mark.parametrize("d", (4, 8))
@pytest.mark.parametrize("b", (3, 16, 37))
def test_plane_chain_matches_jax(jax_plane_reference, d, b):
    """Total and plane gradient on every ladder level; the port's gradient
    is the conjugate of JAX's cotangent."""
    from qoc_tpu_torch.ops.chain import (_plane_norm_max, ladder_level,
                                         plane_chain_propagate)
    rng = np.random.default_rng(10 * d + b)
    base = _planes(rng, b, d)
    tgt = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    for level, target_norm in LEVEL_NORMS:
        a = base * target_norm
        (_, want), g_want = jax_plane_reference(jnp.asarray(a),
                                                jnp.asarray(tgt))
        at = torch.tensor(a, requires_grad=True)
        assert ladder_level(_plane_norm_max(at.detach())[0]) == level
        total = plane_chain_propagate(at)
        loss = torch.sum(torch.abs(total - torch.as_tensor(tgt)) ** 2)
        g_got, = torch.autograd.grad(loss, at)
        assert _rel(total.detach().numpy(), np.asarray(want)) < 1e-6, level
        assert _rel(g_got.numpy(), np.conj(np.asarray(g_want))) < 1e-5, level


def test_plane_chain_gradcheck():
    """Exact gradient of the plain op (finite differences, float64), on
    every ladder level."""
    from qoc_tpu_torch.ops.chain import plane_chain_propagate
    rng = np.random.default_rng(4)
    base = _planes(rng, 3, 3)
    for _, target_norm in LEVEL_NORMS:
        assert torch.autograd.gradcheck(
            plane_chain_propagate,
            (torch.tensor(base * target_norm, requires_grad=True),))


def test_plane_chain_matches_basis_chain():
    """Planes A_j = Σ_k w_jk G_k through the plane op give the basis op's
    total and, projected onto the basis, its weight gradient: K5's math is
    K1/K2's with the generator read instead of built."""
    from qoc_tpu_torch.ops.chain import (ChainExpmPropagate,
                                         plane_chain_propagate)
    rng = np.random.default_rng(6)
    d, b, n_b = 5, 29, 3
    basis = 0.4 * anti_hermitian_basis(rng, n_b, d)
    w = torch.tensor(rng.normal(size=(b, n_b)), requires_grad=True)
    tgt = torch.as_tensor(rng.normal(size=(d, d)) + 0j)
    totals, grads = [], []
    for op in (ChainExpmPropagate(basis, "cpu", torch.float64),
               lambda w: plane_chain_propagate(
                   torch.einsum("jk,kab->jab", w.to(torch.complex128),
                                torch.as_tensor(basis)))):
        total = op(w)
        grad, = torch.autograd.grad(torch.sum(torch.abs(total - tgt) ** 2),
                                    w)
        totals.append(total.detach().numpy())
        grads.append(grad.numpy())
    np.testing.assert_allclose(totals[1], totals[0], rtol=0, atol=1e-13)
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=1e-12)


def test_plane_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors K5's wrappers are their plain versions: the same
    results, slot 0 of the prefixes the identity, and no launch counted."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(8)
    s_count, length, d = 3, 9, 4
    a = torch.as_tensor(0.3 * anti_hermitian_basis(
        rng, s_count * length, d).reshape(s_count, length, d, d))
    n1, ninf = chain._plane_norm_max(a)
    launches = (chain.plane_fwd.launches, chain.plane_bwd.launches)
    pref = chain.plane_fwd(a, n1)
    assert torch.equal(pref, chain.plane_fwd_plain(a, n1))
    assert torch.equal(pref[:, 0], torch.eye(d, dtype=a.dtype).expand(
        s_count, d, d))
    seeds = torch.as_tensor(rng.normal(size=(s_count, d, d))
                            + 1j * rng.normal(size=(s_count, d, d)))
    assert torch.equal(chain.plane_bwd(a, ninf, pref, seeds),
                       chain.plane_bwd_plain(a, ninf, pref, seeds))
    assert (chain.plane_fwd.launches, chain.plane_bwd.launches) == launches


def _jax_loss(problem, magnus):
    """qoc_tpu's loss and control gradient on its CPU route (one time
    block: the blocking does not change the numbers)."""
    from qoc_tpu.core.common import slap_controls_jax
    from qoc_tpu.core.schroedinger import (
        build_schroedinger_loss as jax_build_loss)
    from qoc_tpu_torch.core.common import strip_controls
    shape = (problem.n_steps, problem.n_c)
    jax_loss = jax_build_loss(problem.jax_pstate(magnus=magnus))
    (want, _), g_want = jax.jit(jax.value_and_grad(
        lambda f: jax_loss(slap_controls_jax(True, f, shape)),
        has_aux=True))(jnp.asarray(strip_controls(True, problem.controls)))
    return float(want), np.asarray(g_want)


@functools.lru_cache(maxsize=None)
def _jax_reference(callables, magnus):
    """_jax_loss of Problem() (with its callables), once per module for the
    cases that share it."""
    problem = Problem().use_callables() if callables else Problem()
    return _jax_loss(problem, magnus)


def _loss_both(problem, magnus, time_block_size, reference):
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss

    shape = (problem.n_steps, problem.n_c)
    flat = strip_controls(True, problem.controls)
    want, g_want = reference
    loss = build_schroedinger_loss(problem.torch_pstate(magnus=magnus),
                                   torch.device("cpu"), torch.float64,
                                   time_block_size=time_block_size)
    flat_t = torch.tensor(flat, requires_grad=True)
    got, _ = loss(slap_controls_torch(True, flat_t, shape))
    g_got, = torch.autograd.grad(got, flat_t)
    assert float(got.detach()) == pytest.approx(want, rel=1e-6)
    assert _rel(g_got.numpy(), g_want) < 1e-5


@pytest.mark.parametrize("time_block_size", (None, 7))
@pytest.mark.parametrize("magnus", ("M2", "M4", "M6"))
def test_callable_loss_and_gradient_match_jax(magnus, time_block_size):
    """A time-dependent callable (cos(t) drift), one time block and four
    blocks of 7 steps (the last one short), against one qoc_tpu reference
    for both."""
    _loss_both(Problem().use_callables(), magnus, time_block_size,
               _jax_reference(True, magnus))


@pytest.mark.parametrize("magnus", ("M4", "M6"))
def test_linear_hamiltonian_plane_route_matches_jax(magnus):
    """A LinearHamiltonian under M4/M6 takes the plane route."""
    _loss_both(Problem(), magnus, None, _jax_reference(False, magnus))


@pytest.mark.parametrize("magnus", ("M2", "M4"))
def test_evolve_without_controls_matches_jax(magnus):
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.models import MagnusPolicy as JaxMagnus
    from qoc_tpu_torch.models import MagnusPolicy

    problem = Problem(n_steps=40).use_callables()
    want = qoc_tpu.evolve_schroedinger_discrete(
        problem.evolution_time, problem.jax_hamiltonian, problem.initial,
        problem.n_steps, costs=problem.jax_costs,
        magnus_policy=JaxMagnus[magnus])
    got = qoc_tpu_torch.evolve_schroedinger_discrete(
        problem.evolution_time, problem.torch_hamiltonian,
        problem.torch_initial, problem.n_steps, costs=problem.torch_costs,
        magnus_policy=MagnusPolicy[magnus], device="cpu")
    np.testing.assert_allclose(got.final_states,
                               np.asarray(want.final_states), rtol=0,
                               atol=1e-8)
    assert got.error == pytest.approx(want.error, abs=1e-8)


def test_m4_callable_grape_trajectory_matches_jax():
    """5 Adam iterations with an M4 callable: per-iteration errors and the
    best iterate agree."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.models import MagnusPolicy as JaxMagnus
    from qoc_tpu_torch.models import MagnusPolicy

    problem = Problem().use_callables()
    common = dict(complex_controls=True, iteration_count=5,
                  log_iteration_step=0)
    want = qoc_tpu.grape_schroedinger_discrete(
        problem.n_c, problem.n_steps, problem.jax_costs,
        problem.evolution_time, problem.jax_hamiltonian, problem.initial,
        problem.n_steps, initial_controls=problem.controls,
        max_control_norms=problem.max_control_norms,
        magnus_policy=JaxMagnus.M4, **common)
    got = qoc_tpu_torch.grape_schroedinger_discrete(
        problem.n_c, problem.n_steps, problem.torch_costs,
        problem.evolution_time, problem.torch_hamiltonian,
        problem.torch_initial, problem.n_steps,
        initial_controls=problem.torch_controls,
        max_control_norms=problem.torch_max_control_norms,
        magnus_policy=MagnusPolicy.M4, device="cpu", **common)
    assert got.iteration_count_ran == want.iteration_count_ran == 5
    np.testing.assert_allclose(got.errors, want.errors, rtol=0, atol=1e-6)
    assert got.best_iteration == want.best_iteration
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-5)
