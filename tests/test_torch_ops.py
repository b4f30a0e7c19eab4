"""The port's small modules against their qoc_tpu counterparts (float64,
CPU): interpolation, Magnus M2/M4/M6, commutator and 1-norm,
LinearHamiltonian, TargetStateInfidelity, strip/slap/clip and Adam."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import random_hermitian

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("x", (-0.7, 0.0, 0.35, 1.0, 2.2, 3.0, 4.9))
def test_interpolate_linear_set_matches_jax(x):
    """Inside the samples, on them, and both extrapolation sides."""
    from qoc_tpu.ops.interpolate import interpolate_linear_set as jax_interp
    from qoc_tpu_torch.ops.interpolate import interpolate_linear_set
    rng = np.random.default_rng(0)
    xs = np.linspace(0.0, 3.0, 7)
    ys = rng.normal(size=(7, 3)) + 1j * rng.normal(size=(7, 3))
    want = np.asarray(jax_interp(x, jnp.asarray(xs), jnp.asarray(ys)))
    got = interpolate_linear_set(x, _t(xs), _t(ys)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_interpolate_linear_set_batched_queries():
    """A batch of queries equals the per-query results."""
    from qoc_tpu.ops.interpolate import interpolate_linear_set as jax_interp
    from qoc_tpu_torch.ops.interpolate import interpolate_linear_set
    rng = np.random.default_rng(1)
    xs = np.linspace(0.0, 2.0, 5)
    ys = rng.normal(size=(5, 2))
    queries = np.array([-1.0, 0.1, 0.5, 1.99, 2.0, 2.7])
    got = interpolate_linear_set(_t(queries), _t(xs), _t(ys)).numpy()
    want = np.stack([np.asarray(jax_interp(q, jnp.asarray(xs),
                                           jnp.asarray(ys)))
                     for q in queries])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_convert_maps_an_ensemble_hamiltonian():
    """qoc_tpu's EnsembleLinearHamiltonian converts to the port's, with the
    same bases (δ columns after h0) and the same member Hamiltonians."""
    from qoc_tpu.models.hamiltonian import EnsembleLinearHamiltonian
    from qoc_tpu_torch import EnsembleLinearHamiltonian as TorchEnsemble
    from qoc_tpu_torch import convert
    rng = np.random.default_rng(4)
    d = 3
    h0 = random_hermitian(rng, d)
    ensemble = EnsembleLinearHamiltonian(
        h0, rng.normal(size=(1, d, d)) + 0j, h0[None])
    converted = convert.linear_hamiltonian(ensemble)
    assert isinstance(converted, TorchEnsemble)
    np.testing.assert_array_equal(converted.param_operators,
                                  ensemble.param_operators)
    np.testing.assert_array_equal(converted.generator_basis(0.2),
                                  ensemble.generator_basis(0.2))
    controls = np.array([0.3 - 0.2j])
    for delta in (-0.05, 0.05):
        want = np.asarray(ensemble(jnp.asarray([delta]),
                                   jnp.asarray(controls), 0.1))
        got = converted(_t([delta]), _t(controls), torch.tensor(0.1))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)


def test_linear_hamiltonian_and_magnus_m2_match_jax():
    from qoc_tpu import LinearHamiltonian as JaxLinearHamiltonian
    from qoc_tpu.ops.magnus import magnus_m2 as jax_magnus_m2
    from qoc_tpu_torch import convert
    from qoc_tpu_torch.ops.magnus import magnus_m2
    rng = np.random.default_rng(2)
    d, n_c = 5, 3
    jax_ham = JaxLinearHamiltonian(
        random_hermitian(rng, d),
        rng.normal(size=(n_c, d, d)) + 1j * rng.normal(size=(n_c, d, d)))
    ham = convert.linear_hamiltonian(jax_ham)
    controls = rng.normal(size=n_c) + 1j * rng.normal(size=n_c)
    want = np.asarray(jax_ham(jnp.asarray(controls), 0.3))
    got = ham(_t(controls), 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ham(None, 0.0).numpy(),
                               np.asarray(jax_ham(None, 0.0)), atol=0)
    np.testing.assert_array_equal(ham.generator_basis(0.01),
                                  jax_ham.generator_basis(0.01))

    # M2 samples the generator at the midpoint: time-dependent controls.
    def jax_gen(t):
        return -1j * jax_ham(jnp.asarray(controls) * jnp.cos(t), t)

    def gen(t):
        return -1j * ham(_t(controls) * np.cos(t), t)

    want = np.asarray(jax_magnus_m2(jax_gen, 0.05, 0.7))
    got = magnus_m2(gen, 0.05, 0.7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_linear_hamiltonian_converts_its_matrices_once():
    """h0 and the operators become tensors once per dtype and device, not
    on every call (the planes are built every iteration)."""
    from qoc_tpu_torch import LinearHamiltonian
    rng = np.random.default_rng(3)
    d, n_c = 4, 2
    ham = LinearHamiltonian(random_hermitian(rng, d),
                            rng.normal(size=(n_c, d, d)) + 0j)
    controls = _t(rng.normal(size=n_c) + 1j * rng.normal(size=n_c))
    first = ham(controls, 0.0)
    tensors = ham._as_tensors(controls.dtype, controls.device)
    assert torch.equal(ham(controls, 0.0), first)
    assert all(a is b for a, b in zip(
        ham._as_tensors(controls.dtype, controls.device), tensors))
    low = ham(controls.to(torch.complex64), 0.0)
    assert low.dtype == torch.complex64
    assert len(ham._tensors) == 2
    np.testing.assert_allclose(low.numpy(), first.numpy(), rtol=1e-6)


@pytest.mark.parametrize("order", ("m4", "m6"))
def test_magnus_m4_m6_match_jax(order):
    """A batched, time-dependent generator: the step times form a vector
    and the terms a stack (qoc_tpu's corrected M6 coefficient 1/12)."""
    from qoc_tpu.ops import magnus as jax_magnus
    from qoc_tpu_torch.ops import magnus
    rng = np.random.default_rng(7)
    d = 4
    h0 = random_hermitian(rng, d)
    h1 = random_hermitian(rng, d)
    times = np.array([0.0, 0.3, 1.1])

    def jax_gen(t):
        return -1j * (h0 + jnp.sin(t)[..., None, None] * h1)

    def gen(t):
        return -1j * (_t(h0) + torch.sin(t)[..., None, None] * _t(h1))

    fn = "magnus_" + order
    want = np.asarray(getattr(jax_magnus, fn)(jax_gen, 0.07,
                                              jnp.asarray(times)))
    got = getattr(magnus, fn)(gen, 0.07, _t(times)).numpy()
    assert got.shape == (3, d, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_commutator_and_one_norm_match_jax():
    from qoc_tpu.ops import linalg as jax_linalg
    from qoc_tpu_torch.ops import linalg
    rng = np.random.default_rng(8)
    a, b = (rng.normal(size=(2, 3, 3)) + 1j * rng.normal(size=(2, 3, 3))
            for _ in range(2))
    np.testing.assert_allclose(
        linalg.commutator(_t(a), _t(b)).numpy(),
        np.asarray(jax_linalg.commutator(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-13)
    np.testing.assert_allclose(
        linalg.one_norm(_t(a)).numpy(),
        np.asarray(jax_linalg.one_norm(jnp.asarray(a))), rtol=1e-14, atol=0)


@pytest.mark.parametrize("kwargs", ({}, {"neglect_relative_phase": True},
                                    {"neglect_relative_pahse": True},
                                    {"cost_multiplier": 2.5}))
def test_target_state_infidelity_matches_jax(kwargs):
    from qoc_tpu.standard import TargetStateInfidelity as JaxCost
    from qoc_tpu_torch import convert
    from qoc_tpu_torch.costs import TargetStateInfidelity
    rng = np.random.default_rng(3)
    k, d = 3, 4
    targets = rng.normal(size=(k, d, 1)) + 1j * rng.normal(size=(k, d, 1))
    targets /= np.linalg.norm(targets, axis=1, keepdims=True)
    states = rng.normal(size=(k, d, 1)) + 1j * rng.normal(size=(k, d, 1))
    states /= np.linalg.norm(states, axis=1, keepdims=True)
    jax_cost = JaxCost(targets, **kwargs)
    want = float(jax_cost.cost(None, jnp.asarray(states), 0))
    assert float(TargetStateInfidelity(targets, **kwargs).cost(
        None, _t(states), 0)) == pytest.approx(want, rel=1e-12)
    assert float(convert.target_state_infidelity(jax_cost).cost(
        None, _t(states), 0)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("complex_controls", (True, False))
def test_strip_slap_clip_match_jax(complex_controls):
    from qoc_tpu.core import common as jax_common
    from qoc_tpu_torch.core import common
    rng = np.random.default_rng(4)
    shape = (6, 3)
    controls = 2 * rng.normal(size=shape)
    if complex_controls:
        controls = controls + 2j * rng.normal(size=shape)
    norms = np.array([0.5, 1.5, 10.0])

    flat = common.strip_controls(complex_controls, controls)
    np.testing.assert_array_equal(
        flat, jax_common.strip_controls(complex_controls, controls))
    np.testing.assert_array_equal(
        common.slap_controls(complex_controls, flat, shape), controls)
    flat_t = common.strip_controls_torch(complex_controls, _t(controls))
    np.testing.assert_array_equal(flat_t.numpy(), flat)
    np.testing.assert_array_equal(
        common.slap_controls_torch(complex_controls, flat_t, shape).numpy(),
        controls)

    want = np.asarray(jax_common.clip_control_norms_jax(
        jnp.asarray(controls), norms))
    np.testing.assert_allclose(common.clip_control_norms(controls, norms),
                               want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(
        common.clip_control_norms_torch(_t(controls), _t(norms)).numpy(),
        want, rtol=1e-15, atol=0)


def test_initialize_controls_matches_jax():
    from qoc_tpu.core import common as jax_common
    from qoc_tpu_torch.core import common
    for args in ((True, 3, 8, 1.0, None, [0.5, 1.0, 2.0]),
                 (False, 2, 5, 1.0, None, None)):
        got, got_norms = common.initialize_controls(*args)
        want, want_norms = jax_common.initialize_controls(*args)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_norms, want_norms)
    with pytest.raises(ValueError, match="max_control_norms"):
        common.initialize_controls(False, 1, 2, 1.0, np.array([[2.0], [0.]]),
                                   [1.0])


@pytest.mark.parametrize("options", (
    {},
    {"learning_rate_decay": 3.0},
    {"scale_grads": 0.5},
    {"clip_grads": 0.2, "learning_rate": 1e-2},
))
def test_adam_updates_match_update_jax(options):
    """Three Adam updates from a converted mid-run state, step for step."""
    from qoc_tpu.optim import Adam as JaxAdam
    from qoc_tpu_torch import Adam, convert
    rng = np.random.default_rng(5)
    n = 7
    params = rng.normal(size=n)
    jax_adam, adam = JaxAdam(**options), Adam(**options)
    jax_state = {"m": jnp.asarray(0.1 * rng.normal(size=n)),
                 "v": jnp.asarray(0.01 * rng.random(n)),
                 "t": jnp.asarray(4, dtype=jnp.int32)}
    state = convert.adam_state({key: np.asarray(value)
                                for key, value in jax_state.items()})
    jax_params, torch_params = jnp.asarray(params), _t(params)
    for _ in range(3):
        grads = rng.normal(size=n)
        jax_state, jax_params = jax_adam.update_jax(
            jax_state, jnp.asarray(grads), jax_params)
        state, torch_params = adam.update(state, _t(grads), torch_params)
        np.testing.assert_allclose(torch_params.numpy(),
                                   np.asarray(jax_params), rtol=1e-14,
                                   atol=1e-15)
        for key in ("m", "v"):
            np.testing.assert_allclose(state[key].numpy(),
                                       np.asarray(jax_state[key]),
                                       rtol=1e-14, atol=1e-16)
        assert int(state["t"]) == int(jax_state["t"])
