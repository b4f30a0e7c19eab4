"""The port's control costs and SGD against qoc_tpu's (float64, CPU).

- ControlNorm (with weights and norms), ControlArea, ControlVariation
  (order 2) and ControlBandwidthMax, each converted from qoc_tpu's object
  (``convert.control_*``): the value and the gradient with respect to the
  real and imaginary parts of the controls, within 1e-12 (the same
  float64 arithmetic; the FFT in another library).
- ControlBandwidthMax with a bound at or above the Nyquist frequency: that
  channel's penalty set is empty and costs nothing in both packages.
- A GRAPE whose error carries the four control costs, with Adam and with
  SGD, and a multistart with SGD and the same costs (evaluated under
  ``torch.func.vmap`` over the candidates), 5 iterations each of the
  Schrödinger problem of tests/torch_parity.py, with the tolerances of
  tests/test_torch_schroedinger.py: errors 1e-6, controls 1e-5, states
  1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import Problem

torch.set_num_threads(1)

_E, _C, _T = 11, 2, 2.0


def _cost_pairs():
    """name -> (qoc_tpu's cost, the port's converted one)."""
    from qoc_tpu.costs import control_costs as jax_costs
    from qoc_tpu_torch import convert
    norms = np.array([1.5, 0.7])
    costs = {
        "ControlNorm": (jax_costs.ControlNorm(
            _C, _E, control_weights=np.array([1.0, 0.5]),
            cost_multiplier=0.3, max_control_norms=norms),
            convert.control_norm),
        "ControlArea": (jax_costs.ControlArea(
            _C, _E, cost_multiplier=0.7, max_control_norms=norms),
            convert.control_area),
        "ControlVariation": (jax_costs.ControlVariation(
            _C, _E, cost_multiplier=2.0, max_control_norms=norms, order=2),
            convert.control_variation),
        "ControlBandwidthMax": (jax_costs.ControlBandwidthMax(
            _C, _E, _T, np.array([1.0, 2.0]), cost_multiplier=0.5),
            convert.control_bandwidth_max),
    }
    return {name: (cost, to_port(cost))
            for name, (cost, to_port) in costs.items()}


def _value_and_grad(jax_cost, port_cost, controls):
    """(qoc_tpu's value, gradient), (the port's) at ``controls`` (E, C),
    the gradient with respect to [Re, Im] of the controls."""
    def jax_value(re_im):
        return jax_cost.cost(re_im[0] + 1j * re_im[1], None, 0)

    re_im = np.stack((controls.real, controls.imag))
    want = jax.jit(jax.value_and_grad(jax_value))(jnp.asarray(re_im))
    x = torch.as_tensor(re_im).requires_grad_(True)
    value = port_cost.cost(torch.complex(x[0], x[1]), None, 0)
    grad, = torch.autograd.grad(value, x)
    return (float(want[0]), np.asarray(want[1])), (float(value.detach()),
                                                   grad.numpy())


@pytest.mark.parametrize("name", sorted(_cost_pairs()))
def test_control_cost_matches_jax(name):
    jax_cost, port_cost = _cost_pairs()[name]
    rng = np.random.default_rng(4)
    controls = rng.normal(size=(_E, _C)) + 1j * rng.normal(size=(_E, _C))
    (want, want_grad), (got, got_grad) = _value_and_grad(jax_cost, port_cost,
                                                         controls)
    assert got == pytest.approx(want, abs=1e-12)
    assert got > 0
    np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=1e-12)


def test_bandwidth_at_nyquist_costs_nothing():
    """Bounds at or above the Nyquist frequency (2.5 here): the channel's
    set is empty, in both packages, and it adds nothing; with both channels
    so, the cost is 0."""
    from qoc_tpu.costs.control_costs import ControlBandwidthMax
    from qoc_tpu_torch import convert
    controls = np.random.default_rng(5).normal(size=(_E, _C)) + 0j
    jax_cost = ControlBandwidthMax(_C, _E, _T, np.array([1.0, 2.5]))
    port_cost = convert.control_bandwidth_max(jax_cost)
    assert [len(i) for i in port_cost.penalty_indices] == [
        len(i) for i in jax_cost.penalty_indices]
    assert len(port_cost.penalty_indices[1]) == 0
    (want, want_grad), (got, got_grad) = _value_and_grad(jax_cost, port_cost,
                                                         controls)
    assert got == pytest.approx(want, abs=1e-12) and got > 0
    np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=1e-12)
    empty = ControlBandwidthMax(_C, _E, _T, np.array([3.0, 2.5]))
    value = convert.control_bandwidth_max(empty).cost(
        torch.as_tensor(controls), None, 0)
    assert float(value) == float(empty.cost(jnp.asarray(controls), None,
                                            0)) == 0.0


def _problem_with_control_costs():
    """The Schrödinger problem with the four control costs added to its
    target infidelity, in both packages."""
    from qoc_tpu.costs import control_costs as jax_costs
    from qoc_tpu_torch import convert
    problem = Problem(n_steps=20)
    norms = problem.max_control_norms
    extra = [
        (jax_costs.ControlNorm(problem.n_c, problem.n_steps,
                               cost_multiplier=0.2, max_control_norms=norms),
         convert.control_norm),
        (jax_costs.ControlArea(problem.n_c, problem.n_steps,
                               cost_multiplier=0.1, max_control_norms=norms),
         convert.control_area),
        (jax_costs.ControlVariation(problem.n_c, problem.n_steps,
                                    cost_multiplier=0.5),
         convert.control_variation),
        (jax_costs.ControlBandwidthMax(problem.n_c, problem.n_steps,
                                       problem.evolution_time,
                                       np.array([3.0, 4.0]),
                                       cost_multiplier=0.1),
         convert.control_bandwidth_max)]
    problem.jax_costs = problem.jax_costs + [cost for cost, _ in extra]
    problem.torch_costs = problem.torch_costs + [
        to_port(cost) for cost, to_port in extra]
    return problem


def _assert_same_run(want, got):
    assert got.iteration_count_ran == want.iteration_count_ran == 5
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=1e-6)
    assert got.best_iteration == want.best_iteration
    assert got.best_error == pytest.approx(want.best_error, abs=1e-6)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.best_final_states,
                               np.asarray(want.best_final_states), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("optimizer", ("Adam", "SGD"))
def test_grape_with_control_costs_matches_jax(optimizer):
    """5 iterations of grape_schroedinger_discrete whose error carries the
    four control costs, with Adam and with SGD (both fused, on the device
    loop)."""
    import qoc_tpu
    import qoc_tpu_torch
    problem = _problem_with_control_costs()
    common = dict(complex_controls=True, iteration_count=5,
                  initial_controls=problem.controls, log_iteration_step=0,
                  max_control_norms=problem.max_control_norms)
    want = qoc_tpu.grape_schroedinger_discrete(
        problem.n_c, problem.n_steps, problem.jax_costs,
        problem.evolution_time, problem.jax_hamiltonian, problem.initial,
        problem.n_steps,
        optimizer=getattr(qoc_tpu.optim, optimizer)(learning_rate=0.05),
        **common)
    got = qoc_tpu_torch.grape_schroedinger_discrete(
        problem.n_c, problem.n_steps, problem.torch_costs,
        problem.evolution_time, problem.torch_hamiltonian,
        problem.torch_initial, problem.n_steps,
        optimizer=getattr(qoc_tpu_torch, optimizer)(learning_rate=0.05),
        device="cpu", **common)
    assert np.all(np.diff(got.errors) < 0)
    _assert_same_run(want, got)


def test_sgd_multistart_with_control_cost_matches_jax():
    """grape_schroedinger_multistart with SGD, 4 candidates, 5 iterations,
    the error carrying the four control costs (evaluated for every
    candidate under torch.func.vmap): every candidate's best error,
    the winner, its controls and final states."""
    import qoc_tpu
    import qoc_tpu_torch
    from jax.sharding import Mesh
    problem = _problem_with_control_costs()
    one_device = Mesh(np.asarray(jax.devices()[:1]), ("candidate",))
    common = dict(n_starts=4, complex_controls=True, iteration_count=5,
                  initial_controls=problem.controls,
                  max_control_norms=problem.max_control_norms,
                  log_iteration_step=0, seed=3)
    want = qoc_tpu.parallel.grape_schroedinger_multistart(
        problem.n_c, problem.n_steps, problem.jax_costs,
        problem.evolution_time, problem.jax_hamiltonian, problem.initial,
        problem.n_steps, optimizer=qoc_tpu.optim.SGD(learning_rate=0.05),
        mesh=one_device, **common)
    got = qoc_tpu_torch.grape_schroedinger_multistart(
        problem.n_c, problem.n_steps, problem.torch_costs,
        problem.evolution_time, problem.torch_hamiltonian,
        problem.torch_initial, problem.n_steps,
        optimizer=qoc_tpu_torch.SGD(learning_rate=0.05), device="cpu",
        **common)
    assert got.errors.shape == (4,)
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=1e-6)
    assert int(np.argmin(got.errors)) == int(np.argmin(want.errors))
    _assert_same_run(want, got)
