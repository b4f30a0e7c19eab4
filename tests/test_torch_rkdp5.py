"""The port's adaptive RKDP5 integrator (``qoc_tpu_torch/ops/rkdp5.py``)
against ``qoc_tpu``'s (float64, CPU): one step and its dense output, both
integrators on the ODEs of tests/test_ops.py, NaN where the bounded
integrator does not converge, the gradient against ``jax.grad`` and finite
differences, ``rms_norm``, lanes against their single runs, and the host
reads a chunk.

Tolerances: 1e-13 on one step and its dense output (the same float64
arithmetic in another order); 1e-12 on the integrators' results on these
smooth ODEs, whose meshes the two packages take alike (where a mesh
decision flips on a rounding, the results part by up to the integrator's
own error, see tests/test_torch_lindblad.py); 1e-12 on gradients against
``jax.grad``, 1e-6 against central differences (eps 1e-6); lanes equal
their single runs to 1e-15.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)

from qoc_tpu.ops import rkdp5 as jax_rkdp5
from qoc_tpu.ops.linalg import rms_norm as jax_rms_norm
from qoc_tpu_torch.ops import rkdp5
from qoc_tpu_torch.ops.linalg import rms_norm

torch.set_num_threads(1)

F64, C128 = torch.float64, torch.complex128


def _matrix_ode(seed=0, d=3):
    """y' = A y for a random complex A (d, d): rhs in both packages."""
    rng = np.random.default_rng(seed)
    a = 0.5 * (rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    a_t = torch.as_tensor(a)
    return (lambda t, y: jnp.asarray(a) @ y), (lambda t, y: a_t @ y), a


def test_step_and_dense_output_match_jax():
    """integrate_rkdp5_step (ks, y1, y1h) and rkdp5_dense at four points
    of the step, on y' = A y with a (3, 2) state."""
    jax_rhs, torch_rhs, _ = _matrix_ode()
    y0 = np.random.default_rng(1).normal(size=(3, 2)) + 0j
    h, x0 = 0.3, 0.5
    ks_j, y1_j, y1h_j = jax_rkdp5.integrate_rkdp5_step(
        h, jax_rhs, x0, jnp.asarray(y0))
    ks_t, y1_t, y1h_t = rkdp5.integrate_rkdp5_step(
        torch.tensor(h, dtype=F64), torch_rhs, torch.tensor(x0, dtype=F64),
        torch.as_tensor(y0))
    for got, want in zip(ks_t + (y1_t, y1h_t), ks_j + (y1_j, y1h_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-13)
    x_eval = np.array([0.5, 0.6, 0.75, 0.8])
    want = jax_rkdp5.rkdp5_dense(ks_j, x0, x0 + h, jnp.asarray(x_eval),
                                 jnp.asarray(y0), y1_j)
    got = rkdp5.rkdp5_dense(ks_t, torch.tensor(x0, dtype=F64),
                            torch.tensor(x0 + h, dtype=F64),
                            torch.as_tensor(x_eval), torch.as_tensor(y0),
                            y1_t)
    assert got.shape == (4, 3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-13)


def _odes():
    """name -> (jax rhs, torch rhs, x_eval, y0, exact or None): the ODEs of
    tests/test_ops.py:339-414."""
    h = np.array([[1.0, 0.5], [0.5, -1.0]], dtype=complex)
    h_j, h_t = jnp.asarray(h), torch.as_tensor(h)
    return {
        "linear": (lambda t, y: -0.7 * y, lambda t, y: -0.7 * y, [2.0],
                   np.array([1.0 + 0j]), np.array([[np.exp(-1.4)]])),
        "dense": (lambda t, y: jnp.cos(t) * y, lambda t, y: torch.cos(t) * y,
                  [0.5, 1.0, 1.5, 2.0], np.array([1.0]),
                  np.exp(np.sin([[0.5], [1.0], [1.5], [2.0]]))),
        "forced": (lambda t, y: -0.3 * y + 0.1 * jnp.sin(t),
                   lambda t, y: -0.3 * y + 0.1 * torch.sin(t), [3.0],
                   np.array([0.5, -0.2]), None),
        "oscillator": (lambda t, r: -1j * (h_j @ r - r @ h_j),
                       lambda t, r: -1j * (h_t @ r - r @ h_t), [2.0],
                       np.array([[0.7, 0.2 - 0.1j], [0.2 + 0.1j, 0.3]]),
                       None),
    }


@pytest.mark.parametrize("name", sorted(_odes()))
def test_integrators_match_jax(name):
    """integrate_rkdp5 and integrate_rkdp5_scan against qoc_tpu's on each
    ODE (and the exact solution, to 1e-8, where there is one)."""
    jax_rhs, torch_rhs, x_eval, y0, exact = _odes()[name]
    for jax_integrate, integrate in (
            (jax_rkdp5.integrate_rkdp5, rkdp5.integrate_rkdp5),
            (jax_rkdp5.integrate_rkdp5_scan, rkdp5.integrate_rkdp5_scan)):
        want = np.asarray(jax.jit(lambda y: jax_integrate(
            jax_rhs, jnp.asarray(x_eval), 0.0, y))(jnp.asarray(y0)))
        got = integrate(torch_rhs, torch.tensor(x_eval, dtype=F64), 0.0,
                        torch.as_tensor(y0)).numpy()
        assert got.shape == (len(x_eval),) + y0.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        if exact is not None:
            np.testing.assert_allclose(got, exact, rtol=0, atol=1e-8)


def test_scan_gives_nan_where_unconverged():
    """max_steps=3 cannot reach x = 100: NaN, as in qoc_tpu; on lanes only
    the lane that does not reach the end is NaN."""
    want = np.asarray(jax_rkdp5.integrate_rkdp5_scan(
        lambda t, y: -y, jnp.asarray([100.0]), 0.0, jnp.asarray([1.0]),
        max_steps=3))
    got = rkdp5.integrate_rkdp5_scan(
        lambda t, y: -y, torch.tensor([100.0], dtype=F64), 0.0,
        torch.tensor([1.0], dtype=F64), max_steps=3)
    assert np.all(np.isnan(want)) and torch.all(torch.isnan(got))
    # Lane 0 decays slowly enough to pass x = 0.5 in 40 attempts, lane 1
    # (rate 1e4) does not.
    rates = torch.tensor([1.0, 1e4], dtype=F64)
    lanes = rkdp5.integrate_rkdp5_scan(
        lambda t, y: -rates[:, None] * y, torch.tensor([0.5], dtype=F64),
        0.0, torch.ones((2, 1), dtype=F64), max_steps=40, lanes=True)
    assert torch.isfinite(lanes[0, 0]).all() and torch.isnan(lanes[0, 1]).all()
    assert float(lanes[0, 0, 0]) == pytest.approx(np.exp(-0.5), abs=1e-9)


def test_scan_gradient_matches_jax_and_finite_differences():
    def jax_loss(c):
        y = jax_rkdp5.integrate_rkdp5_scan(
            lambda t, y: -1j * c * y, jnp.asarray([1.0]), 0.0,
            jnp.asarray([1.0 + 0j]), max_steps=512)[0, 0]
        return jnp.abs(y - jnp.exp(-1j * 0.5)) ** 2

    def loss(c):
        y = rkdp5.integrate_rkdp5_scan(
            lambda t, y: -1j * c * y, torch.tensor([1.0], dtype=F64), 0.0,
            torch.tensor([1.0 + 0j], dtype=C128), max_steps=512)[0, 0]
        return torch.abs(y - np.exp(-1j * 0.5)) ** 2

    c = torch.tensor(0.3, dtype=F64, requires_grad=True)
    grad, = torch.autograd.grad(loss(c), c)
    assert float(grad) == pytest.approx(
        float(jax.jit(jax.grad(jax_loss))(0.3)), abs=1e-12)
    eps = 1e-6
    with torch.no_grad():
        fd = (float(loss(torch.tensor(0.3 + eps, dtype=F64)))
              - float(loss(torch.tensor(0.3 - eps, dtype=F64)))) / (2 * eps)
    assert float(grad) == pytest.approx(fd, abs=1e-6)


def test_gradient_finite_at_zero_entries_with_rtol():
    """rtol > 0 takes |y| into the error scale; with entries exactly zero
    for all time the gradient is finite and equals qoc_tpu's."""
    y0 = np.array([1.0 + 0j, 0.0])

    def jax_loss(c):
        y = jax_rkdp5.integrate_rkdp5_scan(
            lambda t, y: -1j * c * y, jnp.asarray([1.0]), 0.0,
            jnp.asarray(y0), atol=1e-10, rtol=1e-6, max_steps=512)[0]
        return jnp.sum(jnp.abs(y - jnp.exp(-1j * 0.5)) ** 2)

    c = torch.tensor(0.3, dtype=F64, requires_grad=True)
    y = rkdp5.integrate_rkdp5_scan(
        lambda t, y: -1j * c * y, torch.tensor([1.0], dtype=F64), 0.0,
        torch.as_tensor(y0), atol=1e-10, rtol=1e-6, max_steps=512)[0]
    grad, = torch.autograd.grad(
        torch.sum(torch.abs(y - np.exp(-1j * 0.5)) ** 2), c)
    assert torch.isfinite(grad)
    assert float(grad) == pytest.approx(
        float(jax.jit(jax.grad(jax_loss))(0.3)), abs=1e-12)


def test_rms_norm_matches_jax_and_zero_gradient():
    """rms_norm of all entries and per leading axis against qoc_tpu's, and
    its gradient at an all-zero input is 0, not NaN."""
    a = np.random.default_rng(2).normal(size=(4, 3, 2)) * (1 + 0.5j)
    assert float(rms_norm(torch.as_tensor(a))) == pytest.approx(
        float(jax_rms_norm(jnp.asarray(a))), abs=1e-15)
    per_lane = rms_norm(torch.as_tensor(a), batch_dims=1)
    np.testing.assert_allclose(
        per_lane.numpy(), [float(jax_rms_norm(jnp.asarray(x))) for x in a],
        rtol=0, atol=1e-15)
    x = torch.zeros((2, 4), dtype=F64, requires_grad=True)
    grad, = torch.autograd.grad(rms_norm(x, batch_dims=1).sum(), x)
    assert torch.equal(grad, torch.zeros_like(grad))


def test_lanes_equal_single_runs():
    """Three lanes with different dynamics (rates 0.3, 2 and 9) take three
    meshes, each the one its lane takes alone, in both integrators."""
    rates = torch.tensor([0.3, 2.0, 9.0], dtype=F64)
    y0 = torch.tensor([[1.0 + 0j, 0.5], [0.2, 1.0], [1.0, -1.0]], dtype=C128)
    x_eval = torch.tensor([0.7, 1.5], dtype=F64)
    for integrate in (rkdp5.integrate_rkdp5, rkdp5.integrate_rkdp5_scan):
        together = integrate(
            lambda x, y: -1j * rates[:, None] * torch.cos(x)[:, None] * y,
            x_eval, 0.0, y0, atol=1e-10, lanes=True)
        busy = []
        for lane in range(3):
            rkdp5.reset_counts()
            alone = integrate(lambda x, y: -1j * rates[lane] * torch.cos(x)
                              * y, x_eval, 0.0, y0[lane], atol=1e-10)
            busy.append(rkdp5.counts["busy"])
            np.testing.assert_allclose(together[:, lane].numpy(),
                                       alone.numpy(), rtol=0, atol=1e-15)
        assert busy[0] < busy[1] < busy[2]


@pytest.mark.parametrize("chunk", (1, 4, 8))
def test_host_reads_once_a_chunk(chunk, monkeypatch):
    """The integrator reads the host once a chunk (4 attempts, then
    CHUNK): at most ceil(attempts / CHUNK) + 1 reads, fewer than CHUNK
    attempts past the last busy one."""
    monkeypatch.setattr(rkdp5, "CHUNK", chunk)
    rkdp5.reset_counts()
    rkdp5.integrate_rkdp5(lambda t, y: torch.cos(t) * y,
                          torch.tensor([2.0], dtype=F64), 0.0,
                          torch.tensor([1.0], dtype=F64), atol=1e-10)
    counts = dict(rkdp5.counts)
    assert counts["integrations"] == 1
    assert counts["host_reads"] <= -(-counts["attempts"] // chunk) + 1
    assert counts["busy"] <= counts["attempts"] < counts["busy"] + chunk
    assert counts["busy"] > 10


def test_remat_keeps_values(monkeypatch):
    """Where qoc_tpu's 4 GiB rule would recompute each interval in the
    backward (``torch.utils.checkpoint``), the loss and its gradient are
    the stored run's exactly (here the limit is set to 0)."""
    from torch_parity import LindbladProblem
    from qoc_tpu_torch.core import lindblad
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    problem = LindbladProblem(d=2, n_steps=3).add_step_costs()
    pstate = problem.pstate("torch")
    pstate.method_ = type(pstate.method_).RKDP5
    pstate.atol = 1e-8
    flat = torch.as_tensor(strip_controls(True, problem.controls))
    results = []
    for limit in (lindblad._RKDP5_RESIDUAL_LIMIT, 0):
        monkeypatch.setattr(lindblad, "_RKDP5_RESIDUAL_LIMIT", limit)
        loss = lindblad.build_lindblad_loss(pstate, torch.device("cpu"), F64)
        x = flat.clone().requires_grad_(True)
        rkdp5.reset_counts()
        error = loss(slap_controls_torch(True, x, pstate.controls_shape))[0]
        results.append((float(error.detach()),
                        torch.autograd.grad(error, x)[0],
                        rkdp5.counts["integrations"]))
    assert results[0][0] == results[1][0]
    assert torch.equal(results[0][1], results[1][1])
    # Two intervals, integrated again in the backward where recomputed.
    assert (results[0][2], results[1][2]) == (2, 4)
