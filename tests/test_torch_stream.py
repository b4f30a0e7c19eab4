"""The port's streamed chain route (K6's, 256 < padded d <= 512) on the CPU.

- The plane op at d = 260 (padded 320) with weights x basis planes, which
  on the CPU runs K6's plain versions (the streamed kernels' arithmetic):
  on a Taylor level and on the squaring branch against the port's own
  float64 reference on the same input (an ordered product of
  ``torch.linalg.matrix_exp``, autograd for the gradient) at
  test_torch_chain.py's 1e-6 / 1e-5 (the f32-calibrated ladder against an
  f64 expm); and against ``qoc_tpu``'s XLA reference under x64
  (``chain_expm_propagate_reference``, the reference that
  tests/test_chain.py holds the streamed kernels ``_stream_fwd_kernel`` /
  ``_stream_bwd_kernel``, run in Pallas interpret mode, to), at the same
  tolerances: the 3-step Taylor-level chain, and one step of the squaring
  branch. The reference's expm at d = 260 is the slow part, so each is
  computed once. The inputs are exact in float32, so both packages see the
  same numbers.
- K6's segment plan, ``chain_block_plan``'s padded dimension, the refusals
  of the CUDA wrappers, and the d = 260 Schrödinger loss and gradient: the
  streamed route against ``qoc_tpu``'s ``build_schroedinger_loss``
  (relative 1e-6 / 1e-5, as tests/test_torch_schroedinger.py), the plane
  route of an M4 callable against the port's blocked route.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import Problem

torch.set_num_threads(1)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _stream_problem(seed, scale):
    """d = 260, 3 steps, 3 general (not anti-Hermitian) basis matrices and
    weights, complex64/float32 (tests/test_chain.py's stream setup)."""
    rng = np.random.default_rng(seed)
    d, n_b, b = 260, 3, 3
    basis = (scale * (rng.normal(size=(n_b, d, d))
                      + 1j * rng.normal(size=(n_b, d, d)))).astype(
                          np.complex64)
    w = rng.normal(size=(b, n_b)).astype(np.float32)
    tgt = (rng.normal(size=(d, d))
           + 1j * rng.normal(size=(d, d))).astype(np.complex64)
    return basis, w, tgt


def _port_loss_and_grad(basis, w, tgt):
    """The port's plane op on the planes w @ basis (float64, CPU): the
    total, and the weight gradient of sum |P - tgt|^2 through the plane
    build."""
    from qoc_tpu_torch.ops.chain import plane_chain_propagate
    n_b, d = basis.shape[0], basis.shape[-1]
    wt = torch.tensor(w.astype(np.float64), requires_grad=True)
    g = torch.as_tensor(basis.astype(np.complex128)).reshape(n_b, d * d)
    total = plane_chain_propagate((wt.to(g.dtype) @ g).reshape(-1, d, d))
    loss = torch.sum(torch.abs(total - torch.as_tensor(tgt)) ** 2)
    grad, = torch.autograd.grad(loss, wt)
    return total.detach().numpy(), grad.numpy()


def _expm_chain_loss_and_grad(basis, w, tgt):
    """The port's float64 reference for the same chain: an ordered product
    of torch.linalg.matrix_exp of the planes, its weight gradient by
    autograd."""
    n_b, d = basis.shape[0], basis.shape[-1]
    wt = torch.tensor(w.astype(np.float64), requires_grad=True)
    g = torch.as_tensor(basis.astype(np.complex128)).reshape(n_b, d * d)
    total = torch.eye(d, dtype=g.dtype)
    for u in torch.linalg.matrix_exp((wt.to(g.dtype) @ g).reshape(-1, d, d)):
        total = u @ total
    loss = torch.sum(torch.abs(total - torch.as_tensor(tgt)) ** 2)
    grad, = torch.autograd.grad(loss, wt)
    return total.detach().numpy(), grad.numpy()


_CASES = {"ladder": (11, 0.01 / 3), "squaring": (12, 2.0 / (2 * 260 ** 0.5))}


@functools.cache
def _jax_reference(case, n_steps):
    """qoc_tpu's XLA reference under x64 of the first ``n_steps`` steps of
    ``case``'s chain: the total and the weight gradient of
    sum |P - tgt|^2."""
    from qoc_tpu.ops.chain_pallas import chain_expm_propagate_reference
    basis, w, tgt = _stream_problem(*_CASES[case])
    basis64 = basis.astype(np.complex128)

    def loss(ww):
        total = chain_expm_propagate_reference(ww, basis64)
        return jnp.sum(jnp.abs(total - tgt) ** 2), total

    (_, want), g_want = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(w[:n_steps].astype(np.float64)))
    return np.asarray(want), np.asarray(g_want)


def _level(basis, w):
    from qoc_tpu_torch.ops.chain import _plane_norm_max, ladder_level
    planes = torch.as_tensor(np.einsum("bk,kij->bij", w.astype(np.float64),
                                       basis.astype(np.complex128)))
    return ladder_level(_plane_norm_max(planes)[0])


@pytest.mark.parametrize("case", ("ladder", "squaring"))
def test_plane_op_matches_interpreted_stream_kernels(case):
    """The streamed regime on a Taylor level and on the squaring branch
    (tests/test_chain.py:975-1037's inputs), 3 steps: the port's total and
    weight gradient against the port's float64 matrix_exp chain and, on the
    Taylor level, against qoc_tpu's reference for its streamed kernels."""
    from qoc_tpu_torch.ops.chain import uses_stream
    seed, scale = _CASES[case]
    basis, w, tgt = _stream_problem(seed, scale)
    assert uses_stream(260)
    got, g_got = _port_loss_and_grad(basis, w, tgt)
    assert _level(basis, w) == (4 if case == "squaring" else 3)
    want, g_want = _expm_chain_loss_and_grad(basis, w, tgt)
    assert _rel(got, want) < 1e-6
    assert _rel(g_got, g_want) < 1e-5
    if case == "ladder":
        from qoc_tpu.ops.chain_pallas import chain_fused_ok
        assert chain_fused_ok(260, 3)
        want, g_want = _jax_reference(case, 3)
        assert _rel(got, want) < 1e-6
        assert _rel(g_got, g_want) < 1e-5


def test_plane_op_matches_chain_reference():
    """The squaring branch against qoc_tpu's XLA reference under x64, on
    the case's first step (one expm at d = 260 and its gradient): the
    port's total and weight gradient."""
    basis, w, tgt = _stream_problem(*_CASES["squaring"])
    w = w[:1]
    assert _level(basis, w) == 4
    want, g_want = _jax_reference("squaring", 1)
    got, g_got = _port_loss_and_grad(basis, w, tgt)
    assert _rel(got, want) < 1e-6
    assert _rel(g_got, g_want) < 1e-5


@pytest.mark.parametrize("n_steps", (1, 3, 15, 16, 17, 37, 100, 1001))
def test_stream_segment_plan_covers_every_step(n_steps):
    """K6's plan: at most 16 segments, every step in one, fewer than one
    segment of padding; the padded steps (zero planes) are exactly I."""
    from qoc_tpu_torch.ops.chain import (stream_fwd_plain,
                                         stream_segment_plan)
    s_count, length = stream_segment_plan(n_steps)
    assert s_count <= 16
    assert s_count * length >= n_steps > (s_count - 1) * length
    if n_steps > 100:
        return
    rng = np.random.default_rng(n_steps)
    a = torch.zeros((s_count * length, 3, 3), dtype=torch.complex128)
    a[:n_steps] = torch.as_tensor(
        0.3 * (rng.normal(size=(n_steps, 3, 3))
               + 1j * rng.normal(size=(n_steps, 3, 3))))
    pref = stream_fwd_plain(a.reshape(s_count, length, 3, 3),
                            torch.tensor(1.0, dtype=torch.float64))
    last = n_steps - (s_count - 1) * length     # real steps, last segment
    tail = pref[-1, last:]
    assert torch.equal(tail, tail[:1].expand_as(tail))


@pytest.mark.parametrize("d,dp", ((8, 64), (64, 64), (72, 128), (260, 320),
                                  (400, 448), (512, 512), (600, 600)))
def test_block_plan_counts_the_padded_dimension(d, dp):
    """chain_block_plan sizes a step at the padded d of the kernel that
    serves it (d itself above 512, where torch.matmul pads nothing)."""
    from qoc_tpu_torch.ops.chain import chain_block_plan
    n_steps = 10 ** 6
    step_bytes = 4 * dp * dp * 8
    assert chain_block_plan(d, n_steps, 8, 4) == \
        max(1, min(n_steps, 2 * 1024 ** 3 // step_bytes))


class _FakeCuda:
    """What the wrappers' checks read of a CUDA tensor (there is no card
    here; the checks run before any launch)."""

    device = torch.device("cuda", 0)
    dtype = torch.complex64

    def __init__(self, shape):
        self.shape = torch.Size(shape)

    def dim(self):
        return len(self.shape)


def test_cuda_paths_refuse_what_k6_cannot_take():
    """On a CUDA tensor the K6 wrappers refuse a padded d outside 320..512,
    and the plane op refuses 64 < d <= 256, naming the blocked route:
    nothing falls back to a plain version."""
    from qoc_tpu_torch.ops import chain
    norm = _FakeCuda(())
    with pytest.raises(ValueError, match="320..512"):
        chain.stream_fwd(_FakeCuda((2, 3, 256, 256)), norm)
    with pytest.raises(ValueError, match="320..512"):
        chain.stream_bwd(_FakeCuda((2, 3, 576, 576)), norm, None, None)
    with pytest.raises(ValueError, match="blocked route"):
        chain._plane_route(100, torch.device("cuda", 0), False)
    dp, plan = chain._plane_route(300, torch.device("cuda", 0), False)[:2]
    assert (dp, plan) == (320, chain.stream_segment_plan)


def _port_loss(problem, magnus, **kwargs):
    """The port's loss and control gradient (CPU, float64) and its path
    log."""
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    shape = (problem.n_steps, problem.n_c)
    flat_t = torch.tensor(strip_controls(True, problem.controls),
                          requires_grad=True)
    loss = build_schroedinger_loss(problem.torch_pstate(magnus=magnus),
                                   torch.device("cpu"), torch.float64,
                                   log_path=True, **kwargs)
    got, _ = loss(slap_controls_torch(True, flat_t, shape))
    g_got, = torch.autograd.grad(got, flat_t)
    return float(got.detach()), g_got.numpy()


@pytest.mark.parametrize("case,path", (("M2 LinearHamiltonian",
                                        "streamed chain"),
                                       ("M4 callable", "plane chain")))
def test_d300_schroedinger_matches_jax(case, path, capsys):
    """d = 260 (padded 320, K6's smallest), 2 steps: the streamed route's
    loss and control gradient against qoc_tpu's build_schroedinger_loss on
    its CPU route, and the M4 callable's plane route against the port's
    blocked route (expm + tree product) on the same problem."""
    problem = Problem(d=260, n_c=1, n_steps=2, evolution_time=0.2)
    if case == "M4 callable":
        problem.use_callables()
        got, g_got = _port_loss(problem, "M4")
        assert "propagation path = " + path in capsys.readouterr().out
        want, g_want = _port_loss(problem, "M4", allow_plane_chain=False)
        assert "blocked expm" in capsys.readouterr().out
    else:
        from qoc_tpu.core.common import slap_controls_jax
        from qoc_tpu.core.schroedinger import (
            build_schroedinger_loss as jax_build_loss)
        from qoc_tpu_torch.core.common import strip_controls
        shape = (problem.n_steps, problem.n_c)
        flat = strip_controls(True, problem.controls)
        jax_loss = jax_build_loss(problem.jax_pstate(magnus="M2"))
        (want, _), g_want = jax.jit(jax.value_and_grad(
            lambda f: jax_loss(slap_controls_jax(True, f, shape)),
            has_aux=True))(jnp.asarray(flat))
        got, g_got = _port_loss(problem, "M2")
        assert "propagation path = " + path in capsys.readouterr().out
    assert got == pytest.approx(float(want), rel=1e-6)
    assert _rel(g_got, np.asarray(g_want)) < 1e-5
