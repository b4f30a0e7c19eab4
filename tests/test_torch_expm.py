"""The port's expm (ops/expm.py) and the plain versions of its kernels K3/K4
(ops/expm_cuda.py) against qoc_tpu (CPU).

- The plain K3/K4 in float32 against qoc_tpu's Pallas kernels
  (expm_pallas.py) run in interpret mode, on every ladder level: relative
  1e-5 (two float32 evaluations of the same ladder, rounded differently).
- The port's expm value and gradient against qoc_tpu's expm under x64, at
  relative 1e-6 (the f32-calibrated ladder against JAX's f64 Padé-13).
- The Taylor route above padded d = 256 against qoc_tpu's expm_taylor and
  _frechet_dual_taylor (float64, same algorithm): relative 1e-10.
- set_expm_forward's four names against qoc_tpu's same name (value and
  gradient): at d = 4 relative 1e-10, "pallas" (qoc_tpu's kernels in
  interpret mode, float32, padded 64) 1e-5; "auto" at d = 260, Padé-13
  on the CPU as in qoc_tpu, 1e-10.

Gradient relation: PyTorch's gradient of a complex tensor is
dL/dRe + i dL/dIm, the conjugate of JAX's cotangent. For the output
gradient G the port's gradient of exp at A is L(A^H, G) (K4 with B = A^H);
qoc_tpu's is L(A^T, conj G) (its kernel with B = A^T); the two are
conjugates: L(A^H, G) = conj L(A^T, conj G).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import anti_hermitian_basis

torch.set_num_threads(1)

# Batch-max 1-norms inside each rung of the f32 ladder (degree 4, 8, 12,
# 19, and scaling and squaring), as tests/test_pallas.py picks them.
LEVEL_NORMS = ((0, 0.03), (1, 0.3), (2, 0.9), (3, 2.2), (4, 9.0))


@pytest.fixture()
def interpreted_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    yield


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _planes(rng, b, d, norm):
    """(b, d, d) anti-Hermitian matrices (unitary exps) with batch-max
    1-norm ``norm``; their 1- and inf-norms agree, so A and A^H sit on the
    same ladder level."""
    a = anti_hermitian_basis(rng, b, d)
    return a * (norm / np.abs(a).sum(-2).max())


def _normal(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("level,norm", LEVEL_NORMS)
def test_plain_k3_matches_pallas_kernel(interpreted_pallas, level, norm):
    from qoc_tpu.ops.expm_pallas import expm_taylor_pallas
    from qoc_tpu_torch.ops.chain import ladder_level
    from qoc_tpu_torch.ops.expm_cuda import _norm_max, expm_fwd_plain
    rng = np.random.default_rng(20 + level)
    a = _planes(rng, 3, 12, norm).astype(np.complex64)
    want = np.asarray(expm_taylor_pallas(jnp.asarray(a)))
    at = torch.as_tensor(a)
    assert ladder_level(_norm_max(at)) == level
    assert _rel(expm_fwd_plain(at).numpy(), want) < 1e-5


@pytest.mark.parametrize("level,norm", LEVEL_NORMS)
def test_plain_k4_matches_pallas_kernel(interpreted_pallas, level, norm):
    """K4 computes the Pallas kernel's function, L(B, G), on the same
    inputs; with B = A^H it is the conjugate of qoc_tpu's expm adjoint
    call L(A^T, conj G) (module docstring)."""
    from qoc_tpu.ops.expm_pallas import expm_frechet_pallas
    from qoc_tpu_torch.ops.expm_cuda import expm_frechet_plain
    rng = np.random.default_rng(30 + level)
    b = _planes(rng, 2, 10, norm).astype(np.complex64)
    g = _normal(rng, b.shape).astype(np.complex64)
    want = np.asarray(expm_frechet_pallas(jnp.asarray(b), jnp.asarray(g)))
    got = expm_frechet_plain(torch.as_tensor(b), torch.as_tensor(g))
    assert _rel(got.numpy(), want) < 1e-5
    a = b.conj().swapaxes(-1, -2)                 # B = A^H
    jax_adjoint = np.asarray(expm_frechet_pallas(
        jnp.asarray(a.swapaxes(-1, -2)), jnp.asarray(g.conj())))
    assert _rel(got.numpy(), np.conj(jax_adjoint)) < 1e-5


@jax.jit
def _jax_expm_vjp(a, ct):
    """qoc_tpu's expm at a and its vjp at the cotangent ct, as one program."""
    from qoc_tpu.ops.expm import expm as jax_expm
    out, vjp = jax.vjp(jax_expm, a)
    return out, vjp(ct)[0]


@pytest.mark.parametrize("level,norm", LEVEL_NORMS)
def test_expm_value_and_gradient_match_jax(level, norm):
    from qoc_tpu_torch.ops.expm import expm
    rng = np.random.default_rng(40 + level)
    a = _planes(rng, 3, 6, norm) + 0.01 * norm * _normal(rng, (3, 6, 6))
    g = _normal(rng, a.shape)
    want, g_want = _jax_expm_vjp(jnp.asarray(a), jnp.asarray(np.conj(g)))
    at = torch.tensor(a, requires_grad=True)
    got = expm(at)
    g_got, = torch.autograd.grad(got, at, torch.as_tensor(g))
    assert _rel(got.detach().numpy(), want) < 1e-6
    assert _rel(g_got.numpy(), np.conj(np.asarray(g_want))) < 1e-6


@pytest.mark.parametrize("level,norm", LEVEL_NORMS)
def test_expm_gradcheck(level, norm):
    """The exact gradient by finite differences (float64), on every ladder
    level."""
    from qoc_tpu_torch.ops.expm import expm
    rng = np.random.default_rng(50 + level)
    a = torch.tensor(_planes(rng, 2, 4, norm), requires_grad=True)
    assert torch.autograd.gradcheck(expm, (a,))


@pytest.fixture()
def expm_forward():
    """set_expm_forward of the port, restored to "auto" after the test."""
    from qoc_tpu_torch.ops import set_expm_forward
    yield set_expm_forward
    set_expm_forward("auto")


@pytest.mark.parametrize("norm", (0.5, 5.0))
def test_taylor_route_above_256_matches_jax(norm, expm_forward):
    """d = 260 pads to 320 > 256: under set_expm_forward("taylor") (on
    CUDA, "auto" there) expm takes expm_taylor forward and, at norm 0.5
    (no squaring), the polynomial's gradient, at norm 5 the dual Taylor
    chain."""
    from qoc_tpu.ops.expm import _frechet_dual_taylor
    from qoc_tpu.ops.expm import expm_taylor as jax_expm_taylor
    from qoc_tpu_torch.ops.expm import expm, expm_taylor
    rng = np.random.default_rng(6)
    a = _planes(rng, 1, 260, norm)
    g = _normal(rng, a.shape)
    want = np.asarray(jax_expm_taylor(jnp.asarray(a)))
    g_want = np.conj(np.asarray(_frechet_dual_taylor(
        jnp.asarray(a.swapaxes(-1, -2)), jnp.asarray(np.conj(g)))))
    expm_forward("taylor")
    at = torch.tensor(a, requires_grad=True)
    got = expm(at)
    g_got, = torch.autograd.grad(got, at, torch.as_tensor(g))
    assert _rel(got.detach().numpy(), want) < 1e-10
    assert _rel(expm_taylor(at.detach()).numpy(), want) < 1e-10
    assert _rel(g_got.numpy(), g_want) < 1e-10


def _jax_expm_and_grad(impl, a, g):
    """qoc_tpu's expm of a and its gradient for the output gradient g
    under its set_expm_forward(impl), in the port's convention."""
    from qoc_tpu.ops.expm import expm as jax_expm
    from qoc_tpu.ops.expm import set_expm_forward as jax_set_expm_forward
    def value_and_vjp(a_, g_):
        out_, vjp = jax.vjp(jax_expm, a_)
        return out_, vjp(g_)[0]

    try:
        jax_set_expm_forward(impl)
        out, grad = jax.jit(value_and_vjp)(jnp.asarray(a),
                                           jnp.asarray(np.conj(g)))
    finally:
        jax_set_expm_forward("auto")
    return np.asarray(out), np.conj(np.asarray(grad))


@pytest.mark.parametrize("impl", ("auto", "pade", "pallas", "taylor"))
def test_set_expm_forward_matches_qoc_tpu(impl, expm_forward, monkeypatch,
                                          interpreted_pallas):
    """Each name at d = 4 (padded 64), a squaring norm: the port's value
    and gradient against qoc_tpu's under the same name; K3/K4's wrappers
    are called under "auto" and "pallas" only. qoc_tpu's "pallas" is its
    float32 kernel pair, interpret mode: expm_taylor_pallas forward and
    expm_frechet_pallas adjoint, on the shapes of the two tests above
    (3 x 12 x 12 and 2 x 10 x 10, padded 64 as d = 4 is), so that their
    compiles serve here too."""
    import importlib
    expm_mod = importlib.import_module("qoc_tpu_torch.ops.expm")
    rng = np.random.default_rng(9)
    calls = []
    for name in ("expm_fwd", "expm_frechet_fwd"):
        wrapper = getattr(expm_mod, name)
        monkeypatch.setattr(expm_mod, name, lambda *args, _w=wrapper, _n=name:
                            calls.append(_n) or _w(*args))
    expm_forward(impl)
    if impl == "pallas":
        from qoc_tpu.ops.expm_pallas import (expm_frechet_pallas,
                                             expm_taylor_pallas)
        a = _planes(rng, 3, 12, 3.0).astype(np.complex64)
        b = _planes(rng, 2, 10, 3.0).astype(np.complex64)
        g = _normal(rng, b.shape).astype(np.complex64)
        got = expm_mod.expm(torch.as_tensor(a))
        want = np.asarray(expm_taylor_pallas(jnp.asarray(a)))
        bt = torch.tensor(b, requires_grad=True)
        g_got, = torch.autograd.grad(expm_mod.expm(bt), bt,
                                     torch.as_tensor(g))
        g_want = np.conj(np.asarray(expm_frechet_pallas(
            jnp.asarray(b.swapaxes(-1, -2)), jnp.asarray(g.conj()))))
        tol = 1e-5
    else:
        a = _planes(rng, 3, 4, 3.0)
        g = _normal(rng, a.shape)
        at = torch.tensor(a, requires_grad=True)
        got = expm_mod.expm(at)
        g_got, = torch.autograd.grad(got, at, torch.as_tensor(g))
        want, g_want = _jax_expm_and_grad(impl, a, g)
        tol = 1e-10
    assert _rel(got.detach().numpy(), want) < tol
    assert _rel(g_got.numpy(), g_want) < tol
    kernels = impl in ("auto", "pallas")
    assert calls == (["expm_fwd", "expm_fwd", "expm_frechet_fwd"]
                     if impl == "pallas" else
                     ["expm_fwd", "expm_frechet_fwd"] if kernels else [])
    assert expm_mod.approximant(4, "cpu") == ("kernels" if kernels
                                              else impl)


def test_auto_above_256_is_pade_on_the_cpu():
    """On the CPU "auto" takes Padé-13 above padded 256, as qoc_tpu's
    _default_method does there: at d = 260 and a squaring norm (the
    gradient by the block identity) within 1e-10 of qoc_tpu's expm."""
    from qoc_tpu_torch.ops.expm import approximant, expm
    rng = np.random.default_rng(10)
    a = _planes(rng, 1, 260, 8.0)
    g = _normal(rng, a.shape)
    at = torch.tensor(a, requires_grad=True)
    got = expm(at)
    g_got, = torch.autograd.grad(got, at, torch.as_tensor(g))
    want, g_want = _jax_expm_and_grad("auto", a, g)
    assert approximant(260, "cpu") == "pade"
    assert _rel(got.detach().numpy(), want) < 1e-10
    assert _rel(g_got.numpy(), g_want) < 1e-10


def test_set_expm_forward_refuses_other_names():
    from qoc_tpu_torch.ops import set_expm_forward
    with pytest.raises(ValueError, match="Unknown expm forward"):
        set_expm_forward("eigh")


def test_pade_eigh_and_frechet_match_jax():
    from qoc_tpu.ops.expm import expm_eigh as jax_expm_eigh
    from qoc_tpu.ops.expm import expm_frechet as jax_expm_frechet
    from qoc_tpu.ops.expm import expm_pade as jax_expm_pade
    from qoc_tpu_torch.ops.expm import expm_eigh, expm_frechet, expm_pade
    rng = np.random.default_rng(7)
    a = 2.0 * _normal(rng, (2, 5, 5))
    e = _normal(rng, a.shape)
    h = a + np.conj(a.swapaxes(-1, -2))
    at, et = torch.as_tensor(a), torch.as_tensor(e)
    assert _rel(expm_pade(at).numpy(),
                jax_expm_pade(jnp.asarray(a))) < 1e-12
    assert _rel(expm_eigh(torch.as_tensor(h)).numpy(),
                jax_expm_eigh(jnp.asarray(h))) < 1e-12
    assert _rel(expm_frechet(at, et).numpy(),
                jax_expm_frechet(jnp.asarray(a), jnp.asarray(e))) < 1e-8


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors K3/K4's wrappers are their plain versions: the same
    results at any d, and no launch counted."""
    from qoc_tpu_torch.ops import expm_cuda
    rng = np.random.default_rng(8)
    a = torch.as_tensor(_planes(rng, 3, 70, 2.0))
    g = torch.as_tensor(_normal(rng, (3, 70, 70)))
    launches = (expm_cuda.expm_fwd.launches,
                expm_cuda.expm_frechet_fwd.launches)
    assert torch.equal(expm_cuda.expm_fwd(a), expm_cuda.expm_fwd_plain(a))
    assert torch.equal(expm_cuda.expm_frechet_fwd(a, g),
                       expm_cuda.expm_frechet_plain(a, g))
    assert (expm_cuda.expm_fwd.launches,
            expm_cuda.expm_frechet_fwd.launches) == launches


@pytest.mark.parametrize("d,dp", ((1, 64), (64, 64), (65, 128), (96, 128),
                                  (256, 256), (257, 320)))
def test_kernel_dp(d, dp):
    from qoc_tpu_torch.ops.expm_cuda import kernel_dp
    assert kernel_dp(d) == dp


class _FakeCuda:
    """What the wrappers' checks read of a CUDA tensor: device, dtype and
    shape (there is no card here; the checks run before any launch)."""

    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)


def test_cuda_wrappers_refuse_what_the_kernels_cannot_take():
    """A CUDA tensor the kernels cannot take raises; nothing falls back to
    the plain version."""
    from qoc_tpu_torch.ops import expm_cuda
    with pytest.raises(TypeError, match="complex64"):
        expm_cuda.expm_fwd(_FakeCuda((2, 8, 8), torch.complex128))
    with pytest.raises(ValueError, match="padded d <= 256"):
        expm_cuda.expm_fwd(_FakeCuda((2, 260, 260), torch.complex64))
    with pytest.raises(ValueError, match="shape"):
        expm_cuda.expm_frechet_fwd(_FakeCuda((2, 8, 8), torch.complex64),
                                   _FakeCuda((3, 8, 8), torch.complex64))
