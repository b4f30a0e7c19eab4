"""Matrix exponential with an exact Fréchet-derivative gradient.

Counterpart of ``qoc_tpu/ops/expm.py``. :func:`expm` is a
``torch.autograd.Function``: the gradient of exp at A is the Fréchet
derivative L(A^H, G) of the output's gradient G (PyTorch's convention,
dL/dRe + i dL/dIm), evaluated directly instead of differentiating through
the algorithm. :func:`set_expm_forward` picks the forward as ``qoc_tpu``'s
does, with its four names:

- ``"auto"`` (the default) and ``"pallas"``: padded d <= 256 runs the
  kernels K3 (forward) and K4 (gradient) of ``ops/expm_cuda.py`` (on CUDA
  they launch or raise, on the CPU they are their plain versions, in the
  caller's dtype); above that the approximant of :func:`approximant`: on
  the CPU Padé-13, ``qoc_tpu``'s ``_default_method`` there, and on CUDA
  Taylor, which an H100 measured faster (``_CUDA_AUTO``);
- ``"taylor"``: :func:`expm_taylor` on ``torch.matmul`` at every size;
- ``"pade"``: Padé-13 with ``torch.linalg.solve`` at every size.

The gradient is the exact Fréchet adjoint whatever the forward, chosen as
``qoc_tpu``'s ``_expm_bwd`` chooses: K4 under the kernels; without
squarings anywhere in the batch the gradient of the approximant, else the
dual-number Taylor chain (``_frechet_dual_taylor``, Taylor) or the block
identity on [[A^H, G], [0, A^H]] (Padé). "taylor" and "pade" launch no
kernel, and on CUDA no name gives way to another route when a kernel
fails to build or launch.

In the bf16_3x precision mode (``config.MXU_MODE``, float32 work) expm
runs K3/K4 in the mode, and :func:`expm_taylor` and the Padé forward run
every product as the 3-pass TF32 split on ``torch.matmul`` (``qoc_tpu``'s
``_mul``; the solve stays FP32), their squarings on X - I as the kernels
run them; the backward runs in the forward's mode, Padé's by the dual
Taylor chain.

:func:`expm_pade` (Padé-13, differentiable through the algorithm) and
:func:`expm_eigh` are the oracles and alternatives, as in ``qoc_tpu``.
The port never calls ``torch.linalg.matrix_exp``. All functions batch over
leading axes.
"""

import torch

from qoc_tpu_torch import config
from qoc_tpu_torch.ops.chain import (_MUL, _Dual, _scale_and_square,
                                     _squaring_count, _taylor8, _taylor19)
from qoc_tpu_torch.ops.expm_cuda import (KERNEL_MAX_DP, expm_frechet_fwd,
                                         expm_fwd, kernel_dp)

__all__ = ["approximant", "expm", "expm_eigh", "expm_frechet", "expm_pade",
           "expm_taylor", "set_expm_forward"]

# Padé-13 numerator coefficients b_0..b_13 (Higham 2005, Table 10.4).
_B = (64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
      1187353796428800.0, 129060195264000.0, 10559470521600.0,
      670442572800.0, 33522128640.0, 1323241920.0, 40840800.0, 960960.0,
      16380.0, 182.0, 1.0)
# Largest 1-norm at which Padé-13 meets double rounding (Higham 2005).
_THETA_13 = 5.371920351148152
# Taylor scaling threshold and the degree-8 short cut, f64-calibrated
# (qoc_tpu expm.py _THETA_TAYLOR, _THETA_TAYLOR_8).
_THETA_TAYLOR = 1.0
_THETA_TAYLOR_8 = 0.25


# The forward implementation (qoc_tpu's _EXPM_FORWARD).
_EXPM_FORWARD = {"impl": "auto"}
# "auto"'s approximant above padded d = 256 on CUDA: Taylor, faster than
# Padé-13 at forward plus gradient in both precision modes at d = 300, 512
# and 1024, complex64, on an H100 (chip_smoke.py phase 45; PERF.md
# section 6).
_CUDA_AUTO = "taylor"


def set_expm_forward(impl):
    """Select the expm forward implementation: 'auto' | 'taylor' | 'pade' |
    'pallas' (module docstring; qoc_tpu's names)."""
    if impl not in ("auto", "taylor", "pade", "pallas"):
        raise ValueError("Unknown expm forward implementation: {}"
                         "".format(impl))
    _EXPM_FORWARD["impl"] = impl


def approximant(d, device):
    """'kernels' (K3/K4), 'taylor' or 'pade': what :func:`expm` runs for
    (..., d, d) matrices on ``device`` under the current
    :func:`set_expm_forward` choice."""
    impl = _EXPM_FORWARD["impl"]
    if impl in ("taylor", "pade"):
        return impl
    if kernel_dp(d) <= KERNEL_MAX_DP:
        return "kernels"
    return _CUDA_AUTO if torch.device(device).type == "cuda" else "pade"


def _taylor_poly(m, eye, mul=_MUL["highest"]):
    """Degree 8 when the whole (scaled) batch has 1-norm <= 0.25, else
    degree 19 (qoc_tpu expm.py _taylor_poly), products by ``mul``; ``m`` a
    tensor or a _Dual, the degree read from its value on the host. Degree 8
    is the 3-product scheme of the same polynomial (ops/chain.py
    _taylor8)."""
    v = m.v if isinstance(m, _Dual) else m
    small = bool(torch.abs(v).sum(dim=-2).amax() <= _THETA_TAYLOR_8)
    return (_taylor8 if small else _taylor19)(m, eye, mul)


def _taylor_core(m, max_squarings, mode):
    """Taylor scaling and squaring of m (a tensor or a _Dual) in precision
    ``mode``: ``_scale_and_square`` with :func:`_taylor_poly`, every product
    by the mode's (the squarings on X - I in the bf16_3x mode)."""
    mul = _MUL[mode]
    return _scale_and_square(m, lambda x, eye: _taylor_poly(x, eye, mul),
                             _THETA_TAYLOR, max_squarings, mul)


def _pade13(m, eye, mul=_MUL["highest"]):
    """The order-13 Padé approximant r = (V - U)^-1 (V + U), products by
    ``mul``."""
    m2 = mul(m, m)
    m4 = mul(m2, m2)
    m6 = mul(m2, m4)
    u = mul(m, mul(m6, _B[13] * m6 + _B[11] * m4 + _B[9] * m2)
            + _B[7] * m6 + _B[5] * m4 + _B[3] * m2 + _B[1] * eye)
    v = (mul(m6, _B[12] * m6 + _B[10] * m4 + _B[8] * m2)
         + _B[6] * m6 + _B[4] * m4 + _B[2] * m2 + _B[0] * eye)
    return torch.linalg.solve(v - u, v + u)


def _pade_core(a, max_squarings, mode):
    """Padé-13 scaling and squaring of a in precision ``mode``."""
    mul = _MUL[mode]
    return _scale_and_square(a, lambda x, eye: _pade13(x, eye, mul),
                             _THETA_13, max_squarings, mul)


def expm_taylor(a, max_squarings=None):
    """Solve-free Taylor scaling and squaring (qoc_tpu expm_taylor): every
    matrix scaled to 1-norm <= 1, degree 8 or 19 (:func:`_taylor_poly`),
    then its own number of squarings, masked: max(s) of them (read on the
    host), or ``max_squarings``. In the bf16_3x mode (float32 work) every
    product is the 3-pass TF32 split (``qoc_tpu``'s ``_mul``). Exact
    products are differentiable by autograd through the algorithm;
    :func:`expm` differentiates either by the Fréchet derivative."""
    return _taylor_core(a, max_squarings, config.mxu_mode(a.dtype))


def expm_pade(a, max_squarings=16):
    """Padé-13 scaling and squaring with ``max_squarings`` masked squarings
    (qoc_tpu expm_pade): the oracle, differentiable by autograd through the
    algorithm."""
    return _pade_core(a, max_squarings, "highest")


def _frechet_dual_taylor(b, g, mode="highest"):
    """L(b, g) by the dual-number Taylor scaling-squaring chain (qoc_tpu
    expm.py _frechet_dual_taylor), in precision ``mode``: exact for any
    norm."""
    return _taylor_core(_Dual(b, g), None, mode).dv


def _taylor_grad(a, g, mode="highest"):
    """The gradient of :func:`expm_taylor` at a for the output gradient g
    (qoc_tpu expm.py _expm_bwd, Taylor method): without squarings anywhere
    in the batch, the gradient of the polynomial; else L(a^H, g) by the dual
    chain. In the bf16_3x mode always the dual chain (the polynomial's
    Fréchet derivative where nothing squares), its products the mode's."""
    if mode == "bf16_3x":
        return _frechet_dual_taylor(a.mH, g, mode)
    if not bool(_squaring_count(a, _THETA_TAYLOR).any()):
        with torch.enable_grad():
            x = a.detach().requires_grad_(True)
            eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
            return torch.autograd.grad(_taylor_poly(x, eye), x, g)[0]
    return _frechet_dual_taylor(a.mH, g)


def _pade_grad(a, g, mode="highest"):
    """The gradient of the Padé forward at a for the output gradient g
    (qoc_tpu expm.py _expm_bwd, Padé method): without squarings anywhere in
    the batch, the gradient of the approximant; else L(a^H, g) by the block
    identity (:func:`expm_frechet`, Padé at 2d: the forward's choice
    holds there too). In the bf16_3x mode the dual Taylor chain."""
    if mode == "bf16_3x":
        return _frechet_dual_taylor(a.mH, g, mode)
    if not bool(_squaring_count(a, _THETA_13).any()):
        with torch.enable_grad():
            x = a.detach().requires_grad_(True)
            eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
            return torch.autograd.grad(_pade13(x, eye), x, g)[0]
    return expm_frechet(a.mH, g)


_FORWARD = {"kernels": lambda a, mode: expm_fwd(a, mode),
            "taylor": lambda a, mode: _taylor_core(a, None, mode),
            "pade": lambda a, mode: _pade_core(a, None, mode)}
_BACKWARD = {"kernels": lambda a, g, mode: expm_frechet_fwd(a.mH, g, mode),
             "taylor": _taylor_grad, "pade": _pade_grad}


class _Expm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        ctx.mode = config.mxu_mode(a.dtype)
        ctx.method = approximant(a.shape[-1], a.device)
        return _FORWARD[ctx.method](a, ctx.mode)

    @staticmethod
    def backward(ctx, g):
        a, = ctx.saved_tensors
        return _BACKWARD[ctx.method](a, g, ctx.mode)


def expm(a):
    """exp(a) for complex a (..., d, d), with the exact Fréchet gradient
    (module docstring)."""
    return _Expm.apply(a)


def expm_frechet(a, e):
    """The Fréchet derivative L(a, e) = d/dt exp(a + t e) at t = 0, by the
    block identity exp([[a, e], [0, a]]) = [[exp(a), L(a, e)], [0, exp(a)]]
    (qoc_tpu expm_frechet)."""
    d = a.shape[-1]
    top = torch.cat((a, e), dim=-1)
    bottom = torch.cat((torch.zeros_like(a), a), dim=-1)
    return expm(torch.cat((top, bottom), dim=-2))[..., :d, d:]


def expm_eigh(h):
    """exp(-1j h) for Hermitian h by its eigendecomposition (qoc_tpu
    expm_eigh), differentiable through ``torch.linalg.eigh``."""
    w, p = torch.linalg.eigh(h)
    return (p * torch.exp(-1j * w)[..., None, :]) @ p.mH
