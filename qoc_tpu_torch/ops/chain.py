"""Fused expm-product chains: the propagation hot loop of Schrödinger GRAPE.

Counterpart of ``qoc_tpu/ops/chain_pallas.py``. Two ops compute an ordered
product of step exponentials

    U_j = exp(A_j),   P = U_{B-1} ··· U_1 U_0,

and its exact gradient, and in their trajectory form (``return_prefixes``)
every prefix P_t = U_t ··· U_0 as well, with the exact gradient through
both outputs. :class:`ChainExpmPropagate` takes a *linear*
control Hamiltonian under Magnus-M2, A_j = Σ_k W_jk G_k, as real weight
rows W against a constant complex generator basis G.
:class:`PlaneChainPropagate` takes the generators themselves as complex
planes A (B, d, d), built by the caller from any Hamiltonian and Magnus
order (or as weights x basis, ``qoc_tpu``'s ``_stream_planes``); its
gradient flows to the planes. The steps are split into S contiguous
*segments*, independent chains that run in parallel (one CUDA block each,
or one thread-block cluster each for K6) and are merged by log-depth scans
of matrix products; S is picked to fill the card's SMs.

Both ops also take a member axis (``qoc_tpu``'s batched form, the chains
of ensembles and multistart): weights (M, B, n_b) or planes (M, B, d, d)
give M independent chains, totals (M, d, d) and prefixes (M, B, d, d).
Each chain is split into S_m segments (:func:`segment_plan` and
:func:`stream_segment_plan` count the chains), the M·S_m rows go to the
kernels in one launch, and the merge and the seeds run with the member
axis leading, so no scan mixes two chains. S_m = 1 is ``qoc_tpu``'s
grouped packing: no merge, and the seeds are the gradients themselves.

Six kernels carry the ops on CUDA tensors, each beside its plain PyTorch
version of the same math:

- K1, :func:`chain_fwd` (``csrc/chain_fwd.cu``): every segment's prefixes
  P_t by the f32 Taylor ladder. Plain version :func:`chain_fwd_plain`.
- K2, :func:`chain_bwd` (``csrc/chain_bwd.cu``): the exact adjoint,
  T_t = U_{t+1}^H T_{t+1} (+ seed_t in the per-step-seed mode of the
  trajectory form), gU_t = T_t P_{t-1}^H and the dual-number Taylor at
  (A_t^H, gU_t), which gives U_t^H and gA_t = L(A_t^H, gU_t). Plain version
  :func:`chain_bwd_plain`.
- K5, :func:`plane_fwd` (``csrc/plane_fwd.cu``) and :func:`plane_bwd`
  (``csrc/plane_bwd.cu``): K1 and K2 with the generator read from its
  plane instead of built from the basis. Plain versions
  :func:`plane_fwd_plain` and :func:`plane_bwd_plain`.
- K6, :func:`stream_fwd` (``csrc/stream_fwd.cu``) and :func:`stream_bwd`
  (``csrc/stream_bwd.cu``): K5's math at 256 < padded d <= 512, where one
  matrix no longer fits a block: the ladder in a device workspace, each
  segment advanced by the 8 blocks of a cluster. Its plain versions are
  K5's (:data:`stream_fwd_plain` and :data:`stream_bwd_plain` name them).

The plane op takes K5 at padded d <= 64 and K6 at 256 < padded d <= 512;
between those the caller takes the blocked route (``ops/expm.py``). A
wrapper takes its plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises. The kernels are f32: on CUDA the ops
run in float32/complex64. On the CPU they run in the caller's dtype
(float64 for parity with ``qoc_tpu``), with the same f32-calibrated ladder.

Precision mode (``config.MXU_MODE``, ``qoc_tpu``'s
``QOC_TPU_MXU_PRECISION``): in ``"bf16_3x"`` every float32 product of the
ladder and the chain steps is the 3-pass TF32 split (:func:`_matmul_3x`,
on the card's tensor cores in the kernels) and degree 12 is ``_D12A``
(:func:`_taylor12_4`). The ops read the mode when called and run their
backward in the forward's; each wrapper takes it as ``mode`` (None: the
switch as it stands) and counts its launches in it (``mode_launches``).
Every kernel has its mode form (K1, K2, K5 resident; K6 tiled); a route
in the mode runs it or raises, never the exact kernel in its place.

Gradient convention: PyTorch's ``grad`` of a complex tensor is
dL/dRe + i dL/dIm, the conjugate of JAX's cotangent. The JAX ops therefore
seed their adjoint with ``conj(gbar)`` and carry a conjugated recursion;
here the same recursion is the plain gradient one: the segment seeds are
Sf_s^H g C_{s-1}^H (per step, :func:`_segment_seeds`), gA is the planes'
gradient as it stands, and the weight gradient is Re Σ conj(G_k) ∘ gA.
"""

import ctypes
import functools
import hashlib
import math
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from qoc_tpu_torch import config
from qoc_tpu_torch.config import complex_dtype

__all__ = ["ChainExpmPropagate", "PlaneChainPropagate", "chain_block_plan",
           "chain_bwd", "chain_bwd_plain", "chain_fwd", "chain_fwd_plain",
           "kernel_dp", "ladder_level", "load_kernels", "plane_bwd",
           "per_step_seeds", "plane_bwd_plain", "plane_chain_propagate",
           "plane_chain_propagate_prefixes", "plane_fwd", "plane_fwd_plain",
           "resident_block", "segment_plan", "stream_bwd",
           "stream_bwd_plain", "stream_fwd", "stream_fwd_plain",
           "stream_grid", "stream_segment_plan", "uses_stream", "KERNEL_DP",
           "STREAM_MAX_DP", "STREAM_MIN_DP"]

# K1/K2/K5's matrix dimension (csrc/chain_common.cuh DP): smaller d is
# zero-padded to it (exact), larger d is refused.
KERNEL_DP = 64
# K6's padded dimensions: multiples of 64 in (256, 512]
# (qoc_tpu/ops/chain_pallas.py _STREAM_MAX).
_ALIGN = 64
STREAM_MIN_DP = 320
STREAM_MAX_DP = 512

# f32-calibrated Taylor degree ladder (qoc_tpu/ops/expm_pallas.py
# _F32_LADDER): (degree, batch-max norm threshold). Above the last
# threshold: per-matrix scaling to theta = 1, T19 and squarings.
_F32_LADDER = ((4, 0.05), (8, 0.45), (12, 1.2), (19, 3.0))
_THETA = 1.0
_MAX_SQUARINGS = 60
_TAYLOR_COEFFS = tuple(1.0 / math.factorial(k) for k in range(20))
# Degree-8 Taylor in 3 products (expm_pallas.py _D8X).
_D8X = (-0.2791515105738877, -0.06978787764347194, 1.9965103670821102,
        -1.0443935504465197, -0.06254782056757438, -0.024382370915357013,
        0.005092363918911529, 1.0, 1.0, 2.585142563711936)
# Degree-12 Taylor in 4 products (expm_pallas.py _D12A), the bf16_3x mode's
# degree 12: rows a_i of lin(i) = a_i0 I + a_i1 M + a_i2 M2 + a_i3 M3.
_D12A = ((2.50924541e+00, 2.50145758e+00, 6.68628695e-01, 6.22278884e-02),
         (5.58758752e+00, 1.71336946e+00, 1.60849759e-01, -1.44147961e-03),
         (-2.84603020e-01, -2.02022795e-01, 1.89875093e-02, 1.23719677e-02),
         (0.0, 1.31810610e-01, 2.02785554e-02, 6.75951847e-03))

# Segment plan: at least this many steps per segment, and at most this many
# rows (segments of all chains) when the chains alone do not fill the card:
# K1/K2 run one block an SM (their shared memory), and an H100 has 132 SMs,
# so 128 rows are one wave. A constant, not the device's SM count, so that
# the CPU walks the plan the card takes.
_MIN_SEGMENT_STEPS = 8
_MAX_SEGMENTS = 128
# Rows of weights whose generators one pass of _norm_max forms at once.
_NORM_CHUNK_BYTES = 256 * 1024 ** 2
# K6's segment plan: the clusters of 8 blocks an H100 keeps resident at
# padded 320-512 (120 of its 132 SMs; the grid chip_smoke.py phases 20 and
# 35 print), and what one segment of a chain adds to the merge and seed
# scans, per scan level, in cluster-steps of K6 (a step's forward and
# adjoint on one cluster): about 0.04 ms against 4.9 ms at padded 448 on
# the H100 (phase 35); the plan tries at most 64 segments a chain. A
# constant, not the device's count, so that the CPU walks the plan the card
# takes.
_STREAM_CLUSTERS = 15
_STREAM_SEGMENT_COST = 0.01
_STREAM_MAX_SEGMENTS = 64
# Share of the free device memory K6's workspace may take.
_STREAM_WORKSPACE_SHARE = 0.5

# Time-block plan: bytes one block may hold per step for the backward
# (see chain_block_plan).
_BLOCK_BYTES = 2 * 1024 ** 3


# ---------------------------------------------------------------------------
# Kernel library: built from csrc/ at first use, keyed by a source hash
# ---------------------------------------------------------------------------

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = ("chain_fwd.cu", "chain_bwd.cu", "plane_fwd.cu", "plane_bwd.cu",
            "expm_fwd.cu", "expm_frechet.cu", "stream_fwd.cu",
            "stream_bwd.cu")
_HEADERS = ("chain_common.cuh", "expm_common.cuh")
_BUILD_DIR = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v")


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the chain kernels.")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(out_dir, lib_path):
    """One nvcc per source, all started together, then one link. The
    compilers' output (ptxas register/spill report) goes to build.log."""
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [out_dir / "{}.{}.o".format(name, tag) for name in _SOURCES]
    procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj),
                               str(_CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for name, obj in zip(_SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = out_dir / "libqoc_chain.{}.so".format(tag)
    failed = [name for name, proc in zip(_SOURCES, procs) if proc.returncode]
    if not failed:
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True, check=False)
        logs.append(link.stdout + link.stderr)
        if link.returncode:
            failed.append("link")
    (out_dir / "build.log").write_text("".join(
        "== {}\n{}".format(name, log)
        for name, log in zip((*_SOURCES, "link"), logs)))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("building the CUDA kernels failed ({}):\n{}"
                           .format(", ".join(failed), "".join(logs)))
    os.replace(tmp, lib_path)


def build_dir():
    """The kernels' build directory for the current sources and flags,
    ``qoc_tpu_torch/_build/<hash>/``; its ``build.log`` holds the
    compiler's register/spill report."""
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        digest.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / digest.hexdigest()[:16]


@functools.cache
def load_kernels():
    """Build the kernels' shared library, K1/K2/K5/K6 here and K3/K4 of
    ``ops/expm_cuda.py`` (once per source hash, into :func:`build_dir`),
    and load it with ctypes."""
    out_dir = build_dir()
    lib_path = out_dir / "libqoc_chain.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        _build(out_dir, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    # The int before the stream: 1 for the bf16_3x mode.
    lib.qoc_chain_fwd.argtypes = [ptr, ptr, ptr, ptr, cint, cint, cint, cint,
                                  ptr]
    lib.qoc_chain_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, cint,
                                  cint, cint, cint, cint, ptr]
    lib.qoc_plane_fwd.argtypes = [ptr, ptr, ptr, cint, cint, cint, ptr]
    lib.qoc_plane_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, cint, cint,
                                  cint, cint, ptr]
    lib.qoc_expm_fwd.argtypes = [ptr, ptr, ptr, ptr, cint, cint, cint, cint,
                                 ptr]
    lib.qoc_expm_frechet.argtypes = [ptr, ptr, ptr, ptr, ptr, cint, cint,
                                     cint, cint, ptr]
    lib.qoc_stream_fwd.argtypes = [ptr, ptr, ptr, ptr, cint, cint, cint,
                                   cint, cint, ptr]
    lib.qoc_stream_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, cint, cint,
                                   cint, cint, cint, cint, ptr]
    cint_p = ctypes.POINTER(cint)
    lib.qoc_chain_block.argtypes = [cint, cint, cint_p, cint_p]
    lib.qoc_forward_form.argtypes = [cint_p]
    lib.qoc_expm_fwd_plan.argtypes = [cint, cint_p, cint_p, cint_p]
    lib.qoc_expm_frechet_plan.argtypes = [cint, cint_p, cint_p, cint_p]
    lib.qoc_stream_fwd_plan.argtypes = [cint, cint_p, cint_p, cint_p, cint_p]
    lib.qoc_stream_bwd_plan.argtypes = [cint, cint_p, cint_p, cint_p, cint_p]
    lib.qoc_tiled_tc_layout.argtypes = [cint, cint, cint_p]
    for fn in (lib.qoc_chain_fwd, lib.qoc_chain_bwd, lib.qoc_plane_fwd,
               lib.qoc_plane_bwd, lib.qoc_chain_dp, lib.qoc_chain_stash_slots,
               lib.qoc_expm_fwd, lib.qoc_expm_frechet, lib.qoc_expm_fwd_plan,
               lib.qoc_expm_frechet_plan, lib.qoc_stream_fwd,
               lib.qoc_stream_bwd, lib.qoc_stream_fwd_plan,
               lib.qoc_stream_bwd_plan, lib.qoc_tiled_tc_layout,
               lib.qoc_chain_block, lib.qoc_forward_form):
        fn.restype = cint
    if lib.qoc_chain_dp() != KERNEL_DP:
        raise RuntimeError("chain kernel library DP {} != {}".format(
            lib.qoc_chain_dp(), KERNEL_DP))
    return lib


_RESIDENT_KERNELS = {"K1": 1, "K5 fwd": 1, "K2": 2, "K5 bwd": 5, "K4": 4}


def resident_block(kernel, tf32=0):
    """(threads, dynamic shared-memory bytes) a block of a resident kernel,
    ``kernel`` one of "K1", "K5 fwd" (the forwards' block), "K2", "K5 bwd"
    or "K4" (at dp = 64, whose shared memory is the dual ladder's six
    slots), as its C entry launches it for ``tf32`` (0 exact, 1 the bf16_3x
    mode)."""
    out = [ctypes.c_int() for _ in range(2)]
    err = load_kernels().qoc_chain_block(_RESIDENT_KERNELS[kernel], tf32,
                                         *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError("qoc_chain_block failed: CUDA error {}".format(
            err))
    return tuple(x.value for x in out)


def _check_norm(norm, dev):
    if (norm.dtype != torch.float32 or norm.numel() != 1
            or norm.device != dev):
        raise ValueError("norm must be one float32 value on the kernel "
                         "inputs' device")


def _check_mats(dev, *mats, dp=KERNEL_DP):
    for m in mats:
        if (m.dtype != torch.complex64 or m.device != dev
                or not m.is_contiguous() or m.shape[-2:] != (dp, dp)):
            raise ValueError(
                "chain kernel matrices must be contiguous complex64 "
                "(..., {0}, {0}) tensors on one device".format(dp))


def _check_weights(w, norm, *mats):
    if w.dtype != torch.float32:
        raise TypeError("the chain kernels take float32 weights")
    if w.dim() != 3 or not w.is_contiguous():
        raise ValueError("weights must be a contiguous (S, L, n_b) tensor")
    _check_norm(norm, w.device)
    _check_mats(w.device, *mats)


def _check_planes(a, norm, *mats, dp=KERNEL_DP):
    if a.dim() != 4:
        raise ValueError("planes must be an (S, L, {0}, {0}) tensor".format(
            dp))
    _check_mats(a.device, a, *mats, dp=dp)
    _check_norm(norm, a.device)


def _check_device(x, name):
    if x.device.type != "cuda":
        raise ValueError("{} runs on cpu or cuda tensors, got {}".format(
            name, x.device))


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def kernel_dp(d):
    """The kernels' padded dimension for d: d rounded up to a multiple of
    64."""
    return -(-d // _ALIGN) * _ALIGN


def uses_stream(d):
    """True where the plane op runs K6: 256 < padded d <= 512."""
    return STREAM_MIN_DP <= kernel_dp(d) <= STREAM_MAX_DP


# ---------------------------------------------------------------------------
# Plain PyTorch versions (same math as the kernels)
# ---------------------------------------------------------------------------


class _Dual:
    """Dual number (value, tangent) of matrices: (X, dX)(Y, dY) =
    (XY, dX Y + X dY). Lets one Taylor routine serve exp and its Fréchet
    derivative, as the kernels' dual evaluation does."""

    __slots__ = ("v", "dv")

    def __init__(self, v, dv):
        self.v = v
        self.dv = dv

    def __matmul__(self, other):
        return _Dual(self.v @ other.v, self.dv @ other.v + self.v @ other.dv)

    def __add__(self, other):
        if isinstance(other, _Dual):
            return _Dual(self.v + other.v, self.dv + other.dv)
        return _Dual(self.v + other, self.dv)    # constant: no tangent

    __radd__ = __add__

    def __mul__(self, scale):
        return _Dual(self.v * scale, self.dv * scale)

    __rmul__ = __mul__


def _matmul(x, y):
    """The exact product, of tensors or _Duals."""
    return x @ y


def _tf32(x):
    """float32 x rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: on the bits, half a TF32 unit added
    to the magnitude and the 13 low bits cleared (inf and NaN kept)."""
    bits = x.view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _split_tf32(x):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi), for float32 or, plane
    by plane, complex64 x: the kernels' operand split in the bf16_3x
    mode."""
    if x.is_complex():
        hi, lo = _split_tf32(torch.view_as_real(x.resolve_conj()))
        return torch.view_as_complex(hi), torch.view_as_complex(lo)
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _matmul_3x(x, y):
    """The bf16_3x mode's product x_hi y_hi + x_hi y_lo + x_lo y_hi of
    tensors (float32 or complex64) or _Duals. Products of TF32 values are
    exact in float32, so it differs from the kernels' tensor-core product
    only in the order of the sums."""
    if isinstance(x, _Dual):
        return _Dual(_matmul_3x(x.v, y.v),
                     _matmul_3x(x.dv, y.v) + _matmul_3x(x.v, y.dv))
    xh, xl = _split_tf32(x)
    yh, yl = _split_tf32(y)
    return xh @ yh + xh @ yl + xl @ yh


_MUL = {"highest": _matmul, "bf16_3x": _matmul_3x}


def _step_product(u, x, mode):
    """u x, a chain step's product (P <- U P forward, T <- U^H T in the
    adjoint). In the bf16_3x mode it is x + (u - I) x, as the kernels form
    it: their tensor-core sums round toward zero, and with u - I (exact)
    that bias scales with the step, not with x; a step with u = I (a
    padded one) leaves x exactly as it was."""
    if mode == "bf16_3x":
        eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
        return x + _matmul_3x(u - eye, x)
    return u @ x


def _mode_of(x, mode):
    """config.mxu_mode for the dtype of x (a tensor or a _Dual)."""
    v = x.v if isinstance(x, _Dual) else x
    return config.mxu_mode(v.dtype, mode)


def _where(mask, a, b):
    if isinstance(a, _Dual):
        return _Dual(torch.where(mask, a.v, b.v), torch.where(mask, a.dv, b.dv))
    return torch.where(mask, a, b)


def _taylor4(m, eye, mul=_matmul):
    c = _TAYLOR_COEFFS
    m2 = mul(m, m)
    return c[0] * eye + c[1] * m + c[2] * m2 + mul(m2, c[3] * m + c[4] * m2)


def _taylor8(m, eye, mul=_matmul):
    x1, x2, x3, x4, x5, x6, x7, y0, y1, y2 = _D8X
    m2 = mul(m, m)
    m4 = mul(m2, x1 * m + x2 * m2)
    m8 = mul(x3 * m2 + m4, x4 * eye + x5 * m + x6 * m2 + x7 * m4)
    return y0 * eye + y1 * m + y2 * m2 + m8


def _chunk(k, eye, m, m2, m3):
    c = _TAYLOR_COEFFS
    return c[k] * eye + c[k + 1] * m + c[k + 2] * m2 + c[k + 3] * m3


def _taylor12(m, eye, mul=_matmul):
    m2 = mul(m, m)
    m3 = mul(m2, m)
    m4 = mul(m2, m2)
    x = _chunk(8, eye, m, m2, m3) + _TAYLOR_COEFFS[12] * m4
    x = _chunk(4, eye, m, m2, m3) + mul(m4, x)
    return _chunk(0, eye, m, m2, m3) + mul(m4, x)


def _taylor12_4(m, eye, mul=_matmul):
    """Degree 12 in 4 products (``_D12A``; qoc_tpu expm_pallas.py
    _taylor12_fast_m, and on _Duals _taylor12_fast_dual): the same Taylor
    polynomial as :func:`_taylor12`, so the ladder's thresholds hold.
    _D12A's T12 = lin(0) + (lin(1) + A6) A6, A6 = lin(2) + lin(3)^2, with
    the constant parts of A6 and Y = lin(1) + A6 taken out (A6 = A6' +
    a20 I, Y = Y' + y0 I, y0 = a10 + a20): T12 = c0 I + lin'(0) + Y' A6' +
    a20 Y' + y0 A6', c0 = a00 + y0 a20. The polynomial is the same, and
    exp(0) is I exactly in float32 (c0 rounds to 1), so zero padding stays
    exact; _D12A as written leaves its constant 1 - 6e-9 off in float64
    and a unit in the last place off in float32."""
    a = _D12A
    y0 = a[1][0] + a[2][0]
    c0 = a[0][0] + y0 * a[2][0]
    m2 = mul(m, m)
    m3 = mul(m2, m)

    def lin(i):           # lin(i) without its constant a_i0 I
        return a[i][1] * m + a[i][2] * m2 + a[i][3] * m3

    b4 = lin(3)           # a_30 = 0
    a6 = lin(2) + mul(b4, b4)
    y = lin(1) + a6
    return c0 * eye + lin(0) + mul(y, a6) + a[2][0] * y + y0 * a6


def _taylor19(m, eye, mul=_matmul):
    m2 = mul(m, m)
    m3 = mul(m2, m)
    m4 = mul(m2, m2)
    p = _chunk(16, eye, m, m2, m3)
    for k in (12, 8, 4, 0):
        p = mul(p, m4) + _chunk(k, eye, m, m2, m3)
    return p


_TAYLOR = (_taylor4, _taylor8, _taylor12, _taylor19)


def ladder_level(norm):
    """Index into the f32 degree ladder for a batch-max norm (a 0-dim
    tensor, compared in its own dtype as the kernels compare in f32):
    0..3 = degree 4/8/12/19, 4 = scaling and squaring. Reads the norm on
    the host (the kernels read it on the device instead)."""
    for j, (_, theta) in enumerate(_F32_LADDER):
        if bool(norm <= theta):
            return j
    return len(_F32_LADDER)


def _squaring_count(v, theta):
    """Per-matrix squaring count s >= 0 with ||v / 2^s||_1 <= theta, as a
    float tensor (qoc_tpu expm.py _squaring_count). fmax, as the kernels'
    fmaxf: a NaN norm gives 0 squarings."""
    norm1 = torch.abs(v).sum(dim=-2).amax(dim=-1)
    s = torch.ceil(torch.log2(torch.fmax(norm1 / theta,
                                         torch.ones_like(norm1))))
    return torch.clamp(s, 0, _MAX_SQUARINGS)


def _scale_and_square(m, approximant, theta=_THETA, max_squarings=None,
                      mul=_matmul):
    """exp of a batch m (a tensor, or a _Dual for the Fréchet derivative) by
    per-matrix scaling to ``theta``, ``approximant(scaled, eye)`` and masked
    squarings (products by ``mul``): max(s) of them (a host read), or
    ``max_squarings``. With the bf16_3x mode's ``_matmul_3x`` the squarings
    run on D = p - I, D <- 2 D + D D, as the kernels run them (see
    :func:`_step_product`)."""
    v = m.v if isinstance(m, _Dual) else m
    eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
    s = _squaring_count(v, theta)
    p = approximant(m * torch.exp2(-s)[..., None, None], eye)
    n = int(s.max()) if max_squarings is None else max_squarings
    if mul is _matmul_3x and n > 0:
        d = p + (-1.0) * eye
        for j in range(n):
            d = _where((j < s)[..., None, None], 2.0 * d + mul(d, d), d)
        return _where((s > 0)[..., None, None], d + eye, p)
    for j in range(n):
        p = _where((j < s)[..., None, None], mul(p, p), p)
    return p


def _expm_ladder(m, level, mode="highest"):
    """exp of a batch of matrices m (a tensor, or a _Dual for the Fréchet
    derivative) at ladder ``level``, in precision ``mode``. The last level
    scales each matrix to theta = 1 and always takes T19 (the kernels' rule
    too); in the bf16_3x mode every product is :func:`_matmul_3x` and
    degree 12 is :func:`_taylor12_4`."""
    mul = _MUL[mode]
    if level < len(_TAYLOR):
        v = m.v if isinstance(m, _Dual) else m
        taylor = (_taylor12_4 if mode == "bf16_3x" and level == 2
                  else _TAYLOR[level])
        return taylor(m, torch.eye(v.shape[-1], dtype=v.dtype,
                                   device=v.device), mul)
    return _scale_and_square(m, lambda x, eye: _taylor19(x, eye, mul),
                             mul=mul)


def _generators(w_t, basis):
    """(S, n_b) real weights x (n_b, dp, dp) basis -> (S, dp, dp)."""
    n_b, dp = basis.shape[0], basis.shape[-1]
    return (w_t.to(basis.dtype) @ basis.reshape(n_b, dp * dp)).reshape(
        -1, dp, dp)


def _prefixes(generator, s_count, length, dp, level, like, mode):
    """The forward recursion: prefpad (S, L+1, dp, dp) with slot 0 = I and
    slot t+1 = exp(generator(t)) ··· exp(generator(0)) of each segment, in
    precision ``mode``."""
    out = torch.empty((s_count, length + 1, dp, dp), dtype=like.dtype,
                      device=like.device)
    p = torch.eye(dp, dtype=like.dtype, device=like.device).expand(
        s_count, dp, dp)
    out[:, 0] = p
    for t in range(length):
        p = _step_product(_expm_ladder(generator(t), level, mode), p, mode)
        out[:, t + 1] = p
    return out


def per_step_seeds(seeds):
    """True for per-step seeds (S, L, dp, dp), false for last-step seeds
    (S, dp, dp): the one rule that picks the adjoint's mode, in the plain
    versions and the kernels alike."""
    return seeds.dim() == 4


def _adjoint(generator_h, length, level, prefpad, seeds, mode):
    """The adjoint recursion: gA (S, L, dp, dp) from the generators' conjugate
    transposes ``generator_h(t)``, the forward's prefpad and the seeds: one a
    segment, at its last step, or one a step (:func:`per_step_seeds`), added
    after the product, T_t = U_{t+1}^H T_{t+1} + seed_t; in precision
    ``mode``."""
    per_step = per_step_seeds(seeds)
    mul = _MUL[mode]
    out = torch.empty((seeds.shape[0], length) + seeds.shape[-2:],
                      dtype=seeds.dtype, device=seeds.device)
    t_cur = seeds[:, -1] if per_step else seeds
    uh = None
    for t in range(length - 1, -1, -1):
        if uh is not None:
            t_cur = _step_product(uh, t_cur, mode)
            if per_step:
                t_cur = t_cur + seeds[:, t]
        gu = mul(t_cur, prefpad[:, t].mH)
        dual = _expm_ladder(_Dual(generator_h(t), gu), level, mode)
        uh = dual.v
        out[:, t] = dual.dv
    return out


def chain_fwd_plain(w, basis, norm, mode=None):
    """Plain version of K1: ``w`` (S, L, n_b) real, ``basis`` (n_b, dp, dp)
    complex, ``norm`` the batch-max 1-norm of the generators, ``mode`` the
    precision mode (None: ``config.MXU_MODE``; float64 ignores it). Returns
    prefpad (S, L+1, dp, dp): slot 0 = I, slot t+1 = P_t of each segment."""
    return _prefixes(lambda t: _generators(w[:, t], basis), w.shape[0],
                     w.shape[1], basis.shape[-1], ladder_level(norm), basis,
                     _mode_of(basis, mode))


def chain_bwd_plain(w, basis_h, norm, prefpad, seeds, mode=None):
    """Plain version of K2: ``basis_h`` holds G_k^H, ``norm`` is the
    batch-max inf-norm of the generators (the 1-norm of A^H), ``prefpad``
    comes from K1 and ``seeds`` is each segment's gradient at its last
    prefix (S, dp, dp), or at every prefix (S, L, dp, dp): the per-step-seed
    mode; ``mode`` as :func:`chain_fwd_plain`. Returns gA (S, L, dp, dp),
    the gradient of every step's generator."""
    return _adjoint(lambda t: _generators(w[:, t], basis_h), w.shape[1],
                    ladder_level(norm), prefpad, seeds,
                    _mode_of(basis_h, mode))


def plane_fwd_plain(a_seg, norm, mode=None):
    """Plain version of K5 forward: ``a_seg`` (S, L, dp, dp) complex
    generator planes, ``norm`` their batch-max 1-norm, ``mode`` as
    :func:`chain_fwd_plain`. Returns prefpad as :func:`chain_fwd_plain`."""
    return _prefixes(lambda t: a_seg[:, t], a_seg.shape[0], a_seg.shape[1],
                     a_seg.shape[-1], ladder_level(norm), a_seg,
                     _mode_of(a_seg, mode))


def plane_bwd_plain(a_seg, norm, prefpad, seeds, mode=None):
    """Plain version of K5 backward: ``a_seg`` the forward's planes (the
    recursion runs on their conjugate transposes A^H), ``norm`` their
    batch-max inf-norm (the 1-norm of A^H), ``prefpad`` and ``seeds`` as
    :func:`chain_bwd_plain`. Returns gA (S, L, dp, dp), the planes'
    gradient."""
    return _adjoint(lambda t: a_seg[:, t].mH, a_seg.shape[1],
                    ladder_level(norm), prefpad, seeds, _mode_of(a_seg, mode))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _prefpad_out(s_count, length, device):
    out = torch.empty((s_count, length + 1, KERNEL_DP, KERNEL_DP),
                      dtype=torch.complex64, device=device)
    out[:, 0] = torch.eye(KERNEL_DP, dtype=torch.complex64, device=device)
    return out


def _stash(lib, s_count, device):
    return torch.empty((s_count, lib.qoc_chain_stash_slots(), KERNEL_DP,
                        KERNEL_DP), dtype=torch.complex64, device=device)


def chain_fwd(w, basis, norm, mode=None):
    """K1: same contract as :func:`chain_fwd_plain`. On a CPU tensor it is
    the plain version; on a CUDA tensor it launches ``csrc/chain_fwd.cu``
    (float32, dp = :data:`KERNEL_DP`) in ``mode`` or raises.
    ``chain_fwd.launches`` counts every launch, ``chain_fwd.mode_launches``
    those in the bf16_3x mode."""
    mode = _mode_of(basis, mode)
    if w.device.type == "cpu":
        return chain_fwd_plain(w, basis, norm, mode)
    _check_device(w, "chain_fwd")
    _check_weights(w, norm, basis)
    s_count, length, n_b = w.shape
    if basis.shape[0] != n_b:
        raise ValueError("basis has {} terms, weights {}".format(
            basis.shape[0], n_b))
    out = _prefpad_out(s_count, length, w.device)
    tf32 = int(mode == "bf16_3x")
    with torch.cuda.device(w.device):
        err = load_kernels().qoc_chain_fwd(
            w.data_ptr(), basis.data_ptr(), norm.data_ptr(), out.data_ptr(),
            s_count, length, n_b, tf32, _stream(w.device))
    if err != 0:
        raise RuntimeError("chain forward kernel launch failed: CUDA error "
                           "{}".format(err))
    chain_fwd.launches += 1
    chain_fwd.mode_launches += tf32
    return out


chain_fwd.launches = 0
chain_fwd.mode_launches = 0


def _seed_mode(name, seeds, prefpad, s_count, length):
    """1 for per-step seeds, 0 for last-step seeds (:func:`per_step_seeds`),
    after checking them and prefpad against the segment plan (S, L)."""
    per_step = per_step_seeds(seeds)
    want = (s_count, length) if per_step else (s_count,)
    if (prefpad.shape[:2] != (s_count, length + 1)
            or tuple(seeds.shape[:-2]) != want):
        raise ValueError("{}: prefpad {} and seeds {} do not match {} "
                         "segments of {} steps".format(
                             name, tuple(prefpad.shape), tuple(seeds.shape),
                             s_count, length))
    return int(per_step)


def chain_bwd(w, basis_h, norm, prefpad, seeds, mode=None):
    """K2: same contract as :func:`chain_bwd_plain`. On a CPU tensor it is
    the plain version; on a CUDA tensor it launches ``csrc/chain_bwd.cu``
    in the seeds' mode and the precision ``mode`` or raises.
    ``chain_bwd.launches`` counts every launch, ``chain_bwd.step_launches``
    those in the per-step-seed mode, ``chain_bwd.mode_launches`` those in
    the bf16_3x mode."""
    mode = _mode_of(basis_h, mode)
    if w.device.type == "cpu":
        return chain_bwd_plain(w, basis_h, norm, prefpad, seeds, mode)
    _check_device(w, "chain_bwd")
    _check_weights(w, norm, basis_h, prefpad, seeds)
    s_count, length, n_b = w.shape
    if basis_h.shape[0] != n_b:
        raise ValueError("basis has {} terms, weights {}".format(
            basis_h.shape[0], n_b))
    per_step = _seed_mode("chain_bwd", seeds, prefpad, s_count, length)
    lib = load_kernels()
    out = torch.empty((s_count, length, KERNEL_DP, KERNEL_DP),
                      dtype=torch.complex64, device=w.device)
    stash = _stash(lib, s_count, w.device)
    tf32 = int(mode == "bf16_3x")
    with torch.cuda.device(w.device):
        err = lib.qoc_chain_bwd(
            w.data_ptr(), basis_h.data_ptr(), norm.data_ptr(),
            prefpad.data_ptr(), seeds.data_ptr(), out.data_ptr(),
            stash.data_ptr(), s_count, length, n_b, per_step, tf32,
            _stream(w.device))
    if err != 0:
        raise RuntimeError("chain backward kernel launch failed: CUDA error "
                           "{}".format(err))
    chain_bwd.launches += 1
    chain_bwd.step_launches += per_step
    chain_bwd.mode_launches += tf32
    return out


chain_bwd.launches = 0
chain_bwd.step_launches = 0
chain_bwd.mode_launches = 0


def plane_fwd(a_seg, norm, mode=None):
    """K5 forward: same contract as :func:`plane_fwd_plain`. On a CPU tensor
    it is the plain version; on a CUDA tensor it launches
    ``csrc/plane_fwd.cu`` (complex64, dp = :data:`KERNEL_DP`) in ``mode``
    or raises. Counted as :func:`chain_fwd`."""
    mode = _mode_of(a_seg, mode)
    if a_seg.device.type == "cpu":
        return plane_fwd_plain(a_seg, norm, mode)
    _check_device(a_seg, "plane_fwd")
    _check_planes(a_seg, norm)
    s_count, length = a_seg.shape[:2]
    out = _prefpad_out(s_count, length, a_seg.device)
    tf32 = int(mode == "bf16_3x")
    with torch.cuda.device(a_seg.device):
        err = load_kernels().qoc_plane_fwd(
            a_seg.data_ptr(), norm.data_ptr(), out.data_ptr(), s_count,
            length, tf32, _stream(a_seg.device))
    if err != 0:
        raise RuntimeError("plane forward kernel launch failed: CUDA error "
                           "{}".format(err))
    plane_fwd.launches += 1
    plane_fwd.mode_launches += tf32
    return out


plane_fwd.launches = 0
plane_fwd.mode_launches = 0


def plane_bwd(a_seg, norm, prefpad, seeds, mode=None):
    """K5 backward: same contract as :func:`plane_bwd_plain`. On a CPU
    tensor it is the plain version; on a CUDA tensor it launches
    ``csrc/plane_bwd.cu`` in the seeds' mode and the precision ``mode`` or
    raises. Counted as :func:`chain_bwd`."""
    mode = _mode_of(a_seg, mode)
    if a_seg.device.type == "cpu":
        return plane_bwd_plain(a_seg, norm, prefpad, seeds, mode)
    _check_device(a_seg, "plane_bwd")
    _check_planes(a_seg, norm, prefpad, seeds)
    s_count, length = a_seg.shape[:2]
    per_step = _seed_mode("plane_bwd", seeds, prefpad, s_count, length)
    lib = load_kernels()
    out = torch.empty_like(a_seg)
    stash = _stash(lib, s_count, a_seg.device)
    tf32 = int(mode == "bf16_3x")
    with torch.cuda.device(a_seg.device):
        err = lib.qoc_plane_bwd(
            a_seg.data_ptr(), norm.data_ptr(), prefpad.data_ptr(),
            seeds.data_ptr(), out.data_ptr(), stash.data_ptr(), s_count,
            length, per_step, tf32, _stream(a_seg.device))
    if err != 0:
        raise RuntimeError("plane backward kernel launch failed: CUDA error "
                           "{}".format(err))
    plane_bwd.launches += 1
    plane_bwd.step_launches += per_step
    plane_bwd.mode_launches += tf32
    return out


plane_bwd.launches = 0
plane_bwd.step_launches = 0
plane_bwd.mode_launches = 0


# K6's plain versions are K5's: the same recursion at any d, in either
# precision mode.
stream_fwd_plain = plane_fwd_plain
stream_bwd_plain = plane_bwd_plain


@functools.cache
def _stream_plan(dual, dp, device_index):
    """(clusters the card keeps resident, blocks a cluster, workspace
    matrices a cluster, shared-memory bytes a block) of K6's forward or
    adjoint at dp on a device."""
    lib = load_kernels()
    out = [ctypes.c_int() for _ in range(4)]
    fn = lib.qoc_stream_bwd_plan if dual else lib.qoc_stream_fwd_plan
    with torch.cuda.device(device_index):
        err = fn(dp, *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError("K6 launch plan failed: CUDA error {}".format(err))
    return tuple(x.value for x in out)


def stream_grid(dual, dp, s_count, device):
    """(clusters, workspace matrices a cluster) of one K6 launch: one cluster
    a segment, at most as many as the card keeps resident and as many
    workspaces as half the free device memory holds (the caching
    allocator's free blocks counted as free)."""
    clusters, _, slots, _ = _stream_plan(dual, dp, device.index)
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    by_memory = int(free * _STREAM_WORKSPACE_SHARE) // (slots * dp * dp * 8)
    if by_memory < 1:
        raise RuntimeError("K6 needs {} MB of device workspace; {} MB are "
                           "free".format(slots * dp * dp * 8 >> 20,
                                         free >> 20))
    return min(s_count, clusters, by_memory), slots


def _check_stream(name, a_seg, norm, *mats):
    _check_device(a_seg, name)
    dp = a_seg.shape[-1]
    if not (STREAM_MIN_DP <= dp <= STREAM_MAX_DP and dp % _ALIGN == 0):
        raise ValueError("{} takes padded d in {}..{}, a multiple of 64 "
                         "(got {})".format(name, STREAM_MIN_DP,
                                           STREAM_MAX_DP, dp))
    _check_planes(a_seg, norm, *mats, dp=dp)
    return dp


def stream_fwd(a_seg, norm, mode=None):
    """K6 forward: same contract as :func:`plane_fwd_plain`. On a CPU tensor
    it is the plain version; on a CUDA tensor (complex64, dp in
    320..512) it launches ``csrc/stream_fwd.cu`` in ``mode`` or raises.
    Counted as :func:`chain_fwd`."""
    mode = _mode_of(a_seg, mode)
    if a_seg.device.type == "cpu":
        return stream_fwd_plain(a_seg, norm, mode)
    dp = _check_stream("stream_fwd", a_seg, norm)
    s_count, length = a_seg.shape[:2]
    dev = a_seg.device
    out = torch.empty((s_count, length + 1, dp, dp), dtype=torch.complex64,
                      device=dev)
    out[:, 0] = torch.eye(dp, dtype=torch.complex64, device=dev)
    grid, slots = stream_grid(False, dp, s_count, dev)
    ws = torch.empty((grid, slots, dp, dp), dtype=torch.complex64,
                     device=dev)
    tf32 = int(mode == "bf16_3x")
    with torch.cuda.device(dev):
        err = load_kernels().qoc_stream_fwd(
            a_seg.data_ptr(), norm.data_ptr(), out.data_ptr(), ws.data_ptr(),
            s_count, length, dp, grid, tf32, _stream(dev))
    if err != 0:
        raise RuntimeError("K6 forward launch failed: CUDA error {}".format(
            err))
    stream_fwd.launches += 1
    stream_fwd.mode_launches += tf32
    return out


stream_fwd.launches = 0
stream_fwd.mode_launches = 0


def stream_bwd(a_seg, norm, prefpad, seeds, mode=None):
    """K6 adjoint: same contract as :func:`plane_bwd_plain`. On a CPU tensor
    it is the plain version; on a CUDA tensor it launches
    ``csrc/stream_bwd.cu`` in the seeds' mode and the precision ``mode`` or
    raises. Counted as :func:`chain_bwd`."""
    mode = _mode_of(a_seg, mode)
    if a_seg.device.type == "cpu":
        return stream_bwd_plain(a_seg, norm, prefpad, seeds, mode)
    dp = _check_stream("stream_bwd", a_seg, norm, prefpad, seeds)
    s_count, length = a_seg.shape[:2]
    per_step = _seed_mode("stream_bwd", seeds, prefpad, s_count, length)
    dev = a_seg.device
    out = torch.empty_like(a_seg)
    grid, slots = stream_grid(True, dp, s_count, dev)
    ws = torch.empty((grid, slots, dp, dp), dtype=torch.complex64,
                     device=dev)
    tf32 = int(mode == "bf16_3x")
    with torch.cuda.device(dev):
        err = load_kernels().qoc_stream_bwd(
            a_seg.data_ptr(), norm.data_ptr(), prefpad.data_ptr(),
            seeds.data_ptr(), out.data_ptr(), ws.data_ptr(), s_count, length,
            dp, grid, per_step, tf32, _stream(dev))
    if err != 0:
        raise RuntimeError("K6 adjoint launch failed: CUDA error {}".format(
            err))
    stream_bwd.launches += 1
    stream_bwd.step_launches += per_step
    stream_bwd.mode_launches += tf32
    return out


stream_bwd.launches = 0
stream_bwd.step_launches = 0
stream_bwd.mode_launches = 0


# ---------------------------------------------------------------------------
# Glue (plain torch): plans, norms, segment merge, seeds, projection
# ---------------------------------------------------------------------------


def segment_plan(n_steps, n_chains=1):
    """(segments a chain S, steps per segment L) for ``n_chains`` chains of
    ``n_steps``: at least 8 steps a segment, and 128 // n_chains segments a
    chain at most, so the n_chains * S rows of K1/K2 fill one wave of the
    card's SMs when the chains alone do not (4 members x 32 segments, 16 x
    8 at 2000 steps). From 65 chains up a chain is one segment (``qoc_tpu``'s
    grouped packing) and the rows run in waves. The S*L - n_steps padded
    steps of each chain carry zero weights (U = I exactly)."""
    per_chain = max(1, _MAX_SEGMENTS // n_chains)
    length = max(_MIN_SEGMENT_STEPS, -(-n_steps // per_chain))
    return -(-n_steps // length), length


@functools.cache
def stream_segment_plan(n_steps, n_chains=1):
    """K6's (segments a chain S, steps per segment L) for ``n_chains``
    chains of ``n_steps``. The n_chains * S rows go to the card's 15
    resident clusters in waves (cluster c walks rows c, c + 15, ...), so a
    launch lasts waves x L cluster-steps. S minimizes that plus the merge
    and seed scans' share (a hundredth of a cluster-step a segment and scan
    level), the fewer segments on a tie: one chain of 100 steps 15 x 7, 4
    chains of 83 steps 7 x 12 (28 rows in 2 waves), 16 chains of 20 steps
    5 x 4 (80 rows in 6 waves, where one segment a chain would take 2
    waves of 20 steps). The S*L - n_steps padded steps carry zero planes
    (U = I exactly)."""
    best = None
    for s_count in range(1, min(n_steps, _STREAM_MAX_SEGMENTS) + 1):
        length = -(-n_steps // s_count)
        if -(-n_steps // length) != s_count:
            continue                    # the same L on fewer segments
        waves = -(-n_chains * s_count // _STREAM_CLUSTERS)
        cost = waves * length + (_STREAM_SEGMENT_COST * n_chains * s_count
                                 * math.log2(s_count))
        if best is None or cost < best[0]:
            best = (cost, s_count, length)
    return best[1:]


def chain_block_plan(d, n_steps, itemsize=8, planes_per_step=2,
                     n_chains=1):
    """Steps per time block of the loss: as many as keep the block's
    per-step backward state under 2 GiB, ``planes_per_step`` padded
    (dp, dp) matrices of ``itemsize`` bytes a step of each of ``n_chains``
    chains (the members and candidates of ``parallel/``). The basis route
    keeps 2 (its prefix, and the gradient plane the backward writes); the
    plane route adds its input plane and the plane build's autograd graph
    (``core/schroedinger.py``). Planes count at the padded dimension of the
    kernel that serves the block (multiples of 64 up to 512; d itself
    above, where ``torch.matmul`` pads nothing). One block (the whole
    chain, most segments in flight) whenever that fits; the Table-3
    headline (d = 64, 10^4 steps, complex64) holds ~660 MB.

    Blocks hold their residuals until the backward (no remat), so what
    stays on the card is every block's prefixes, n_chains x (n_steps +
    blocks) planes, and the 2 GiB bound one block's transients on top: at
    2048 chains x 200 steps of d = 64 in complex64 (13 blocks of 16 steps)
    13.5 GB of prefixes, well inside an H100's 80 GB."""
    dp = kernel_dp(d) if kernel_dp(d) <= STREAM_MAX_DP else d
    step_bytes = planes_per_step * dp * dp * itemsize * n_chains
    return max(1, min(n_steps, _BLOCK_BYTES // step_bytes))


def _norm_max(w, basis_ri, d):
    """(max_j ||A_j||_1, max_j ||A_j||_inf) over all steps of all chains
    (``w`` (..., n_b)), exactly, on the device (qoc_tpu chain_pallas.py
    _exact_norm_max): the 1-norm picks the forward's Taylor degree, the
    inf-norm (= 1-norm of A^H) the backward's. The generators are formed a
    chunk of rows at a time, so a multistart's 2048 x 200 steps need no
    13 GB temporary."""
    rows = w.reshape(-1, w.shape[-1])
    chunk = max(1, _NORM_CHUNK_BYTES // (basis_ri.shape[-1]
                                         * basis_ri.element_size()))
    n1 = ninf = None
    for part in rows.split(chunk):
        a = (part @ basis_ri).reshape(-1, d, d, 2)
        absa = torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1])
        p1, pinf = absa.sum(dim=-2).amax(), absa.sum(dim=-1).amax()
        n1 = p1 if n1 is None else torch.maximum(n1, p1)
        ninf = pinf if ninf is None else torch.maximum(ninf, pinf)
    return n1, ninf


def _plane_norm_max(a):
    """(max_j ||A_j||_1, max_j ||A_j||_inf) of complex planes (..., d, d)
    over every step of every chain, exactly, on the device (chain_pallas.py
    _plane_fwd's ``norm1``): |A| is formed 256 MB of planes at a time."""
    planes = a.reshape(-1, *a.shape[-2:])
    chunk = max(1, _NORM_CHUNK_BYTES // (planes[0].numel()
                                         * planes.element_size()))
    n1 = ninf = None
    for part in planes.split(chunk):
        absa = part.abs()
        p1, pinf = absa.sum(dim=-2).amax(), absa.sum(dim=-1).amax()
        n1 = p1 if n1 is None else torch.maximum(n1, p1)
        ninf = pinf if ninf is None else torch.maximum(ninf, pinf)
    return n1, ninf


# The merge and seed glue below takes any leading (member) dimensions: the
# segment axis is dim -3 of the (..., S, d, d) segment products and dim -4
# of the kernels' prefpad (..., S, L+1, dp, dp). Every scan runs along the
# segment axis alone, so no product mixes two chains.


def _seg(x, sl):
    """x[..., sl, :, :]: a slice of the segment (or step) axis, dim -3."""
    return x[..., sl, :, :]


def _prefix_products(prods):
    """Inclusive ordered prefix products x[s] = prods[s] ··· prods[0] along
    dim -3 (Hillis-Steele: log2(S) batched matmuls)."""
    off = 1
    while off < prods.shape[-3]:
        prods = torch.cat((_seg(prods, slice(None, off)),
                           _seg(prods, slice(off, None))
                           @ _seg(prods, slice(None, -off))), dim=-3)
        off *= 2
    return prods


def _suffix_products(prods):
    """Inclusive ordered suffix products z[s] = prods[S-1] ··· prods[s]
    along dim -3."""
    off = 1
    while off < prods.shape[-3]:
        prods = torch.cat((_seg(prods, slice(off, None))
                           @ _seg(prods, slice(None, -off)),
                           _seg(prods, slice(-off, None))), dim=-3)
        off *= 2
    return prods


def _merge(prefpad, d):
    """Segment totals (..., S, d, d) and their inclusive prefix products:
    each chain's total is the last of these."""
    prods = prefpad[..., -1, :d, :d]
    return _prefix_products(prods), prods


def _eye_like(x, count=1):
    """Identities (..., count, d, d) with the leading dims of x (..., S, d,
    d)."""
    d = x.shape[-1]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    return eye.expand(*x.shape[:-3], count, d, d)


def _before(cums):
    """C_{s-1} = prods[s-1] ··· prods[0], the product of the segments before
    segment s (C_{-1} = I), from the inclusive prefix products ``cums``."""
    return torch.cat((_eye_like(cums), _seg(cums, slice(None, -1))), dim=-3)


def _compose_prefixes(prefpad, cums, n_steps):
    """Each chain's prefixes P_t = U_t ··· U_0 (..., n_steps, d, d):
    segment s's local prefixes times C_{s-1}, P_{sL+j} = seg_pref[s, j]
    C_{s-1}, one batched product over the kernels' prefpad (qoc_tpu
    chain_pallas.py _compose_prefixes); with one segment a chain the local
    prefixes themselves. Padded steps sit at the tail and are cut off."""
    s_count, length, d = prefpad.shape[-4], prefpad.shape[-3] - 1, \
        cums.shape[-1]
    if s_count == 1:
        glob = prefpad[..., 0, 1:, :d, :d]
    else:
        glob = prefpad[..., 1:, :d, :d] @ _before(cums).unsqueeze(-3)
    return glob.reshape(*prefpad.shape[:-4], s_count * length, d, d)[
        ..., :n_steps, :, :]


def _chain_outputs(prefpad, d, n_steps, return_prefixes):
    """(the op's outputs: the total, or (total, prefixes), cums, prods)."""
    cums, prods = _merge(prefpad, d)
    total = cums[..., -1, :, :].clone()
    if return_prefixes:
        return (total, _compose_prefixes(prefpad, cums, n_steps)), cums, prods
    return total, cums, prods


def _carries(prods, r, grad_total):
    """D_s, the gradient of C_s = prods[s] ··· prods[0] (..., S, d, d), from
    D_{S-1} = grad_total and D_{s-1} = R_s + prods[s]^H D_s: a log-depth
    suffix scan of the affine maps D_{s+1} -> prods[s+1]^H D_{s+1} + R_{s+1}
    (Hillis-Steele, one batched product a level)."""
    d = prods.shape[-1]
    a = torch.cat((_seg(prods, slice(1, None)).mH,
                   torch.zeros_like(_seg(prods, slice(None, 1)))), dim=-3)
    b = torch.cat((_seg(r, slice(1, None)), grad_total.unsqueeze(-3)),
                  dim=-3)
    off = 1
    while off < prods.shape[-3]:
        ab = _seg(a, slice(None, -off)) @ torch.cat(
            (_seg(a, slice(off, None)), _seg(b, slice(off, None))), dim=-1)
        a = torch.cat((ab[..., :d], _seg(a, slice(-off, None))), dim=-3)
        b = torch.cat((ab[..., d:] + _seg(b, slice(None, -off)),
                       _seg(b, slice(-off, None))), dim=-3)
        off *= 2
    return b


def _pad_planes(x, dp):
    """x (..., d, d) zero-padded to (..., dp, dp); x itself at d = dp."""
    d = x.shape[-1]
    if d == dp:
        return x.contiguous()
    out = x.new_zeros(x.shape[:-2] + (dp, dp))
    out[..., :d, :d] = x
    return out


def _segment_seeds(prefpad, cums, prods, dp, grad_total, grad_prefixes=None):
    """The adjoint kernels' seeds, zero-padded to dp, for the gradients of
    the totals (..., d, d) and, in the trajectory form, of the prefixes
    (..., n_steps, d, d); either may be None (no gradient flows there), both
    None gives None. In PyTorch's convention, with C_{s-1} the product of
    the segments before s and Sf_s those after:

    - the total alone: each segment's seed at its last prefix,
      Sf_s^H g C_{s-1}^H (..., S, dp, dp), the last-step-seed mode;
    - with prefix gradients Q (P_{sL+j} = seg_pref[s, j] C_{s-1}): every
      prefix its own seed Q_{s,j} C_{s-1}^H, and at each segment's last step
      also D_s C_{s-1}^H, where D_{S-1} = g, D_{s-1} = R_s + prods[s]^H D_s
      and R_s = Σ_j seg_pref[s, j]^H Q_{s,j} (..., S, L, dp, dp), the
      per-step mode (qoc_tpu chain_pallas.py:1227-1250, there with
      conjugated seeds and transposes).

    With one segment a chain (C = Sf = I) the seeds are the gradients
    themselves, g added at the last step (qoc_tpu chain_pallas.py
    _chain_bwd_grouped, :1166-1174)."""
    if grad_total is None and grad_prefixes is None:
        return None
    s_count, length, d = prefpad.shape[-4], prefpad.shape[-3] - 1, \
        prods.shape[-1]
    lead = prods.shape[:-3]
    g = (torch.zeros_like(prods[..., 0, :, :]) if grad_total is None
         else grad_total.to(prods.dtype))
    if grad_prefixes is None:
        if s_count == 1:
            return _pad_planes(g.unsqueeze(-3), dp)
        after = torch.cat((_seg(_suffix_products(prods), slice(1, None)),
                           _eye_like(prods)), dim=-3)         # Sf_s
        return _pad_planes(after.mH @ g.unsqueeze(-3) @ _before(cums).mH,
                           dp)
    n_steps = grad_prefixes.shape[-3]
    if s_count == 1 and n_steps == length:
        q = torch.cat((_seg(grad_prefixes, slice(None, -1)),
                       (grad_prefixes[..., -1, :, :] + g).unsqueeze(-3)),
                      dim=-3)
        return _pad_planes(q.to(prods.dtype).unsqueeze(-4), dp)
    q = prods.new_zeros(lead + (s_count * length, d, d))
    q[..., :n_steps, :, :] = grad_prefixes
    q = q.reshape(lead + (s_count, length, d, d))
    before_h = _before(cums).mH
    # R_s as one product: the segment's L local prefixes stacked as rows.
    r = (prefpad[..., 1:, :d, :d].reshape(lead + (s_count, length * d, d)).mH
         @ q.reshape(lead + (s_count, length * d, d)))
    seeds = prods.new_zeros(lead + (s_count, length, dp, dp))
    seeds[..., :d, :d] = q @ before_h.unsqueeze(-3)
    seeds[..., -1, :d, :d] += _carries(prods, r, g) @ before_h
    return seeds


class _ChainExpm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, op):
        mode = config.mxu_mode(w.dtype)
        outputs, saved = op._forward(w, mode)
        ctx.set_materialize_grads(False)
        ctx.op, ctx.batched, ctx.n_steps = op, w.dim() == 3, w.shape[-2]
        ctx.mode = mode
        ctx.save_for_backward(*saved)
        return outputs

    @staticmethod
    def backward(ctx, *grads):
        if not ctx.batched:
            grads = [None if g is None else g[None] for g in grads]
        grad_w = ctx.op._backward(grads, *ctx.saved_tensors, mode=ctx.mode)
        if grad_w is None:
            return None, None
        grad_w = grad_w[:, :ctx.n_steps]
        return (grad_w if ctx.batched else grad_w[0]), None


class ChainExpmPropagate:
    """P(w) = exp(A_{B-1}) ··· exp(A_0), A_j = Σ_k w[j, k] G_k, with the
    exact gradient to the real weights ``w`` (B, n_b); with a member axis,
    ``w`` (M, B, n_b), the M chains' totals (M, d, d) (``qoc_tpu``'s
    batched ``make_chain_expm_propagate``, chain_pallas.py:965-1026), all
    in one K1 and one K2 launch.

    ``basis`` :: numpy complex (n_b, d, d), Magnus/dt factors folded in.
    ``device``/``dtype``: the real dtype of ``w``; on CUDA it must be
    float32 (the kernels' type) and d <= :data:`KERNEL_DP`.
    ``plain=True`` runs the plain PyTorch versions of K1/K2 on any device,
    in any dtype and unpadded: the reference the kernels are compared
    with. Propagation never sets it, so on CUDA the op runs the kernels.
    ``return_prefixes=True`` (``qoc_tpu``'s
    ``make_chain_expm_propagate(basis, return_prefixes=True)``, the
    trajectory form): the op returns ``(total, prefixes)``, prefixes[t] =
    exp(A_t) ··· exp(A_0) (B, d, d), or (M, B, d, d), with the exact
    gradient through both; the backward runs K2 in its per-step-seed mode
    when the prefixes carry a gradient.

    The chains share one batch-max norm, so one ladder level serves every
    row (``qoc_tpu``'s ``_exact_norm_max`` over all members), and the W̄
    projection is one product over all rows. The call reads the precision
    mode (``config.MXU_MODE``; float32 only) and its backward runs in it."""

    def __init__(self, basis, device, dtype, plain=False,
                 return_prefixes=False):
        basis = np.asarray(basis)
        device = torch.device(device)
        cdtype = complex_dtype(dtype)
        n_b, d = basis.shape[0], basis.shape[-1]
        if device.type == "cuda" and not plain:
            if dtype != torch.float32:
                raise TypeError("the chain kernels are float32; got "
                                + str(dtype))
            if d > KERNEL_DP:
                raise ValueError(
                    "the chain kernels take d <= {} (got d = {}); larger "
                    "Hilbert spaces take the blocked route (ops/expm.py, "
                    "K3/K4 up to padded d = 256).".format(KERNEL_DP, d))
            dp = KERNEL_DP
        else:
            dp = d
        g = torch.zeros((n_b, dp, dp), dtype=cdtype, device=device)
        g[:, :d, :d] = torch.as_tensor(basis, dtype=cdtype, device=device)
        self.basis = g
        self.basis_h = g.mH.contiguous()
        # Real view of the unpadded basis: norms and the W̄ projection.
        self.basis_ri = torch.view_as_real(
            g[:, :d, :d].contiguous()).reshape(n_b, 2 * d * d)
        self.d, self.dp, self.n_b = d, dp, n_b
        self.return_prefixes = return_prefixes
        if plain:
            self._fwd, self._bwd = chain_fwd_plain, chain_bwd_plain
        else:
            self._fwd, self._bwd = chain_fwd, chain_bwd

    def __call__(self, w):
        return _ChainExpm.apply(w, self)

    def _forward(self, w, mode="highest"):
        w3 = w if w.dim() == 3 else w[None]
        n_chains, n_steps = w3.shape[:2]
        s_count, length = segment_plan(n_steps, n_chains)
        n1, ninf = _norm_max(w3, self.basis_ri, self.d)
        w_seg = w3.new_zeros((n_chains, s_count * length, self.n_b))
        w_seg[:, :n_steps] = w3
        # Segment s of chain m owns its steps [s L, (s+1) L) and is row
        # m S + s of the kernels: a reshape, no transpose.
        w_seg = w_seg.reshape(n_chains * s_count, length, self.n_b)
        prefpad = self._fwd(w_seg, self.basis, n1, mode).reshape(
            n_chains, s_count, length + 1, self.dp, self.dp)
        outputs, cums, prods = _chain_outputs(prefpad, self.d, n_steps,
                                              self.return_prefixes)
        if w.dim() == 2:
            outputs = (tuple(x[0] for x in outputs) if self.return_prefixes
                       else outputs[0])
        return outputs, (w_seg, prefpad, cums, prods, ninf)

    def _backward(self, grads, w_seg, prefpad, cums, prods, ninf,
                  mode="highest"):
        """The weight gradient (M, S L, n_b), padded steps included, for
        the outputs' gradients, each with its member axis (or None), in
        precision ``mode``."""
        n_chains, s_count, length = prefpad.shape[:3]
        rows, length, d = n_chains * s_count, length - 1, self.d
        seeds = _segment_seeds(prefpad, cums, prods, self.dp, *grads)
        if seeds is None:
            return None
        grad_a = self._bwd(w_seg, self.basis_h, ninf,
                           prefpad.reshape(rows, length + 1, self.dp,
                                           self.dp),
                           seeds.reshape(rows, *seeds.shape[2:]), mode)
        grad_a = torch.view_as_real(grad_a[..., :d, :d]).reshape(
            rows * length, 2 * d * d)
        return (grad_a @ self.basis_ri.T).reshape(
            n_chains, s_count * length, self.n_b)


def _plane_route(d, device, plain):
    """(padded d, segment plan, forward, adjoint) of the plane op at d on
    ``device``: K5 at padded d <= 64, K6 at 256 < padded d <= 512 (on the
    CPU the plain versions, unpadded, on the same segment plan)."""
    stream = uses_stream(d)
    plan = stream_segment_plan if stream else segment_plan
    if plain:
        fns = (plane_fwd_plain, plane_bwd_plain)
    else:
        fns = (stream_fwd, stream_bwd) if stream else (plane_fwd, plane_bwd)
    if device.type != "cuda":
        return d, plan, *fns
    if stream:
        return kernel_dp(d), plan, *fns
    if d > KERNEL_DP:
        raise ValueError(
            "the plane kernels take d <= {} (K5) or padded d in {}..{} (K6); "
            "got d = {}: take the blocked route (ops/expm.py, K3/K4 up to "
            "padded d = 256).".format(KERNEL_DP, STREAM_MIN_DP,
                                      STREAM_MAX_DP, d))
    return KERNEL_DP, plan, *fns


class PlaneChainPropagate(torch.autograd.Function):
    """P(A) = exp(A_{B-1}) ··· exp(A_1) exp(A_0) for complex generator
    planes ``a`` (B, d, d), with the exact gradient to the planes
    (``chain_pallas.py`` plane_chain_propagate). Compose it with ordinary
    autograd through any differentiable plane build: Magnus M4/M6 terms,
    any Hamiltonian callable, weights x basis. With a member axis, planes
    (M, B, d, d) (``qoc_tpu``'s ``_plane_fwd`` with 4-D planes, and its
    streamed chain with weights (M, B, n_b)), the M chains' totals (M, d, d)
    and prefixes (M, B, d, d), all in one forward and one adjoint launch:
    each chain is split into S_m segments (the plan counts the chains), the
    M·S_m rows go to the kernel as one flat row axis, and one batch-max
    norm over all chains picks the ladder level of every row, as
    :class:`ChainExpmPropagate` does.

    ``PlaneChainPropagate.apply(a, plain=False, return_prefixes=False)``: on
    CUDA ``a`` must be complex64 (any complex dtype with ``plain``), and the
    op runs K5 at d <= :data:`KERNEL_DP` (padded to it) and K6 at
    256 < padded d <= 512 (padded to a multiple of 64), and raises between;
    on the CPU it runs the plain versions in ``a``'s dtype at any d, on the
    segment plan of the kernel the card would run. ``plain=True`` runs the
    plain versions on any device: the reference the kernels are compared
    with. Propagation never sets it. ``return_prefixes=True`` returns
    ``(total, prefixes)`` as :class:`ChainExpmPropagate` does
    (:func:`plane_chain_propagate_prefixes`). The precision mode as
    :class:`ChainExpmPropagate`."""

    @staticmethod
    def forward(ctx, a, plain=False, return_prefixes=False):
        a4 = a if a.dim() == 4 else a[None]
        n_chains, n_steps, d = a4.shape[0], a4.shape[1], a4.shape[-1]
        if (a.device.type == "cuda" and not plain
                and a.dtype != torch.complex64):
            raise TypeError("the plane kernels take complex64 planes; got "
                            + str(a.dtype))
        mode = config.mxu_mode(a.dtype)
        dp, plan, fwd, bwd = _plane_route(d, a.device, plain)
        s_count, length = plan(n_steps, n_chains)
        n1, ninf = _plane_norm_max(a4)
        # Zero planes pad d and the steps: exp(0) = I exactly. Segment s of
        # chain m is row m S + s of the kernels: a reshape, no transpose.
        a_seg = a.new_zeros((n_chains, s_count * length, dp, dp))
        a_seg[:, :n_steps, :d, :d] = a4
        a_seg = a_seg.reshape(n_chains * s_count, length, dp, dp)
        prefpad = fwd(a_seg, n1, mode).reshape(n_chains, s_count, length + 1,
                                               dp, dp)
        outputs, cums, prods = _chain_outputs(prefpad, d, n_steps,
                                              return_prefixes)
        if a.dim() == 3:
            outputs = (tuple(x[0] for x in outputs) if return_prefixes
                       else outputs[0])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a_seg, prefpad, cums, prods, ninf)
        ctx.bwd, ctx.n_steps, ctx.batched = bwd, n_steps, a.dim() == 4
        ctx.mode = mode
        return outputs

    @staticmethod
    def backward(ctx, *grads):
        a_seg, prefpad, cums, prods, ninf = ctx.saved_tensors
        n_chains, s_count, length, dp = prefpad.shape[:3] + prefpad.shape[-1:]
        length, d = length - 1, prods.shape[-1]
        if not ctx.batched:
            grads = [None if g is None else g[None] for g in grads]
        seeds = _segment_seeds(prefpad, cums, prods, dp, *grads)
        if seeds is None:
            return None, None, None
        rows = n_chains * s_count
        grad_a = ctx.bwd(a_seg, ninf,
                         prefpad.reshape(rows, length + 1, dp, dp),
                         seeds.reshape(rows, *seeds.shape[2:]), ctx.mode)
        grad_a = grad_a.reshape(n_chains, s_count * length, dp, dp)[
            :, :ctx.n_steps, :d, :d]
        return (grad_a if ctx.batched else grad_a[0]), None, None


# The functional forms, under qoc_tpu's names: plane_chain_propagate(a,
# plain) and plane_chain_propagate_prefixes(a, plain) -> (total, prefixes).
plane_chain_propagate = PlaneChainPropagate.apply


def plane_chain_propagate_prefixes(a, plain=False):
    """(total, prefixes) of the plane chain (``chain_pallas.py``
    plane_chain_propagate_prefixes): the trajectory form of
    :class:`PlaneChainPropagate`, its backward K5 or K6 in the per-step-seed
    mode."""
    return PlaneChainPropagate.apply(a, plain, True)
