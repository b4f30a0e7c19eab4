"""Batched matrix exponential and its Fréchet derivative: the kernels K3/K4.

Counterpart of ``qoc_tpu/ops/expm_pallas.py``. Two kernels, each beside its
plain PyTorch version of the same math:

- K3, :func:`expm_fwd` (``csrc/expm_fwd.cu``): exp(A) for a batch of
  matrices. Plain version :func:`expm_fwd_plain`.
- K4, :func:`expm_frechet_fwd` (``csrc/expm_frechet.cu``): L(B, G) =
  d/dt exp(B + t G) at t = 0, by the same ladder on dual numbers. Plain
  version :func:`expm_frechet_plain`.

Both follow the chain kernels' f32 Taylor ladder (``ops/chain.py``): the
batch-max 1-norm of A (of B for K4) picks degree 4/8/12/19, and above the
last threshold every matrix is scaled to theta = 1 and takes T19 and its
squarings (the TPU kernel's general branch takes T8 where the scaled norm
is at most 0.25; both are f32-accurate there). The wrappers compute that
norm on the device and pass it by pointer, so picking the degree costs the
host no synchronisation. They zero-pad d up to the kernels' dp, a multiple
of 64 up to :data:`KERNEL_MAX_DP` (exact: exp of a block-diagonal matrix is
block-diagonal). A wrapper takes its plain version only for a tensor on the
CPU, in the caller's dtype at any d; for a CUDA tensor it launches its
kernel (complex64, padded d <= 256) or raises.

Precision mode (``config.MXU_MODE``; ops/chain.py): the wrappers take
``mode`` (None: the switch as it stands; float64 ignores it) and count
their launches in the bf16_3x mode (``mode_launches``). In the mode each
path runs its second instantiation (3 x TF32 tensor-core products,
``_D12A`` at degree 12): the resident one at padded d = 64, the tiled one
(its squarings on X - I) at padded 128-256.
"""

import ctypes
import functools

import torch

from qoc_tpu_torch.ops.chain import (_Dual, _expm_ladder, _mode_of, _stream,
                                     kernel_dp, ladder_level, load_kernels)

__all__ = ["KERNEL_MAX_DP", "expm_frechet_fwd", "expm_frechet_plain",
           "expm_fwd", "expm_fwd_plain", "kernel_dp", "launch_grid"]

# Padded dimensions the kernels take: multiples of 64 (ops/chain.py
# kernel_dp) up to 256 (qoc_tpu/ops/expm.py _pallas_size_ok).
KERNEL_MAX_DP = 256


def _norm_max(a):
    """Batch-max 1-norm of a (..., d, d), on its device."""
    return a.abs().sum(dim=-2).amax()


def expm_fwd_plain(a, mode=None):
    """Plain version of K3: exp(a) for complex a (..., d, d) by the f32
    ladder, at the level of a's batch-max 1-norm, in precision ``mode``."""
    return _expm_ladder(a, ladder_level(_norm_max(a)), _mode_of(a, mode))


def expm_frechet_plain(b, g, mode=None):
    """Plain version of K4: the Fréchet derivative L(b, g) of exp at b in
    direction g, both complex (..., d, d), by the dual-number ladder at the
    level of b's batch-max 1-norm, in precision ``mode``."""
    return _expm_ladder(_Dual(b, g), ladder_level(_norm_max(b)),
                        _mode_of(b, mode)).dv


def _padded(x, dp):
    """x (..., d, d) as a contiguous (B, dp, dp), zero-padded."""
    d = x.shape[-1]
    x = x.reshape(-1, d, d)
    if d == dp:
        return x.contiguous()
    out = x.new_zeros((x.shape[0], dp, dp))
    out[:, :d, :d] = x
    return out


def _check(name, *xs):
    """The wrapper's inputs: CUDA complex64 (..., d, d) tensors of one
    shape and device, with padded d <= KERNEL_MAX_DP."""
    x0 = xs[0]
    if x0.device.type != "cuda":
        raise ValueError("{} runs on cpu or cuda tensors, got {}".format(
            name, x0.device))
    for x in xs:
        if x.dtype != torch.complex64:
            raise TypeError("{} takes complex64 on CUDA, got {}".format(
                name, x.dtype))
        if x.dim() < 2 or x.shape[-1] != x.shape[-2]:
            raise ValueError("{} takes (..., d, d) matrices, got {}".format(
                name, tuple(x.shape)))
        if x.shape != x0.shape or x.device != x0.device:
            raise ValueError("{}: inputs differ in shape or device".format(
                name))
    dp = kernel_dp(x0.shape[-1])
    if dp > KERNEL_MAX_DP:
        raise ValueError(
            "{} takes padded d <= {} (got d = {}); larger matrices take "
            "ops/expm.py's expm_taylor".format(name, KERNEL_MAX_DP,
                                               x0.shape[-1]))
    return dp


def _check_kernel_inputs(dp, norm, *mats):
    for m in mats:
        if (m.dtype != torch.complex64 or not m.is_contiguous()
                or m.dim() != 3 or m.shape[1:] != (dp, dp)
                or m.device != norm.device):
            raise ValueError("K3/K4 inputs must be contiguous complex64 "
                             "(B, {0}, {0}) tensors on one device".format(dp))
    if norm.dtype != torch.float32 or norm.numel() != 1:
        raise ValueError("norm must be one float32 value")


@functools.cache
def _plan(dual, dp, device_index):
    """(resident blocks, workspace matrices a block, shared-memory bytes
    a block) of K3 or K4 at dp on a device."""
    lib = load_kernels()
    out = [ctypes.c_int() for _ in range(3)]
    fn = lib.qoc_expm_frechet_plan if dual else lib.qoc_expm_fwd_plan
    with torch.cuda.device(device_index):
        err = fn(dp, *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError("K{} launch plan failed: CUDA error {}".format(
            4 if dual else 3, err))
    return tuple(x.value for x in out)


def tc_layout(kernel, dp):
    """(panel rows, split stages, bytes of a raw k-slice, bytes of a split
    stage, shared-memory bytes a block, raw ring stages) of the tiled
    bf16_3x form of K3 (``kernel`` 3), K4 (4), K6's forward (6) or adjoint
    (7) at dp, as the kernels' source defines them (``csrc/expm_fwd.cu``
    qoc_tiled_tc_layout); no split stages: PR 11's mma.sync form."""
    out = (ctypes.c_int * 6)()
    if load_kernels().qoc_tiled_tc_layout(kernel, dp, out) != 0:
        raise ValueError("no tiled bf16_3x form for kernel {} at dp {}"
                         .format(kernel, dp))
    return tuple(out)


def launch_grid(dual, dp, batch, device_index):
    """(blocks, workspace matrices a block) of one K3 (K4 with ``dual``)
    launch on ``batch`` matrices: at most one block a matrix."""
    blocks, slots, _ = _plan(dual, dp, device_index)
    return min(batch, blocks), slots


def _launch(dual, dp, norm, *mats, tf32=0):
    """Launch K3 (mats = a) or K4 (mats = b, g) on padded (B, dp, dp)
    inputs, in the bf16_3x mode with ``tf32``; returns the padded
    (B, dp, dp) output."""
    _check_kernel_inputs(dp, norm, *mats)
    x = mats[0]
    batch, dev = x.shape[0], x.device
    grid, slots = launch_grid(dual, dp, batch, dev.index)
    out = torch.empty_like(x)
    ws = torch.empty((grid, slots, dp, dp), dtype=torch.complex64,
                     device=dev)
    lib = load_kernels()
    ptrs = [m.data_ptr() for m in mats]
    fn = lib.qoc_expm_frechet if dual else lib.qoc_expm_fwd
    with torch.cuda.device(dev):
        err = fn(*ptrs, norm.data_ptr(), out.data_ptr(), ws.data_ptr(),
                 batch, dp, grid, tf32, _stream(dev))
    if err != 0:
        raise RuntimeError("K{} launch failed: CUDA error {}".format(
            4 if dual else 3, err))
    return out


def expm_fwd(a, mode=None):
    """K3: exp(a) for a (..., d, d). On a CPU tensor it is the plain
    version; on a CUDA tensor (complex64, padded d <= 256) it launches
    ``csrc/expm_fwd.cu`` in ``mode`` or raises. ``expm_fwd.launches``
    counts every launch, ``expm_fwd.mode_launches`` those in the bf16_3x
    mode."""
    mode = _mode_of(a, mode)
    if a.device.type == "cpu":
        return expm_fwd_plain(a, mode)
    dp = _check("expm_fwd", a)
    d = a.shape[-1]
    x = _padded(a, dp)
    tf32 = int(mode == "bf16_3x")
    out = _launch(False, dp, _norm_max(x), x, tf32=tf32)
    expm_fwd.launches += 1
    expm_fwd.mode_launches += tf32
    return out[:, :d, :d].reshape(a.shape)


expm_fwd.launches = 0
expm_fwd.mode_launches = 0


def expm_frechet_fwd(b, g, mode=None):
    """K4: L(b, g) for b, g (..., d, d). On CPU tensors it is the plain
    version; on CUDA tensors (complex64, padded d <= 256) it launches
    ``csrc/expm_frechet.cu`` in ``mode`` or raises; counted as
    :func:`expm_fwd`."""
    mode = _mode_of(b, mode)
    if b.device.type == "cpu":
        return expm_frechet_plain(b, g, mode)
    dp = _check("expm_frechet_fwd", b, g)
    d = b.shape[-1]
    x, y = _padded(b, dp), _padded(g, dp)
    tf32 = int(mode == "bf16_3x")
    out = _launch(True, dp, _norm_max(x), x, y, tf32=tf32)
    expm_frechet_fwd.launches += 1
    expm_frechet_fwd.mode_launches += tf32
    return out[:, :d, :d].reshape(b.shape)


expm_frechet_fwd.launches = 0
expm_frechet_fwd.mode_launches = 0
