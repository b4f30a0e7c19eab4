"""Device and dtype policy of qoc_tpu_torch.

Counterpart of ``qoc_tpu/config.py``, keeping the dtype policy and
:func:`is_io_process`. Every entry point takes ``device`` and ``dtype``
(the real working dtype; the complex one follows from it):

- ``device=None`` is the current CUDA device; without one the call raises
  ``RuntimeError`` rather than run on the CPU. The CPU runs only when asked
  for (``device="cpu"``).
- CUDA: float32 / complex64, the only type the chain kernels compute in;
  the Lindblad entry points under RKDP5, which run no kernel, also take
  float64 there.
- CPU: float64 / complex128 by default, for parity with ``qoc_tpu`` and
  the reference, which are float64 throughout.

One process-wide switch chooses the kernels' product precision, as
``qoc_tpu``'s (``qoc_tpu/ops/expm_pallas.py`` ``_MXU_MODE``):
:data:`MXU_MODE`, read at import from ``QOC_TPU_MXU_PRECISION``:

- ``"highest"`` (the default): every product exact float32;
- ``"bf16_3x"``: the opt-in reduced precision. Every product of the
  propagation (the Taylor ladder, U P, the adjoint's T update and gU) is
  the 3-pass split x_hi y_hi + x_hi y_lo + x_lo y_hi, on TF32 operands on
  the card's tensor cores (about 2^-21 a product), and degree 12 takes the
  4-product scheme ``_D12A``. The generator build, the norms, the segment
  merge, the seeds and the weight projection stay exact.

The ops read :data:`MXU_MODE` when they are called (tests and scripts may
set it between calls), and a backward runs in its forward's mode. It
touches float32 and complex64 work only: float64 ignores it
(:func:`mxu_mode`). Every kernel (K1-K6) and ``expm_taylor`` has its mode
form; a route in the mode never runs exact float32 in its place. TF32
stays off for every float32 product the glue issues: one TF32 pass keeps
only ~3 decimal digits.
"""

import os

import torch

__all__ = ["MXU_MODE", "MXU_MODES", "complex_dtype", "is_io_process",
           "mxu_mode", "resolve"]

MXU_MODES = ("highest", "bf16_3x")
MXU_MODE = os.environ.get("QOC_TPU_MXU_PRECISION", "highest").lower()
if MXU_MODE not in MXU_MODES:
    raise ValueError(
        "QOC_TPU_MXU_PRECISION must be 'highest' or 'bf16_3x', got "
        "{!r}".format(MXU_MODE))

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device=None, dtype=None, float64_ok=False):
    """(torch.device, real dtype) for an entry point's arguments.

    ``device=None`` is the current CUDA device, and raises
    ``RuntimeError`` where there is none. ``dtype=None`` is float64 on the
    CPU and float32 on CUDA; CUDA takes only float32 (the kernels' type),
    and float64 too with ``float64_ok``, for a path that runs no kernel
    (the Lindblad entry points under RKDP5, ``qoc_tpu``'s x64 mode)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "qoc_tpu_torch runs on a CUDA device by default and found "
                "none; pass device=\"cpu\" to run on the CPU.")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("dtype must be torch.float32 or torch.float64, got "
                        + str(dtype))
    if device.type == "cuda" and dtype != torch.float32 and not float64_ok:
        raise TypeError("on CUDA the port computes in float32 (the chain "
                        "kernels' type), got " + str(dtype))
    return device, dtype


def complex_dtype(dtype):
    """The complex dtype paired with a real working dtype."""
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def mxu_mode(dtype, mode=None):
    """The precision mode that work in ``dtype`` runs: ``mode`` (by default
    :data:`MXU_MODE` as it stands now) for float32 and complex64, always
    ``"highest"`` for float64 and complex128."""
    if mode is None:
        mode = MXU_MODE
    if mode not in MXU_MODES:
        raise ValueError("the precision mode must be 'highest' or "
                         "'bf16_3x', got {!r}".format(mode))
    if dtype in (torch.float64, torch.complex128):
        return "highest"
    return mode


def is_io_process():
    """True on the process that owns stdout logging and save-file writes
    (``qoc_tpu/config.py`` is_io_process): every process unless
    ``torch.distributed`` is initialized with a rank other than 0. Reads
    (``resume_from``) are not gated."""
    distributed = torch.distributed
    return not (distributed.is_available() and distributed.is_initialized()
                and distributed.get_rank() != 0)
