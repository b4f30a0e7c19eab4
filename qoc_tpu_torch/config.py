"""Device and dtype policy of qoc_tpu_torch.

Counterpart of ``qoc_tpu/config.py``, keeping only the dtype policy. Every
entry point takes ``device`` and ``dtype`` (the real working dtype; the
complex one follows from it):

- ``device=None`` is the current CUDA device; without one the call raises
  ``RuntimeError`` rather than run on the CPU. The CPU runs only when asked
  for (``device="cpu"``).
- CUDA: float32 / complex64, the only type the chain kernels compute in.
- CPU: float64 / complex128 by default, for parity with ``qoc_tpu`` and
  the reference, which are float64 throughout.

There is no process-wide precision switch: the dtype travels with the call.
TF32 tensor-core matmuls would keep only ~3 decimal digits, so they are off
for every float32 product the glue issues.
"""

import torch

__all__ = ["complex_dtype", "resolve"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device=None, dtype=None):
    """(torch.device, real dtype) for an entry point's arguments.

    ``device=None`` is the current CUDA device, and raises
    ``RuntimeError`` where there is none. ``dtype=None`` is float64 on the
    CPU and float32 on CUDA; CUDA takes only float32 (the kernels' type)."""
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
    if device.type == "cuda" and dtype != torch.float32:
        raise TypeError("on CUDA the port computes in float32 (the chain "
                        "kernels' type), got " + str(dtype))
    return device, dtype


def complex_dtype(dtype):
    """The complex dtype paired with a real working dtype."""
    return torch.complex64 if dtype == torch.float32 else torch.complex128
