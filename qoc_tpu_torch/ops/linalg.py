"""Batched complex linear-algebra primitives.

Counterpart of ``qoc_tpu/ops/linalg.py`` (reference
qoc/standard/functions/convenience.py), the ones the Schrödinger path and
the adaptive integrator use. Float32 products run in full f32 (TF32 is off,
see ``config``).
"""

import math

import torch

__all__ = ["commutator", "conjugate_transpose", "mul", "one_norm",
           "rms_norm"]


def mul(a, b):
    """Matrix product on the trailing two axes."""
    return torch.matmul(a, b)


def commutator(a, b):
    """[a, b] = ab - ba (batched over leading axes).

    Parity: reference convenience.py:16-29.
    """
    return mul(a, b) - mul(b, a)


def conjugate_transpose(matrix):
    """Conjugate transpose on the trailing two axes (batched).

    Parity: reference convenience.py:32-46.
    """
    return matrix.mH


def one_norm(matrix):
    """Induced matrix 1-norm (max column sum of moduli), batched."""
    return torch.abs(matrix).sum(dim=-2).amax(dim=-1)


def rms_norm(array, batch_dims=0):
    """Root-mean-square of the modulus of the entries: of all of them, or
    with ``batch_dims`` = n one value for each index of the n leading axes,
    over the trailing ones (the adaptive integrator's per-lane error norm).

    Parity: reference convenience.py:77-91, ``qoc_tpu`` linalg.py:63-77.
    The sqrt is guarded with the double-where pattern, so the gradient at an
    all-zero input is 0 rather than NaN (sqrt'(0) = inf would otherwise
    poison gradients even on branches whose cotangent is zero).
    """
    dims = tuple(range(batch_dims, array.dim()))
    square_norm = torch.sum(torch.real(array * torch.conj(array)), dim=dims)
    mean_square = square_norm / math.prod(array.shape[batch_dims:])
    positive = mean_square > 0
    safe = torch.where(positive, mean_square, torch.ones_like(mean_square))
    return torch.where(positive, torch.sqrt(safe),
                       torch.zeros_like(mean_square))
