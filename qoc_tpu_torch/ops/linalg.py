"""Batched complex linear-algebra primitives.

Counterpart of ``qoc_tpu/ops/linalg.py`` (reference
qoc/standard/functions/convenience.py), the ones the Schrödinger path uses.
Float32 products run in full f32 (TF32 is off, see ``config``).
"""

import torch

__all__ = ["commutator", "conjugate_transpose", "mul", "one_norm"]


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
