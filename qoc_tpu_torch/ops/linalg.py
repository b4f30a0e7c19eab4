"""Batched complex linear-algebra primitives.

Counterpart of ``qoc_tpu/ops/linalg.py`` (reference
qoc/standard/functions/convenience.py), the two the Schrödinger path uses.
Float32 products run in full f32 (TF32 is off, see ``config``).
"""

import torch

__all__ = ["conjugate_transpose", "mul"]


def mul(a, b):
    """Matrix product on the trailing two axes."""
    return torch.matmul(a, b)


def conjugate_transpose(matrix):
    """Conjugate transpose on the trailing two axes (batched).

    Parity: reference convenience.py:32-46.
    """
    return matrix.mH
