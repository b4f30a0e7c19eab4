"""Batched complex linear-algebra primitives.

Counterpart of ``qoc_tpu/ops/linalg.py`` (reference
qoc/standard/functions/convenience.py): the ones the Schrödinger path and
the adaptive integrator use, and the public helpers of ``qoc_tpu.ops``
(``krons``, ``matmuls``, the column-vector isomorphism), on tensors.
Float32 products run in full f32 (TF32 is off, see ``config``).
"""

import functools
import math

import torch

__all__ = ["column_vector_list_to_matrix", "commutator",
           "conjugate_transpose", "krons", "matmuls",
           "matrix_to_column_vector_list", "mul", "one_norm", "rms_norm"]


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


def krons(*matrices):
    """Kronecker product of all arguments, left to right.

    Parity: reference convenience.py:49-60.
    """
    return functools.reduce(torch.kron, matrices)


def matmuls(*matrices):
    """Matrix product of all arguments, left to right.

    Parity: reference convenience.py:63-74.
    """
    return functools.reduce(mul, matrices)


def column_vector_list_to_matrix(column_vector_list):
    """Stack of (d, 1) column vectors (K, d, 1) -> (d, K) matrix: the
    unitary <-> state-batch isomorphism that poses gate synthesis as
    multi-state transfer. Parity: reference convenience.py:98-100."""
    return torch.hstack(tuple(column_vector_list))


def matrix_to_column_vector_list(matrix):
    """(d, K) matrix -> stack of column vectors (K, d, 1).

    Parity: reference convenience.py:103-104.
    """
    return torch.stack([matrix[:, i:i + 1] for i in range(matrix.shape[1])])
