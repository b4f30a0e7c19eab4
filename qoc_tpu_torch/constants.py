"""Operator constants and generators.

Counterpart of ``qoc_tpu/constants.py`` (reference
qoc/standard/constants.py:9-65): plain numpy, converted to tensors by the
code that uses them.
"""

import numpy as np

__all__ = [
    "SIGMA_X",
    "SIGMA_Y",
    "SIGMA_Z",
    "SIGMA_PLUS",
    "SIGMA_MINUS",
    "get_creation_operator",
    "get_annihilation_operator",
    "get_eij",
]

SIGMA_X = np.array(((0, 1), (1, 0)))
SIGMA_Y = np.array(((0, -1j), (1j, 0)))
SIGMA_Z = np.array(((1, 0), (0, -1)))
SIGMA_PLUS = np.array(((0, 1), (0, 0)))   # (SIGMA_X + i SIGMA_Y) / 2
SIGMA_MINUS = np.array(((0, 0), (1, 0)))  # (SIGMA_X - i SIGMA_Y) / 2


def get_creation_operator(size):
    """Creation operator truncated at ``size`` levels: sqrt weights on the
    first subdiagonal."""
    return np.diag(np.sqrt(np.arange(1, size)), k=-1)


def get_annihilation_operator(size):
    """Annihilation operator truncated at ``size`` levels: sqrt weights on
    the first superdiagonal."""
    return np.diag(np.sqrt(np.arange(1, size)), k=1)


def get_eij(i, j, size):
    """Matrix unit E_ij of the given size."""
    eij = np.zeros((size, size))
    eij[i, j] = 1
    return eij
