"""Structured Hamiltonians.

Counterpart of ``qoc_tpu/models/hamiltonian.py`` (``LinearHamiltonian``
only; the ensemble Hamiltonian and ``ConstantLindblad`` are later slices of
the port). ``LinearHamiltonian`` declares the linear control structure

    H(c, t) = H0 + Σᵢ cᵢ Aᵢ + conj(cᵢ) Aᵢ^H

as data. It stays callable with the reference contract, and it is what the
fused chain route of ``grape_schroedinger_discrete`` /
``evolve_schroedinger_discrete`` propagates through the CUDA chain kernels.
"""

import numpy as np
import torch

__all__ = ["LinearHamiltonian"]


class LinearHamiltonian:
    """H(c, t) = h0 + Σᵢ cᵢ operatorsᵢ + conj(cᵢ) operatorsᵢ^H.

    Arguments:
    h0 :: numpy (d, d) - the static (drift) Hamiltonian; must be Hermitian
        for the evolution to be unitary (not enforced).
    operators :: numpy (control_count, d, d) - one drive operator per
        control channel. A Hermitian drive with a real control is the
        special case operators[i] = H_i / 2 (since H/2 + H^H/2 = H).

    The instance is callable with the reference contract
    ``(controls, time) -> (d, d)`` and is time-independent by construction.
    """

    def __init__(self, h0, operators):
        self.h0 = np.asarray(h0)
        self.operators = np.asarray(operators)
        if self.operators.ndim != 3:
            raise ValueError("operators must have shape "
                             "(control_count, d, d); got {}."
                             .format(self.operators.shape))
        if self.h0.shape != self.operators.shape[1:]:
            raise ValueError("h0 {} and operators {} dimension mismatch."
                             .format(self.h0.shape, self.operators.shape))
        # (h0, operators) as tensors by (dtype, device), made at the first
        # call there: the planes are built every iteration, and uploading
        # the d x d matrices each time is a large share of a large-d one.
        self._tensors = {}

    def _as_tensors(self, dtype, device):
        key = (dtype, device)
        if key not in self._tensors:
            self._tensors[key] = tuple(
                torch.as_tensor(x, dtype=dtype, device=device)
                for x in (self.h0, self.operators))
        return self._tensors[key]

    @property
    def control_count(self):
        return self.operators.shape[0]

    def __call__(self, controls, time):
        """H at ``time`` for complex control values ``controls`` (a tensor
        (..., control_count), or None for the drift alone). The result takes
        the controls' complex dtype and device (complex128 on the CPU when
        there are no controls)."""
        if controls is None:
            return torch.as_tensor(self.h0, dtype=torch.complex128)
        h0, ops = self._as_tensors(controls.dtype, controls.device)
        drive = torch.einsum("...i,iab->...ab", controls, ops)
        return h0 + drive + drive.mH

    def hermitian_basis(self):
        """Real-coefficient Hermitian basis [h0, P_1, Q_1, ..., P_n, Q_n]
        with P = A + A^H, Q = i(A - A^H), so that
        H = 1·h0 + Σᵢ Re(cᵢ)·Pᵢ + Im(cᵢ)·Qᵢ  (numpy (1+2n, d, d))."""
        parts = [self.h0]
        for a in self.operators:
            ah = np.conjugate(a.T)
            parts.append(a + ah)
            parts.append(1j * (a - ah))
        return np.stack(parts)

    def generator_basis(self, dt):
        """Magnus-M2 generator basis G_k = -i·dt·basis_k (numpy complex):
        A_step = Σ_k W_k G_k with W = [1, Re c_1, Im c_1, ...] evaluated at
        the step midpoint."""
        return -1j * dt * self.hermitian_basis()
