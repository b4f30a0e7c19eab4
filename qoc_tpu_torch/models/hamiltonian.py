"""Structured Hamiltonians.

Counterpart of ``qoc_tpu/models/hamiltonian.py``. ``LinearHamiltonian``
declares the linear control structure

    H(c, t) = H0 + Σᵢ cᵢ Aᵢ + conj(cᵢ) Aᵢ^H

as data. It stays callable with the reference contract, and it is what the
fused chain routes of the Schrödinger and Lindblad entry points propagate
through the CUDA chain kernels. ``ConstantLindblad`` declares
time-independent dissipation, which with a ``LinearHamiltonian`` keeps the
Lindblad superoperator affine in the controls. ``EnsembleLinearHamiltonian``
adds real member parameters δ_m with Hermitian operators, the structure
that takes an ensemble or a robust multistart through the fused chain
(``parallel/``).
"""

import numpy as np
import torch

__all__ = ["ConstantLindblad", "EnsembleLinearHamiltonian",
           "LinearHamiltonian"]


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

    def superoperator_basis(self, dt, dissipators=None, operators=None):
        """Magnus-M2 Lindblad-superoperator generator basis (numpy complex
        (1+2n, d², d²)): S_step = Σ_k W_k basis_k with the weight layout of
        :meth:`generator_basis`, where S vec(ρ) = vec(L(ρ)) in row-major
        vec (``ops/lindblad.py`` lindblad_superoperator). The constant
        dissipator part folds into the k = 0 term (``qoc_tpu``
        hamiltonian.py:82-111)."""
        d = self.h0.shape[-1]
        eye = np.eye(d)

        def s_h(x):
            # -i (X rho - rho X) -> -i (X kron I - I kron X^T), row-major.
            return -1j * (np.kron(x, eye) - np.kron(eye, x.T))

        s0 = s_h(self.h0).astype(complex)
        if dissipators is not None and operators is not None:
            for g, l_op in zip(np.asarray(dissipators),
                               np.asarray(operators)):
                p = np.conjugate(l_op.T) @ l_op
                s0 = s0 + g * (np.kron(l_op, np.conjugate(l_op))
                               - 0.5 * np.kron(p, eye)
                               - 0.5 * np.kron(eye, p.T))
        parts = [s0]
        for a in self.operators:
            ah = np.conjugate(a.T)
            parts.append(s_h(a + ah))
            parts.append(s_h(1j * (a - ah)))
        return dt * np.stack(parts)


class EnsembleLinearHamiltonian(LinearHamiltonian):
    """Affine ensemble of linear Hamiltonians (robust GRAPE):

        H_m(c, t) = h0 + Σ_p δ_mp · param_operators[p]
                       + Σᵢ cᵢ operatorsᵢ + conj(cᵢ) operatorsᵢ^H

    where δ_m is member m's real parameter row (detuning, amplitude
    miscalibration, ...). ``param_operators`` (param_count, d, d) must be
    Hermitian (they enter with real coefficients); the common case
    "(1 + δ)·H0" is ``param_operators=[h0]``.

    The member parameters become weight columns of one shared generator
    basis, so every member of an ensemble (and every candidate of a
    multistart) runs through the fused chain kernels in one launch. The
    instance is also callable with the ensemble contract ``(params_row,
    controls, time)`` on torch tensors, which the blocked route evaluates
    (``qoc_tpu/models/hamiltonian.py:114-190``)."""

    def __init__(self, h0, operators, param_operators):
        super().__init__(h0, operators)
        self.param_operators = np.asarray(param_operators)
        if self.param_operators.ndim != 3:
            raise ValueError("param_operators must have shape "
                             "(param_count, d, d); got {}."
                             .format(self.param_operators.shape))
        if self.param_operators.shape[1:] != self.h0.shape:
            raise ValueError("param_operators {} and h0 {} dimension "
                             "mismatch.".format(self.param_operators.shape,
                                                self.h0.shape))
        herm_err = np.abs(self.param_operators
                          - np.conjugate(np.swapaxes(self.param_operators,
                                                     -1, -2))).max()
        if herm_err > 1e-8:
            raise ValueError("param_operators must be Hermitian (they carry "
                             "real ensemble coefficients); max |P - P^H| = "
                             "{}.".format(herm_err))
        self._param_tensors = {}

    @property
    def param_count(self):
        return self.param_operators.shape[0]

    def __call__(self, params_row, controls, time):
        """H_m at ``time`` for member row ``params_row`` (a real or complex
        tensor (param_count,)) and complex ``controls`` (a tensor
        (..., control_count)), in the controls' dtype and device."""
        h = LinearHamiltonian.__call__(self, controls, time)
        key = (h.dtype, h.device)
        if key not in self._param_tensors:
            self._param_tensors[key] = torch.as_tensor(
                self.param_operators, dtype=h.dtype, device=h.device)
        return h + torch.einsum("p,pab->ab", params_row.to(h.dtype),
                                self._param_tensors[key])

    def member(self, params_row):
        """The plain ``(controls, time) -> H`` callable of one member."""
        return lambda controls, time: self(params_row, controls, time)

    def hermitian_basis(self):
        """[h0, param_ops..., P_1, Q_1, ...] so that H_m = W_m · basis with
        W_m = [1, δ_m1..δ_mP, Re c_1, Im c_1, ...]."""
        base = LinearHamiltonian.hermitian_basis(self)
        return np.concatenate((base[:1], self.param_operators, base[1:]),
                              axis=0)

    def superoperator_basis(self, dt, dissipators=None, operators=None):
        """Lindblad-superoperator basis with the member layout
        [s0 (+ dissipators), s(param_ops)..., s(P_i), s(Q_i)...], matching
        the weight rows [1, δ_m, Re c, Im c]: each Hermitian param operator
        contributes its own -i[·, ρ] column, and the dissipators stay in the
        constant k = 0 term that every member shares."""
        base = LinearHamiltonian.superoperator_basis(self, dt, dissipators,
                                                     operators)
        d = self.h0.shape[-1]
        eye = np.eye(d)
        param_cols = np.stack([
            -1j * dt * (np.kron(p, eye) - np.kron(eye, p.T))
            for p in self.param_operators])
        return np.concatenate((base[:1], param_cols.astype(base.dtype),
                               base[1:]), axis=0)


class ConstantLindblad:
    """Time-independent Lindblad data: callable with the reference contract
    ``(time) -> (dissipation_rates, operators)`` (reference
    lindbladdiscrete.py:76-79), declaring constancy as structure: with a
    ``LinearHamiltonian`` under ``LindbladMethod.MAGNUS_EXPM`` it takes the
    fused chain routes.

    Arguments:
    dissipators :: numpy (n_ops,) - rates g_i.
    operators :: numpy (n_ops, d, d) - collapse operators L_i.
    """

    def __init__(self, dissipators, operators):
        self.dissipators = (None if dissipators is None
                            else np.asarray(dissipators))
        self.operators = (None if operators is None
                          else np.asarray(operators))

    def __call__(self, time):
        return self.dissipators, self.operators
