"""Lindblad master-equation right-hand side and its superoperator.

Counterpart of ``qoc_tpu/ops/lindblad.py`` (reference
qoc/core/mathmethods.py:169-206):

    L(rho) = -i [H, rho] + sum_i g_i (L_i rho L_i^H - 1/2 {L_i^H L_i, rho}).

The channel loop is contracted with batched products; :func:`dissipation`
builds the dissipator's constant parts once, for the adaptive
integrator's many evaluations. The superoperator S
with S vec(rho) = vec(L(rho)) uses the row-major (C-order) vec of
``qoc_tpu``, for which vec(A X B) = (A kron B^T) vec(X); it lets the
Lindblad path propagate vectorized densities through the Schrödinger path's
Magnus + expm machinery and kernels. Arguments are tensors; every function
batches over leading axes.
"""

import torch

from qoc_tpu_torch.ops.linalg import commutator, conjugate_transpose, mul

__all__ = ["apply_lindbladian", "dissipation", "get_lindbladian", "kron",
           "lindblad_superoperator"]


def dissipation(dissipators=None, operators=None):
    """The constant parts of the dissipator, built once for many
    Lindbladians: (g_i L_i (n_ops, d, d), L_i^H, -P/2 (d, d)) for P = Σ_i
    g_i L_i^H L_i, or None without dissipation. ``dissipators`` (n_ops,)
    and ``operators`` (n_ops, d, d) are tensors (or None)."""
    if dissipators is None or operators is None:
        return None
    operators_dagger = conjugate_transpose(operators).resolve_conj()
    rates = dissipators.to(operators.dtype)
    products = torch.einsum("n,nij,njk->ik", rates, operators_dagger,
                            operators)
    return (rates[..., None, None] * operators, operators_dagger,
            -0.5 * products)


def apply_lindbladian(densities, hamiltonian=None, terms=None):
    """The Lindbladian applied to ``densities`` (..., d, d), with
    ``hamiltonian`` (d, d, or broadcasting against the densities) or None,
    and the dissipator's ``terms`` from :func:`dissipation` (or None).

    With dissipation it is evaluated as A rho + rho B + Σ_i g_i L_i rho
    L_i^H with A = -P/2 - iH and B = -P/2 + iH, which equals
    -i[H, rho] - {P, rho}/2 for any H: four products and the jumps'."""
    if terms is None:
        if hamiltonian is None:
            return torch.zeros_like(densities)
        return -1j * commutator(hamiltonian, densities)
    weighted, operators_dagger, half = terms
    left = right = half
    if hamiltonian is not None:
        ih = 1j * hamiltonian
        left, right = half - ih, half + ih
    if weighted.shape[-3] == 1:
        # One channel: no sum over the channel axis.
        jump = mul(mul(weighted[..., 0, :, :], densities),
                   operators_dagger[..., 0, :, :])
    else:
        # sum_i g_i L_i rho L_i^H, the channels on an axis before the
        # density's two.
        jump = mul(mul(weighted, densities.unsqueeze(-3)),
                   operators_dagger).sum(dim=-3)
    return mul(left, densities) + mul(densities, right) + jump


def get_lindbladian(densities, dissipators=None, hamiltonian=None,
                    operators=None):
    """The Lindbladian applied to density matrices.

    Arguments:
    densities :: tensor (..., d, d) - density matrices (any leading batch).
    dissipators :: tensor (n_ops,) - dissipation rates g_i, or None.
    hamiltonian :: tensor (d, d) - Hamiltonian, or None.
    operators :: tensor (n_ops, d, d) - collapse operators L_i, or None.

    Parity: reference mathmethods.py:169-206 (the channel loop as batched
    products over the operator axis), ``qoc_tpu`` get_lindbladian.
    """
    return apply_lindbladian(densities, hamiltonian,
                             dissipation(dissipators, operators))


def kron(a, b):
    """Kronecker product of the trailing two axes, batched over (and
    broadcasting) the leading ones."""
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (a.shape[-2] * b.shape[-2],
                                         a.shape[-1] * b.shape[-1]))


def lindblad_superoperator(dissipators=None, hamiltonian=None,
                           operators=None, hilbert_size=None):
    """The superoperator S (..., d^2, d^2) with S vec(rho) = vec(L(rho)),
    row-major vec (``qoc_tpu`` lindblad_superoperator).

    ``hamiltonian`` (..., d, d), ``dissipators`` (..., n_ops) and
    ``operators`` (..., n_ops, d, d) are tensors (or None) whose leading
    axes broadcast: a stack of Hamiltonians at the Magnus nodes gives a
    stack of superoperators."""
    like = hamiltonian if hamiltonian is not None else operators
    if hilbert_size is None:
        if like is None:
            raise ValueError("Cannot infer hilbert_size.")
        hilbert_size = like.shape[-1]
    d = hilbert_size
    dtype = like.dtype if like is not None else torch.complex64
    device = like.device if like is not None else None
    eye = torch.eye(d, dtype=dtype, device=device)
    s = torch.zeros((d * d, d * d), dtype=dtype, device=device)
    if hamiltonian is not None:
        # -i (H rho - rho H): row-major vec(H rho I) = H kron I, etc.
        s = s + (-1j) * (kron(hamiltonian, eye)
                         - kron(eye, hamiltonian.mT))
    if dissipators is not None and operators is not None:
        p = mul(conjugate_transpose(operators), operators)
        terms = (kron(operators, operators.conj()) - 0.5 * kron(p, eye)
                 - 0.5 * kron(eye, p.mT))
        rates = dissipators.to(terms.dtype)[..., None, None]
        s = s + torch.sum(rates * terms, dim=-3)
    return s
