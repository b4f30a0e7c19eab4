"""The port's plain chain op against qoc_tpu's chain reference (float64,
CPU).

The oracle is ``chain_expm_propagate_reference`` (its XLA expm) with
``jax.grad``; no interpret-mode Pallas. Tolerances: relative 1e-6 forward,
1e-5 gradient — the port evaluates the f32-calibrated Taylor ladder
(truncation below ~1e-8 a step) where JAX x64 uses an f64-accurate expm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import anti_hermitian_basis, f32_exact

torch.set_num_threads(1)

# Batch-max 1-norm targets that land on each ladder level: degree 4, 8,
# 12, 19 and per-matrix scaling and squaring.
LEVEL_NORMS = ((0, 0.03), (1, 0.3), (2, 1.0), (3, 2.5), (4, 7.0))


@pytest.fixture(scope="module")
def jax_reference():
    from qoc_tpu.ops.chain_pallas import chain_expm_propagate_reference

    def loss(w, basis, tgt):
        total = chain_expm_propagate_reference(w, basis)
        return jnp.sum(jnp.abs(total - tgt) ** 2), total

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("d", (4, 8))
@pytest.mark.parametrize("b", (8, 16, 37))
def test_plain_chain_matches_jax_reference(jax_reference, d, b):
    from qoc_tpu_torch.ops.chain import (ChainExpmPropagate, _norm_max,
                                         ladder_level)
    rng = np.random.default_rng(100 * d + b)
    n_b = 3
    base = anti_hermitian_basis(rng, n_b, d)
    w = f32_exact(rng.normal(size=(b, n_b)))
    tgt = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    norm1 = np.abs(np.einsum("jk,kab->jab", w, base)).sum(-2).max()
    for level, target_norm in LEVEL_NORMS:
        basis = base * (target_norm / norm1)
        (_, want), g_want = jax_reference(jnp.asarray(w), jnp.asarray(basis),
                                          jnp.asarray(tgt))
        want, g_want = np.asarray(want), np.asarray(g_want)

        op = ChainExpmPropagate(basis, "cpu", torch.float64)
        wt = torch.tensor(w, requires_grad=True)
        assert ladder_level(_norm_max(wt.detach(), op.basis_ri, d)[0]) \
            == level
        total = op(wt)
        loss = torch.sum(torch.abs(total - torch.as_tensor(tgt)) ** 2)
        g_got, = torch.autograd.grad(loss, wt)
        got = total.detach().numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6, level
        assert (np.abs(g_got.numpy() - g_want).max()
                / np.abs(g_want).max()) < 1e-5, level


def test_plain_chain_gradcheck():
    """Exact gradient of the plain op (finite differences, float64), on
    every ladder level."""
    from qoc_tpu_torch.ops.chain import ChainExpmPropagate
    rng = np.random.default_rng(3)
    d, b, n_b = 3, 5, 2
    base = anti_hermitian_basis(rng, n_b, d)
    w = rng.normal(size=(b, n_b))
    norm1 = np.abs(np.einsum("jk,kab->jab", w, base)).sum(-2).max()
    for _, target_norm in LEVEL_NORMS:
        op = ChainExpmPropagate(base * (target_norm / norm1), "cpu",
                                torch.float64)
        assert torch.autograd.gradcheck(
            op, (torch.tensor(w, requires_grad=True),))


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors K1/K2's wrappers are their plain versions: the same
    results, and no launch counted."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(5)
    d, n_b = 4, 3
    basis = torch.as_tensor(anti_hermitian_basis(rng, n_b, d) * 0.2)
    w = torch.as_tensor(rng.normal(size=(3, 9, n_b)))
    norm = torch.tensor(0.7, dtype=torch.float64)
    launches = (chain.chain_fwd.launches, chain.chain_bwd.launches)
    pref = chain.chain_fwd(w, basis, norm)
    assert torch.equal(pref, chain.chain_fwd_plain(w, basis, norm))
    seeds = torch.as_tensor(rng.normal(size=(3, d, d))
                            + 1j * rng.normal(size=(3, d, d)))
    basis_h = basis.mH.contiguous()
    assert torch.equal(chain.chain_bwd(w, basis_h, norm, pref, seeds),
                       chain.chain_bwd_plain(w, basis_h, norm, pref, seeds))
    assert (chain.chain_fwd.launches, chain.chain_bwd.launches) == launches
    assert torch.equal(pref[:, 0], torch.eye(d, dtype=pref.dtype).expand(
        3, d, d))


@pytest.mark.parametrize("n_steps,plan", ((1, (1, 8)), (25, (4, 8)),
                                          (10_000, (127, 79))))
def test_segment_plan(n_steps, plan):
    """Segments of >= 8 steps, at most 128, covering every step; the
    Table-3 headline's 10^4 steps run as 127 chains of 79."""
    from qoc_tpu_torch.ops.chain import segment_plan
    s_count, length = segment_plan(n_steps)
    assert (s_count, length) == plan
    assert s_count * length >= n_steps > (s_count - 1) * length


def test_cuda_op_refuses_what_the_kernels_cannot_take():
    from qoc_tpu_torch.ops.chain import ChainExpmPropagate
    basis = np.zeros((2, 65, 65), dtype=complex)
    with pytest.raises(ValueError, match="d <= 64"):
        ChainExpmPropagate(basis, "cuda", torch.float32)
    with pytest.raises(TypeError, match="float32"):
        ChainExpmPropagate(basis[:, :4, :4], "cuda", torch.float64)
