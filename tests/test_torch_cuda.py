"""K1/K2 on the card against their plain PyTorch versions (float32).

Marked ``cuda``: each test skips when no CUDA device is present, so on a
CPU-only machine they count as skipped. Run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest``
(``--noconftest`` because tests/conftest.py imports JAX, which the port
does not need); ``chip_smoke.py`` runs the same comparisons at the
headline's shapes.
"""

import numpy as np
import pytest
import torch

from torch_parity import anti_hermitian_basis

pytestmark = pytest.mark.cuda

# Relative to the plain result's largest magnitude (tests/test_chain.py).
FWD_RTOL = 1e-4
GRAD_RTOL = 1e-3


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the chain kernels run only there)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("d,n_steps", ((4, 37), (64, 203)))
@pytest.mark.parametrize("target_norm", (0.03, 0.3, 1.0, 2.5, 7.0))
def test_kernels_match_plain_versions(cuda_device, d, n_steps, target_norm):
    from qoc_tpu_torch.ops.chain import ChainExpmPropagate
    rng = np.random.default_rng(7)
    n_b = 5
    base = anti_hermitian_basis(rng, n_b, d)
    w = rng.normal(size=(n_steps, n_b)).astype(np.float32)
    norm1 = np.abs(np.einsum("jk,kab->jab", w, base)).sum(-2).max()
    basis = base * (target_norm / norm1)
    tgt = torch.as_tensor(rng.normal(size=(d, d)).astype(np.complex64),
                          device=cuda_device)
    outs = []
    for plain in (False, True):
        op = ChainExpmPropagate(basis, cuda_device, torch.float32,
                                plain=plain)
        wt = torch.as_tensor(w, device=cuda_device).requires_grad_(True)
        total = op(wt)
        grad, = torch.autograd.grad(
            torch.sum(torch.abs(total - tgt) ** 2), wt)
        outs.append((total.detach(), grad))
    torch.cuda.synchronize()
    (total_k, grad_k), (total_p, grad_p) = outs
    assert float((total_k - total_p).abs().max()
                 / total_p.abs().max()) < FWD_RTOL
    assert float((grad_k - grad_p).abs().max()
                 / grad_p.abs().max()) < GRAD_RTOL


def test_grape_launches_both_kernels(cuda_device):
    import qoc_tpu_torch
    from qoc_tpu_torch.ops import chain
    d, n_c, n = 8, 2, 64
    rng = np.random.default_rng(0)
    h0 = rng.normal(size=(d, d))
    ham = qoc_tpu_torch.LinearHamiltonian(h0 + h0.T,
                                          0.3 * np.ones((n_c, d, d)))
    initial = np.zeros((1, d, 1))
    initial[0, 0] = 1
    target = np.zeros((1, d, 1))
    target[0, -1] = 1
    before = (chain.chain_fwd.launches, chain.chain_bwd.launches)
    result = qoc_tpu_torch.grape_schroedinger_discrete(
        n_c, n, [qoc_tpu_torch.TargetStateInfidelity(target)], 1.0, ham,
        initial, n, iteration_count=4, log_iteration_step=0,
        device=cuda_device)
    assert chain.chain_fwd.launches - before[0] == 4
    assert chain.chain_bwd.launches - before[1] == 4
    assert result.errors[-1] < result.errors[0]


def test_iteration_has_no_host_sync(cuda_device):
    """Loss, gradient, clip projection and Adam update of one GRAPE
    iteration run with CUDA's synchronizing calls turned into errors."""
    import qoc_tpu_torch
    from qoc_tpu_torch.core.common import (clip_control_norms_torch,
                                           slap_controls_torch,
                                           strip_controls_torch)
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    from qoc_tpu_torch.models import (GrapeSchroedingerDiscreteState,
                                      InterpolationPolicy, MagnusPolicy)
    d, n_c, n = 8, 2, 64
    rng = np.random.default_rng(1)
    h0 = rng.normal(size=(d, d))
    initial = np.zeros((1, d, 1))
    initial[0, 0] = 1
    target = np.zeros((1, d, 1))
    target[0, -1] = 1
    controls = 0.1 * (rng.normal(size=(n, n_c))
                      + 1j * rng.normal(size=(n, n_c)))
    pstate = GrapeSchroedingerDiscreteState(
        True, n_c, n, 1, [qoc_tpu_torch.TargetStateInfidelity(target)], 1.0,
        qoc_tpu_torch.LinearHamiltonian(h0 + h0.T,
                                        0.3 * np.ones((n_c, d, d))),
        None, controls, initial, InterpolationPolicy.LINEAR, 1, 0,
        [1.0] * n_c, MagnusPolicy.M2, 0, qoc_tpu_torch.Adam(), None, False,
        0, n)
    loss = build_schroedinger_loss(pstate, cuda_device, torch.float32)
    adam = pstate.optimizer
    mcn = torch.ones(n_c, device=cuda_device)
    params = strip_controls_torch(True, torch.as_tensor(
        controls, dtype=torch.complex64, device=cuda_device))
    state = adam.init_state(params)

    def iteration(params, state):
        controls = clip_control_norms_torch(
            slap_controls_torch(True, params, (n, n_c)), mcn)
        flat = strip_controls_torch(True, controls).detach()
        flat.requires_grad_(True)
        error, _ = loss(slap_controls_torch(True, flat, (n, n_c)))
        grads, = torch.autograd.grad(error, flat)
        state, new_params = adam.update(state, grads, params)
        return torch.where(error <= 0.0, params, new_params), state

    params, state = iteration(params, state)   # builds and caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            params, state = iteration(params, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(params).all())
