"""K1/K2, K5, K3/K4 and K6 on the card against their plain PyTorch versions
(float32), and the routes that launch them.

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


def _unit_planes(rng, n_steps, d):
    planes = anti_hermitian_basis(rng, n_steps, d)
    return planes / np.abs(planes).sum(-2).max()


@pytest.mark.parametrize("d,n_steps", ((4, 3), (16, 37), (64, 203)))
@pytest.mark.parametrize("target_norm", (0.03, 0.3, 1.0, 2.5, 7.0))
def test_plane_kernels_match_plain_versions(cuda_device, d, n_steps,
                                            target_norm):
    """The plane op's total and plane gradient, K5 against its plain
    versions on every ladder level."""
    from qoc_tpu_torch.ops.chain import plane_chain_propagate
    rng = np.random.default_rng(11)
    planes = (_unit_planes(rng, n_steps, d) * target_norm).astype(
        np.complex64)
    tgt = torch.as_tensor(rng.normal(size=(d, d)).astype(np.complex64),
                          device=cuda_device)
    outs = []
    for plain in (False, True):
        a = torch.as_tensor(planes, device=cuda_device).requires_grad_(True)
        total = plane_chain_propagate(a, plain)
        grad, = torch.autograd.grad(
            torch.sum(torch.abs(total - tgt) ** 2), a)
        outs.append((total.detach(), grad))
    torch.cuda.synchronize()
    (total_k, grad_k), (total_p, grad_p) = outs
    assert float((total_k - total_p).abs().max()
                 / total_p.abs().max()) < FWD_RTOL
    assert float((grad_k - grad_p).abs().max()
                 / grad_p.abs().max()) < GRAD_RTOL


@pytest.mark.parametrize("d", (4, 16))
def test_plane_kernel_padding_stays_identity(cuda_device, d):
    """Zero-padded rows and columns of every prefix, and the padded steps
    after the last real one, stay exactly the identity."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(12)
    n_steps = 37                    # 5 segments of 8: 3 padded steps
    s_count, length = chain.segment_plan(n_steps)
    a = torch.zeros((s_count * length, chain.KERNEL_DP, chain.KERNEL_DP),
                    dtype=torch.complex64, device=cuda_device)
    a[:n_steps, :d, :d] = torch.as_tensor(
        _unit_planes(rng, n_steps, d).astype(np.complex64),
        device=cuda_device)
    a = a.reshape(s_count, length, chain.KERNEL_DP, chain.KERNEL_DP)
    pref = chain.plane_fwd(a, chain._plane_norm_max(a)[0])
    torch.cuda.synchronize()
    eye = torch.eye(chain.KERNEL_DP - d, dtype=torch.complex64,
                    device=cuda_device)
    assert torch.equal(pref[..., d:, d:], eye.expand_as(pref[..., d:, d:]))
    assert not bool(pref[..., :d, d:].any() or pref[..., d:, :d].any())
    last = n_steps - (s_count - 1) * length        # real steps, last segment
    tail = pref[-1, last:]
    assert torch.equal(tail, tail[:1].expand_as(tail))


def _plane_grape_problem(d=8, n_c=2, n=64):
    rng = np.random.default_rng(2)
    h0 = rng.normal(size=(d, d))
    initial = np.zeros((1, d, 1))
    initial[0, 0] = 1
    target = np.zeros((1, d, 1))
    target[0, -1] = 1
    return h0 + h0.T, 0.3 * np.ones((n_c, d, d)), initial, target


def test_plane_grape_launches_k5_only(cuda_device):
    """An M4 GRAPE with a torch callable takes the plane route: K5 forward
    and backward once an iteration, K1/K2 never."""
    import qoc_tpu_torch
    from qoc_tpu_torch.models import MagnusPolicy
    from qoc_tpu_torch.ops import chain
    h0, ops, initial, target = _plane_grape_problem()
    h0_t = torch.as_tensor(h0 + 0j, dtype=torch.complex64,
                           device=cuda_device)
    ops_t = torch.as_tensor(ops + 0j, dtype=torch.complex64,
                            device=cuda_device)

    def hamiltonian(c, t):
        drive = torch.einsum("i,iab->ab", c, ops_t.to(c.dtype))
        return torch.cos(t) * h0_t + drive + drive.mH

    counters = (chain.chain_fwd, chain.chain_bwd, chain.plane_fwd,
                chain.plane_bwd)
    before = [fn.launches for fn in counters]
    result = qoc_tpu_torch.grape_schroedinger_discrete(
        2, 64, [qoc_tpu_torch.TargetStateInfidelity(target)], 1.0,
        hamiltonian, initial, 64, complex_controls=True, iteration_count=4,
        log_iteration_step=0, magnus_policy=MagnusPolicy.M4,
        device=cuda_device)
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [0, 0, 4, 4]
    assert result.errors[-1] < result.errors[0]


def test_plane_route_matches_fused_route(cuda_device):
    """The same M2 chain at d = 64 and 203 steps through K1/K2 (a
    LinearHamiltonian) and through K5 (the same Hamiltonian as a torch
    callable): loss and control gradient."""
    import qoc_tpu_torch
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    from qoc_tpu_torch.models import (GrapeSchroedingerDiscreteState,
                                      InterpolationPolicy, MagnusPolicy)
    from torch_parity import random_hermitian
    d, n_c, n = 64, 3, 203
    rng = np.random.default_rng(3)
    h0 = random_hermitian(rng, d)
    ops = 0.5 * (rng.normal(size=(n_c, d, d))
                 + 1j * rng.normal(size=(n_c, d, d)))
    controls = 0.05 * (rng.normal(size=(n, n_c))
                       + 1j * rng.normal(size=(n, n_c)))
    initial = np.zeros((1, d, 1))
    initial[0, 0] = 1
    target = np.zeros((1, d, 1))
    target[0, -1] = 1
    h0_t = torch.as_tensor(h0, dtype=torch.complex64, device=cuda_device)
    ops_t = torch.as_tensor(ops, dtype=torch.complex64, device=cuda_device)

    def callable_hamiltonian(c, t):
        drive = torch.einsum("i,iab->ab", c, ops_t)
        return h0_t + drive + drive.mH

    flat = strip_controls(True, controls)
    results = []
    for hamiltonian in (qoc_tpu_torch.LinearHamiltonian(h0, ops),
                        callable_hamiltonian):
        pstate = GrapeSchroedingerDiscreteState(
            True, n_c, n, 1, [qoc_tpu_torch.TargetStateInfidelity(target)],
            2.0, hamiltonian, None, controls, initial,
            InterpolationPolicy.LINEAR, 1, 0, [10.0] * n_c, MagnusPolicy.M2,
            0, qoc_tpu_torch.Adam(), None, False, 0, n)
        loss = build_schroedinger_loss(pstate, cuda_device, torch.float32)
        flat_t = torch.as_tensor(flat, dtype=torch.float32,
                                 device=cuda_device).requires_grad_(True)
        error, _ = loss(slap_controls_torch(True, flat_t, (n, n_c)))
        grad, = torch.autograd.grad(error, flat_t)
        results.append((float(error.detach()), grad))
    (fused, g_fused), (plane, g_plane) = results
    assert abs(plane - fused) / abs(fused) < FWD_RTOL
    assert float((g_plane - g_fused).abs().max()
                 / g_fused.abs().max()) < GRAD_RTOL


@pytest.mark.parametrize("d", (16, 64, 128, 256))
@pytest.mark.parametrize("target_norm", (0.03, 0.3, 1.0, 2.5, 7.0))
def test_expm_kernels_match_plain_versions(cuda_device, d, target_norm):
    """K3 and K4 against their plain versions on every ladder level, at the
    resident (d <= 64) and the tiled (d > 64) design; the padded rows and
    columns of K3's output are exactly the identity's."""
    from qoc_tpu_torch.ops import expm_cuda
    rng = np.random.default_rng(13)
    a = torch.as_tensor((_unit_planes(rng, 37, d) * target_norm).astype(
        np.complex64), device=cuda_device)
    g = torch.as_tensor(rng.normal(size=(37, d, d)).astype(np.complex64),
                        device=cuda_device)
    k3, p3 = expm_cuda.expm_fwd(a), expm_cuda.expm_fwd_plain(a)
    k4 = expm_cuda.expm_frechet_fwd(a, g)
    p4 = expm_cuda.expm_frechet_plain(a, g)
    dp = expm_cuda.kernel_dp(d)
    x = expm_cuda._padded(a, dp)
    padded = expm_cuda._launch(False, dp, expm_cuda._norm_max(x), x)
    torch.cuda.synchronize()
    assert float((k3 - p3).abs().max() / p3.abs().max()) < FWD_RTOL
    assert float((k4 - p4).abs().max() / p4.abs().max()) < GRAD_RTOL
    eye = torch.eye(dp - d, dtype=torch.complex64, device=cuda_device)
    assert torch.equal(padded[:, d:, d:], eye.expand(37, dp - d, dp - d))
    assert not bool(padded[:, :d, d:].any() or padded[:, d:, :d].any())


def test_d128_grape_launches_k3_k4_only(cuda_device):
    """A d = 128 GRAPE takes the blocked route: K3 and K4 once an
    iteration, K1/K2/K5 never."""
    import qoc_tpu_torch
    from qoc_tpu_torch.ops import chain, expm_cuda
    from torch_parity import random_hermitian
    d, n_c, n = 128, 2, 40
    rng = np.random.default_rng(4)
    ops = 0.05 * (rng.normal(size=(n_c, d, d))
                  + 1j * rng.normal(size=(n_c, d, d)))
    ham = qoc_tpu_torch.LinearHamiltonian(random_hermitian(rng, d), ops)
    initial = np.zeros((1, d, 1))
    initial[0, 0] = 1
    target = np.zeros((1, d, 1))
    target[0, -1] = 1
    counters = (chain.chain_fwd, chain.chain_bwd, chain.plane_fwd,
                chain.plane_bwd, expm_cuda.expm_fwd,
                expm_cuda.expm_frechet_fwd)
    before = [fn.launches for fn in counters]
    result = qoc_tpu_torch.grape_schroedinger_discrete(
        n_c, n, [qoc_tpu_torch.TargetStateInfidelity(target)], 1.0, ham,
        initial, n, complex_controls=True, iteration_count=4,
        log_iteration_step=0, device=cuda_device)
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [0, 0, 0, 0, 4, 4]
    assert result.errors[-1] < result.errors[0]


def test_blocked_route_matches_plane_route(cuda_device):
    """An M4 callable at d = 16 and 203 steps through the blocked route
    (K3/K4, allow_plane_chain=False) and the plane route (K5): loss and
    control gradient."""
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    from qoc_tpu_torch.models import (GrapeSchroedingerDiscreteState,
                                      InterpolationPolicy, MagnusPolicy)
    import qoc_tpu_torch
    from torch_parity import random_hermitian
    d, n_c, n = 16, 2, 203
    rng = np.random.default_rng(5)
    h0 = torch.as_tensor(random_hermitian(rng, d), dtype=torch.complex64,
                         device=cuda_device)
    ops = torch.as_tensor(0.5 * (rng.normal(size=(n_c, d, d))
                                 + 1j * rng.normal(size=(n_c, d, d))),
                          dtype=torch.complex64, device=cuda_device)
    controls = 0.05 * (rng.normal(size=(n, n_c))
                       + 1j * rng.normal(size=(n, n_c)))
    initial = np.zeros((1, d, 1))
    initial[0, 0] = 1
    target = np.zeros((1, d, 1))
    target[0, -1] = 1

    def hamiltonian(c, t):
        drive = torch.einsum("i,iab->ab", c, ops)
        return torch.cos(t) * h0 + drive + drive.mH

    pstate = GrapeSchroedingerDiscreteState(
        True, n_c, n, 1, [qoc_tpu_torch.TargetStateInfidelity(target)], 2.0,
        hamiltonian, None, controls, initial, InterpolationPolicy.LINEAR, 1,
        0, [10.0] * n_c, MagnusPolicy.M4, 0, qoc_tpu_torch.Adam(), None,
        False, 0, n)
    flat = strip_controls(True, controls)
    results = []
    for allow in (False, True):
        loss = build_schroedinger_loss(pstate, cuda_device, torch.float32,
                                       allow_plane_chain=allow)
        flat_t = torch.as_tensor(flat, dtype=torch.float32,
                                 device=cuda_device).requires_grad_(True)
        error, _ = loss(slap_controls_torch(True, flat_t, (n, n_c)))
        grad, = torch.autograd.grad(error, flat_t)
        results.append((float(error.detach()), grad))
    (blocked, g_blocked), (plane, g_plane) = results
    assert abs(blocked - plane) / abs(plane) < FWD_RTOL
    assert float((g_blocked - g_plane).abs().max()
                 / g_plane.abs().max()) < GRAD_RTOL


@pytest.mark.parametrize("d,n_steps", ((260, 5), (400, 19)))
@pytest.mark.parametrize("target_norm", (0.3, 2.5, 7.0))
def test_stream_kernels_match_plain_versions(cuda_device, d, n_steps,
                                             target_norm):
    """The plane op's total and plane gradient at 256 < padded d <= 512,
    K6 against its plain versions, on decaying non-normal planes (U^H is
    not U^-1)."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(14)
    k = _unit_planes(rng, n_steps, d)
    n = rng.normal(size=(n_steps, d, d)) + 1j * rng.normal(
        size=(n_steps, d, d))
    nn = n @ np.conj(np.swapaxes(n, -1, -2))
    planes = k - 0.1 * nn / np.abs(nn).sum(-2).max()
    planes = (planes * target_norm / np.abs(planes).sum(-2).max()).astype(
        np.complex64)
    tgt = torch.as_tensor(rng.normal(size=(d, d)).astype(np.complex64),
                          device=cuda_device)
    before = (chain.stream_fwd.launches, chain.stream_bwd.launches)
    outs = []
    for plain in (False, True):
        a = torch.as_tensor(planes, device=cuda_device).requires_grad_(True)
        total = chain.plane_chain_propagate(a, plain)
        grad, = torch.autograd.grad(
            torch.sum(torch.abs(total - tgt) ** 2), a)
        outs.append((total.detach(), grad))
    torch.cuda.synchronize()
    assert (chain.stream_fwd.launches - before[0],
            chain.stream_bwd.launches - before[1]) == (1, 1)
    (total_k, grad_k), (total_p, grad_p) = outs
    assert float((total_k - total_p).abs().max()
                 / total_p.abs().max()) < FWD_RTOL
    assert float((grad_k - grad_p).abs().max()
                 / grad_p.abs().max()) < GRAD_RTOL


def _lindblad_d20():
    """The d = 20 Lindblad cell of chip_smoke.py (superoperator 400, 100
    steps): the keyword arguments of grape_lindblad_discrete."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    return chip_smoke.lindblad_d20_problem()


def test_lindblad_d20_grape_launches_k6_only(cuda_device):
    """grape_lindblad_discrete at d = 20 takes the streamed route: K6
    forward and adjoint once an iteration, K1-K5 never."""
    import qoc_tpu_torch
    from qoc_tpu_torch.ops import chain, expm_cuda
    counters = (chain.chain_fwd, chain.chain_bwd, chain.plane_fwd,
                chain.plane_bwd, expm_cuda.expm_fwd,
                expm_cuda.expm_frechet_fwd, chain.stream_fwd,
                chain.stream_bwd)
    before = [fn.launches for fn in counters]
    result = qoc_tpu_torch.grape_lindblad_discrete(
        iteration_count=3, log_iteration_step=0, device=cuda_device,
        **_lindblad_d20())
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [0, 0, 0, 0, 0, 0, 3, 3]
    assert result.errors[-1] < result.errors[0]
    assert np.all(np.isfinite(result.best_final_densities))


def test_lindblad_iteration_has_no_host_sync(cuda_device):
    """One d = 20 Lindblad GRAPE iteration (clip, loss, gradient, Adam)
    through K6 with CUDA's synchronizing calls turned into errors."""
    import chip_smoke
    from qoc_tpu_torch.core.lindblad import build_lindblad_loss
    _lindblad_d20()                         # chip_smoke importable
    iteration = chip_smoke.make_iteration(chip_smoke.lindblad_d20_pstate(),
                                          cuda_device, build_lindblad_loss)
    iteration()                             # builds and caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            error = iteration()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(error))


def _chip_smoke():
    """chip_smoke.py's problem builders (it imports no JAX)."""
    _lindblad_d20()                         # puts the repo root on sys.path
    import chip_smoke
    return chip_smoke


def _step_inputs(kernel, rng, target_norm, dev):
    """(adjoint, plain adjoint, its inputs but the seeds, padded d) of K2 at
    d = 16 over 37 steps, K5 at d = 16 over 37 steps or K6 at d = 260 over
    5 steps (segment plans 5 x 8, 5 x 8 and 5 x 1), on generators scaled to
    ``target_norm``, the prefixes from the plain forward."""
    from qoc_tpu_torch.ops import chain
    if kernel == "K2":
        n_b, d, n_steps = 5, 16, 37
        base = anti_hermitian_basis(rng, n_b, d)
        w = rng.normal(size=(n_steps, n_b)).astype(np.float32)
        norm1 = np.abs(np.einsum("jk,kab->jab", w, base)).sum(-2).max()
        op = chain.ChainExpmPropagate(base * (target_norm / norm1), dev,
                                      torch.float32)
        s_count, length = chain.segment_plan(n_steps)
        w_seg = torch.zeros((s_count * length, n_b), device=dev)
        w_seg[:n_steps] = torch.as_tensor(w, device=dev)
        w_seg = w_seg.reshape(s_count, length, n_b)
        n1, ninf = chain._norm_max(w_seg.reshape(-1, n_b), op.basis_ri, d)
        pref = chain.chain_fwd_plain(w_seg, op.basis, n1)
        return (chain.chain_bwd, chain.chain_bwd_plain,
                (w_seg, op.basis_h, ninf, pref), op.dp)
    d, n_steps = (16, 37) if kernel == "K5" else (260, 5)
    planes = (_unit_planes(rng, n_steps, d) * target_norm).astype(
        np.complex64)
    if kernel == "K5":
        dp, plan = chain.KERNEL_DP, chain.segment_plan(n_steps)
        fns = (chain.plane_bwd, chain.plane_bwd_plain)
    else:
        dp, plan = chain.kernel_dp(d), chain.stream_segment_plan(n_steps)
        fns = (chain.stream_bwd, chain.stream_bwd_plain)
    a_seg = torch.zeros((plan[0] * plan[1], dp, dp), dtype=torch.complex64,
                        device=dev)
    a_seg[:n_steps, :d, :d] = torch.as_tensor(planes, device=dev)
    a_seg = a_seg.reshape(plan[0], plan[1], dp, dp)
    n1, ninf = chain._plane_norm_max(a_seg)
    pref = chain.plane_fwd_plain(a_seg, n1)
    return fns + ((a_seg, ninf, pref), dp)


@pytest.mark.parametrize("kernel", ("K2", "K5", "K6"))
@pytest.mark.parametrize("target_norm", (0.03, 0.3, 1.0, 2.5, 7.0))
def test_per_step_modes_match_plain_versions(cuda_device, kernel,
                                             target_norm):
    """K2, K5 and K6 in their per-step-seed mode against their plain
    versions on every ladder level, launched in that mode; with seeds zero
    but at each segment's last step, bitwise equal to the last-step mode."""
    rng = np.random.default_rng(15)
    bwd, bwd_plain, args, dp = _step_inputs(kernel, rng, target_norm,
                                            cuda_device)
    s_count, length = args[-1].shape[0], args[-1].shape[1] - 1
    seeds = torch.as_tensor(
        rng.normal(size=(s_count, length, dp, dp, 2)).astype(np.float32),
        device=cuda_device)
    seeds = torch.view_as_complex(seeds)
    before = (bwd.launches, bwd.step_launches)
    got, want = bwd(*args, seeds), bwd_plain(*args, seeds)
    only_last = torch.zeros_like(seeds)
    only_last[:, -1] = seeds[:, -1]
    per_step_last = bwd(*args, only_last)
    last_step = bwd(*args, seeds[:, -1].contiguous())
    torch.cuda.synchronize()
    assert (bwd.launches - before[0], bwd.step_launches - before[1]) == (3, 2)
    assert float((got - want).abs().max() / want.abs().max()) < GRAD_RTOL
    assert torch.equal(per_step_last, last_step)


@pytest.mark.parametrize("op", ("chain", "plane"))
def test_trajectory_ops_match_plain_versions(cuda_device, op):
    """The trajectory form at d = 16 over 37 steps through the kernels
    (K1 and K2, or K5) against the plain versions: total, prefixes and the
    input gradient for random gradients on both outputs."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(16)
    d, n_steps = 16, 37
    if op == "chain":
        basis = anti_hermitian_basis(rng, 3, d) * 0.2
        x = torch.as_tensor(rng.normal(size=(n_steps, 3)).astype(np.float32),
                            device=cuda_device)
        ops = [chain.ChainExpmPropagate(basis, cuda_device, torch.float32,
                                        plain=plain, return_prefixes=True)
               for plain in (False, True)]
        run = [ops[0], ops[1]]
    else:
        x = torch.as_tensor(_unit_planes(rng, n_steps, d).astype(
            np.complex64), device=cuda_device)
        run = [lambda a, plain=plain: chain.plane_chain_propagate_prefixes(
            a, plain) for plain in (False, True)]
    cotangents = [torch.as_tensor((rng.normal(size=shape)
                                   + 1j * rng.normal(size=shape)).astype(
                                       np.complex64), device=cuda_device)
                  for shape in ((d, d), (n_steps, d, d))]
    outs = []
    for fn in run:
        xt = x.clone().requires_grad_(True)
        total, prefixes = fn(xt)
        grad, = torch.autograd.grad((total, prefixes), xt, cotangents)
        outs.append((total.detach(), prefixes.detach(), grad))
    torch.cuda.synchronize()
    for (got, want), rtol in zip(zip(*outs), (FWD_RTOL, FWD_RTOL, GRAD_RTOL)):
        assert float((got - want).abs().max() / want.abs().max()) < rtol


def _counters():
    from qoc_tpu_torch.ops import chain, expm_cuda
    return (chain.chain_fwd, chain.chain_bwd, chain.plane_fwd,
            chain.plane_bwd, expm_cuda.expm_fwd, expm_cuda.expm_frechet_fwd,
            chain.stream_fwd, chain.stream_bwd)


def _launches(counters):
    return ([fn.launches for fn in counters]
            + [counters[i].step_launches for i in (1, 3, 7)])


def test_stepcost_headline_grape_launches_k1_k2_only(cuda_device):
    """The step-cost headline (the Table-3 problem with ForbidStates of
    |1>) takes the fused route in its trajectory form: K1, and K2 in its
    per-step-seed mode, once an iteration; nothing else."""
    import qoc_tpu_torch
    cs = _chip_smoke()
    pstate, hamiltonian, costs = cs.stepcost_problem()
    counters = _counters()
    before = _launches(counters)
    result = qoc_tpu_torch.grape_schroedinger_discrete(
        cs.CONTROL_COUNT, cs.CONTROL_EVAL_COUNT, costs, cs.EVOLUTION_TIME,
        hamiltonian, pstate.initial_states, cs.SYSTEM_EVAL_COUNT,
        complex_controls=True, initial_controls=pstate.initial_controls,
        iteration_count=3, log_iteration_step=0,
        max_control_norms=pstate.max_control_norms, device=cuda_device)
    assert [n - b for n, b in zip(_launches(counters), before)] == \
        [3, 3, 0, 0, 0, 0, 0, 0, 3, 0, 0]
    assert result.errors[-1] < result.errors[0]


def test_lindblad_d20_stepcost_grape_launches_k6_only(cuda_device):
    """The d = 20 Lindblad cell with density step costs: K6 forward and
    adjoint (per-step-seed mode) once an iteration, K1-K5 never."""
    import qoc_tpu_torch
    cs = _chip_smoke()
    counters = _counters()
    before = _launches(counters)
    result = qoc_tpu_torch.grape_lindblad_discrete(
        iteration_count=3, log_iteration_step=0, device=cuda_device,
        **cs.lindblad_d20_problem(cs.d20_step_costs()))
    assert [n - b for n, b in zip(_launches(counters), before)] == \
        [0, 0, 0, 0, 0, 0, 3, 3, 0, 0, 3]
    assert result.errors[-1] < result.errors[0]


@pytest.mark.parametrize("cell", ("headline", "lindblad d20"))
def test_stepcost_iteration_has_no_host_sync(cuda_device, cell):
    """One step-cost GRAPE iteration (clip, loss with the per-step prefixes,
    gradient through the per-step seeds, Adam) with CUDA's synchronizing
    calls turned into errors."""
    from qoc_tpu_torch.core.lindblad import build_lindblad_loss
    cs = _chip_smoke()
    if cell == "headline":
        iteration = cs.make_iteration(cs.stepcost_problem()[0], cuda_device)
    else:
        iteration = cs.make_iteration(
            cs.lindblad_d20_pstate(cs.d20_step_costs()), cuda_device,
            build_lindblad_loss)
    iteration()                             # builds and caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            error = iteration()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(error))
