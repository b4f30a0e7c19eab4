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


@pytest.mark.parametrize("d", (16, 64, 128, 180, 256))
@pytest.mark.parametrize("target_norm", (0.03, 0.3, 1.0, 2.5, 7.0))
def test_expm_kernels_match_plain_versions(cuda_device, d, target_norm):
    """K3 and K4 against their plain versions on every ladder level, at the
    resident (d <= 64) and the tiled (padded 128, 192, 256) design; the
    padded rows and columns of K3's output are exactly the identity's."""
    _check_expm_kernels(cuda_device, d, target_norm, 37)


@pytest.mark.parametrize("d", (128, 180, 256))
@pytest.mark.parametrize("batch", (1, 133))
def test_expm_kernels_on_ragged_batches(cuda_device, d, batch):
    """The tiled K3/K4 on one matrix (one block busy) and on 133 (one more
    than the 132 blocks an H100 keeps resident: a ragged last wave)."""
    _check_expm_kernels(cuda_device, d, 2.5, batch)


def _check_expm_kernels(cuda_device, d, target_norm, batch):
    from qoc_tpu_torch.ops import expm_cuda
    rng = np.random.default_rng(13)
    a = torch.as_tensor((_unit_planes(rng, batch, d) * target_norm).astype(
        np.complex64), device=cuda_device)
    g = torch.as_tensor(rng.normal(size=(batch, d, d)).astype(np.complex64),
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
    assert torch.equal(padded[:, d:, d:], eye.expand(batch, dp - d, dp - d))
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


@pytest.mark.parametrize("d", (260, 400, 512))
@pytest.mark.parametrize("per_step", (False, True))
def test_stream_adjoint_matches_plain_version(cuda_device, d, per_step):
    """K6's adjoint alone at padded 320, 448 and 512 on 3 segments of 2
    steps (3 clusters of the card's resident ones busy), in both seed
    modes, on decaying non-normal planes at the degree-8 level; per-step
    seeds zero but at each segment's last step give the last-step mode
    bitwise."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(16)
    n_steps, dp = 6, chain.kernel_dp(d)
    k = _unit_planes(rng, n_steps, d)
    n = rng.normal(size=(n_steps, d, d)) + 1j * rng.normal(
        size=(n_steps, d, d))
    nn = n @ np.conj(np.swapaxes(n, -1, -2))
    planes = k - 0.1 * nn / np.abs(nn).sum(-2).max()
    planes = (planes * 0.3 / np.abs(planes).sum(-2).max()).astype(
        np.complex64)
    a_seg = torch.zeros((n_steps, dp, dp), dtype=torch.complex64,
                        device=cuda_device)
    a_seg[:, :d, :d] = torch.as_tensor(planes, device=cuda_device)
    a_seg = a_seg.reshape(3, 2, dp, dp)
    n1, ninf = chain._plane_norm_max(a_seg)
    pref = chain.plane_fwd_plain(a_seg, n1)
    shape = (3, 2, dp, dp) if per_step else (3, dp, dp)
    seeds = torch.view_as_complex(torch.as_tensor(
        rng.normal(size=shape + (2,)).astype(np.float32), device=cuda_device))
    before = chain.stream_bwd.step_launches
    got = chain.stream_bwd(a_seg, ninf, pref, seeds)
    want = chain.stream_bwd_plain(a_seg, ninf, pref, seeds)
    if per_step:
        only_last = torch.zeros_like(seeds)
        only_last[:, -1] = seeds[:, -1]
        assert torch.equal(chain.stream_bwd(a_seg, ninf, pref, only_last),
                           chain.stream_bwd(a_seg, ninf, pref,
                                            seeds[:, -1].contiguous()))
    torch.cuda.synchronize()
    assert chain.ladder_level(ninf) == 1
    assert chain.stream_bwd.step_launches - before == 2 * per_step
    assert float((got - want).abs().max() / want.abs().max()) < GRAD_RTOL


def test_d128_iteration_has_no_host_sync(cuda_device):
    """One d = 2^7 GRAPE iteration of chip_smoke.py (clip, loss, gradient,
    Adam; the blocked route through K3/K4) with CUDA's synchronizing calls
    turned into errors."""
    chip_smoke = _chip_smoke()
    iteration = chip_smoke.make_iteration(chip_smoke.d128_problem()[0],
                                          cuda_device)
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


_LEVEL_NORMS = {0.03: 0, 0.3: 1, 1.0: 2, 2.5: 3, 7.0: 4}


def _resident_adjoint_inputs(kernel, rng, d, s_count, length, target_norm,
                             dev):
    """(adjoint, plain adjoint, its inputs but the seeds) of K2 or K5 on
    s_count segment chains of ``length`` steps at d zero-padded to the
    kernels' 64, the generators' inf-norm (the adjoint's level) scaled to
    ``target_norm``, the prefixes from the plain forward."""
    from qoc_tpu_torch.ops import chain
    dp = chain.KERNEL_DP
    n = s_count * length
    if kernel == "K2":
        n_b = 5
        base = anti_hermitian_basis(rng, n_b, d)
        w = rng.normal(size=(n, n_b)).astype(np.float32)
        ninf = np.abs(np.einsum("jk,kab->jab", w, base)).sum(-1).max()
        basis = np.zeros((n_b, dp, dp), np.complex64)
        basis[:, :d, :d] = base * (target_norm / ninf)
        basis = torch.as_tensor(basis, device=dev)
        w_seg = torch.as_tensor(w, device=dev).reshape(s_count, length, n_b)
        planes = torch.einsum("slk,kab->slab", w_seg.to(torch.complex64),
                              basis)
        head = (w_seg, basis.mH.contiguous())
        fns = (chain.chain_bwd, chain.chain_bwd_plain)
    else:
        x = anti_hermitian_basis(rng, n, d)
        planes = torch.zeros((n, dp, dp), dtype=torch.complex64, device=dev)
        planes[:, :d, :d] = torch.as_tensor(
            (x * (target_norm / np.abs(x).sum(-1).max())).astype(
                np.complex64), device=dev)
        planes = planes.reshape(s_count, length, dp, dp)
        head = (planes,)
        fns = (chain.plane_bwd, chain.plane_bwd_plain)
    n1, ninf = chain._plane_norm_max(planes)
    assert chain.ladder_level(ninf) == _LEVEL_NORMS[target_norm]
    return fns + (head + (ninf, chain.plane_fwd_plain(planes, n1)),)


@pytest.mark.parametrize("kernel", ("K2", "K5"))
@pytest.mark.parametrize("d", (3, 17, 64))
@pytest.mark.parametrize("target_norm", tuple(_LEVEL_NORMS))
def test_resident_adjoints_match_plain_versions(cuda_device, kernel, d,
                                                target_norm):
    """K2 and K5's adjoint (csrc/chain_common.cuh Adjoint) against their
    plain versions on every ladder level, over S x L = 1 x 1, 37 x 5 and
    127 x 3 segment chains, in both seed modes; the zero padding stays
    exactly zero, and with seeds zero but at each segment's last step the
    per-step mode is bitwise the last-step mode."""
    rng = np.random.default_rng(int(100 * target_norm) + d)
    dp = 64
    for s_count, length in ((1, 1), (37, 5), (127, 3)):
        bwd, bwd_plain, args = _resident_adjoint_inputs(
            kernel, rng, d, s_count, length, target_norm, cuda_device)
        for shape in ((s_count, d, d), (s_count, length, d, d)):
            seeds = torch.zeros(shape[:-2] + (dp, dp), dtype=torch.complex64,
                                device=cuda_device)
            seeds[..., :d, :d] = torch.as_tensor(
                (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
                    np.complex64), device=cuda_device)
            got, want = bwd(*args, seeds), bwd_plain(*args, seeds)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()
                         / want.abs().max()) < GRAD_RTOL
            assert not bool(got[..., d:, :].any() or got[..., :, d:].any())
        only_last = torch.zeros_like(seeds)
        only_last[:, -1] = seeds[:, -1]
        assert torch.equal(bwd(*args, only_last),
                           bwd(*args, seeds[:, -1].contiguous()))


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


# (members, steps) of the member-batched K1/K2 cases: S_m > 1 segments a
# chain at 2 and 5 members, one segment a chain (the grouped packing) at 9
# members over 8 steps and at 133 members, whose 133 rows leave a ragged
# last wave on the H100's 132 SMs.
_MEMBER_CASES = ((2, 40), (5, 203), (9, 8), (133, 12))


@pytest.mark.parametrize("n_members,n_steps", _MEMBER_CASES)
@pytest.mark.parametrize("target_norm", tuple(_LEVEL_NORMS))
@pytest.mark.parametrize("trajectory", (False, True))
def test_member_batched_chain_matches_plain_versions(
        cuda_device, n_members, n_steps, target_norm, trajectory):
    """The chain op's member axis through K1/K2 (one launch each) against
    the plain versions on every ladder level, in both seed modes: totals,
    prefixes and the weight gradient; the first and last member against
    the single-chain op on the card; the padded rows and steps of the
    prefixes exactly the identity."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(n_members + int(10 * target_norm))
    d, n_b = 8, 5
    base = anti_hermitian_basis(rng, n_b, d)
    w = rng.normal(size=(n_members, n_steps, n_b)).astype(np.float32)
    norm1 = np.abs(np.einsum("mjk,kab->mjab", w, base)).sum(-2).max()
    basis = base * (target_norm / norm1)
    g_total = torch.as_tensor(
        rng.normal(size=(n_members, d, d)).astype(np.complex64),
        device=cuda_device)
    g_pref = torch.as_tensor(
        rng.normal(size=(n_members, n_steps, d, d)).astype(np.complex64),
        device=cuda_device)
    wt = torch.as_tensor(w, device=cuda_device)

    def run(plain, x, g_t, g_p):
        op = chain.ChainExpmPropagate(basis, cuda_device, torch.float32,
                                      plain=plain,
                                      return_prefixes=trajectory)
        x = x.clone().requires_grad_(True)
        out = op(x)
        grad, = torch.autograd.grad(out, x, (g_t, g_p) if trajectory
                                    else g_t)
        return [o.detach() for o in (out if trajectory else (out,))] + [grad]

    before = (chain.chain_fwd.launches, chain.chain_bwd.launches,
              chain.chain_bwd.step_launches)
    got = run(False, wt, g_total, g_pref)
    assert (chain.chain_fwd.launches - before[0],
            chain.chain_bwd.launches - before[1],
            chain.chain_bwd.step_launches - before[2]) == (1, 1,
                                                           int(trajectory))
    want = run(True, wt, g_total, g_pref)
    torch.cuda.synchronize()
    for x, y, rtol in zip(got, want, (FWD_RTOL,) * (len(got) - 1)
                          + (GRAD_RTOL,)):
        assert float((x - y).abs().max() / y.abs().max()) < rtol
    for m in (0, n_members - 1):
        alone = run(False, wt[m], g_total[m], g_pref[m])
        for x, y, rtol in zip(got, alone, (FWD_RTOL,) * (len(got) - 1)
                              + (GRAD_RTOL,)):
            assert float((x[m] - y).abs().max() / y.abs().max()) < rtol
    # Padding: the kernels' prefixes outside d and past the last step.
    s_count, length = chain.segment_plan(n_steps, n_members)
    op = chain.ChainExpmPropagate(basis, cuda_device, torch.float32)
    w_seg = torch.zeros((n_members, s_count * length, n_b),
                        device=cuda_device)
    w_seg[:, :n_steps] = wt
    w_seg = w_seg.reshape(n_members * s_count, length, n_b)
    pref = chain.chain_fwd(w_seg, op.basis, chain._norm_max(
        wt, op.basis_ri, d)[0]).reshape(n_members, s_count * (length + 1),
                                        64, 64)
    eye = torch.eye(64, dtype=torch.complex64, device=cuda_device)
    assert torch.equal(pref[..., d:, d:], eye[d:, d:].expand_as(
        pref[..., d:, d:]))
    assert not bool(pref[..., :d, d:].any() or pref[..., d:, :d].any())
    tail = pref.reshape(n_members, s_count, length + 1, 64, 64)[
        :, -1, 1 + n_steps - (s_count - 1) * length:]
    last = pref.reshape(n_members, s_count, length + 1, 64, 64)[
        :, -1, n_steps - (s_count - 1) * length]
    assert torch.equal(tail, last[:, None].expand_as(tail))


def _ensemble_problem(d=8, n_steps=64, magnus="M2"):
    import qoc_tpu_torch
    rng = np.random.default_rng(5)
    h0 = rng.normal(size=(d, d))
    h0 = h0 + h0.T
    ham = qoc_tpu_torch.EnsembleLinearHamiltonian(
        h0, 0.3 * np.ones((2, d, d)), h0[None])
    initial = np.zeros((1, d, 1))
    initial[0, 0] = 1
    target = np.zeros((1, d, 1))
    target[0, -1] = 1
    return dict(control_count=2, control_eval_count=n_steps,
                costs=[qoc_tpu_torch.TargetStateInfidelity(target)],
                evolution_time=1.0, hamiltonian=ham,
                initial_states=initial, system_eval_count=n_steps,
                complex_controls=True, log_iteration_step=0,
                magnus_policy=qoc_tpu_torch.models.MagnusPolicy[magnus])


@pytest.mark.parametrize("magnus,launched", (
    ("M2", ("K1", "K2")), ("M4", ("K3", "K4"))))
def test_ensemble_grape_launches(cuda_device, magnus, launched):
    """grape_schroedinger_ensemble with 4 members: under M2 the fused route
    launches K1 and K2 once an iteration for all members, under M4 the
    blocked route K3 and K4; nothing else."""
    import qoc_tpu_torch
    from qoc_tpu_torch.ops import chain, expm_cuda
    wrappers = {"K1": chain.chain_fwd, "K2": chain.chain_bwd,
                "K3": expm_cuda.expm_fwd, "K4": expm_cuda.expm_frechet_fwd,
                "K5 fwd": chain.plane_fwd, "K5 bwd": chain.plane_bwd,
                "K6 fwd": chain.stream_fwd, "K6 bwd": chain.stream_bwd}
    before = {key: fn.launches for key, fn in wrappers.items()}
    result = qoc_tpu_torch.grape_schroedinger_ensemble(
        hamiltonian_params=np.linspace(-0.05, 0.05, 4)[:, None],
        iteration_count=3, device=cuda_device, **_ensemble_problem(
            magnus=magnus))
    counts = {key: fn.launches - before[key]
              for key, fn in wrappers.items()}
    assert counts == {key: 3 if key in launched else 0 for key in counts}
    assert result.best_final_states.shape == (4, 1, 8, 1)
    assert result.errors[-1] < result.errors[0]


def test_multistart_iteration_has_no_host_sync(cuda_device):
    """One robust multistart iteration (16 candidates x 2 members through
    K1/K2: clip, loss and gradient, the per-candidate Adam) runs with
    CUDA's synchronizing calls turned into errors."""
    import qoc_tpu_torch
    from qoc_tpu_torch.core.common import (clip_control_norms_torch,
                                           slap_controls_torch,
                                           strip_controls_torch)
    from qoc_tpu_torch.models import (GrapeSchroedingerDiscreteState,
                                      InterpolationPolicy)
    from qoc_tpu_torch.parallel.ensemble import build_chain_loss
    kw = _ensemble_problem()
    n, n_c, n_starts = kw["system_eval_count"], kw["control_count"], 16
    params = np.array([[-0.05], [0.05]])
    adam = qoc_tpu_torch.Adam()
    pstate = GrapeSchroedingerDiscreteState(
        True, n_c, n, 1, kw["costs"], 1.0, kw["hamiltonian"], None,
        np.zeros((n, n_c), complex), kw["initial_states"],
        InterpolationPolicy.LINEAR, 1, 0, [1.0] * n_c, kw["magnus_policy"],
        0, adam, None, False, 0, n)
    loss = build_chain_loss(pstate, kw["hamiltonian"], params, cuda_device,
                            torch.float32, n_candidates=n_starts)
    assert loss.route == "fused"
    slap = torch.func.vmap(lambda p: slap_controls_torch(True, p, (n, n_c)))
    strip = torch.func.vmap(lambda c: strip_controls_torch(True, c))
    mcn = torch.ones(n_c, device=cuda_device)
    flat = torch.randn((n_starts, 2 * n * n_c), device=cuda_device) * 0.1
    state = adam.init_state_batch(flat)

    def iteration(flat, state):
        clipped = strip(clip_control_norms_torch(slap(flat), mcn)).detach()
        clipped.requires_grad_(True)
        errors = loss(slap(clipped))[0].mean(dim=1)
        grads, = torch.autograd.grad(errors.sum(), clipped)
        state, flat = adam.update_batch(state, grads, flat,
                                        errors.detach() <= 0.0)
        return flat, state

    flat, state = iteration(flat, state)   # builds and caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flat, state = iteration(flat, state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(flat).all())


# (kernel, d, chains, steps) of the member-batched plane op: K6 at d = 260
# with S_m > 1 segments a chain (2 and 5 members; 16 chains of 2 steps, 32
# rows in 3 waves of the 15 resident clusters), one a chain (15 chains fill
# the clusters) and 17 chains of one step (a ragged second wave of the
# clusters' loop); K5 at d = 16 with S_m > 1 (3 members) and 133 chains of
# one segment (a ragged last wave of blocks).
_PLANE_MEMBER_CASES = (("K6", 260, 2, 7), ("K6", 260, 5, 3),
                       ("K6", 260, 16, 2), ("K6", 260, 15, 2),
                       ("K6", 260, 17, 1), ("K5", 16, 3, 37),
                       ("K5", 16, 133, 5))


def _member_planes(gen, n_chains, n_steps, d, target_norm, dev):
    """(M, B, d, d) complex64 planes, anti-Hermitian plus a decaying
    Hermitian part (non-normal steps, as Lindblad generators are), at
    batch-max 1-norm ``target_norm``."""
    h = torch.randn((n_chains, n_steps, d, d), dtype=torch.complex64,
                    device=dev, generator=gen)
    n = torch.randn((n_chains, n_steps, d, d), dtype=torch.complex64,
                    device=dev, generator=gen)
    a = -0.5j * (h + h.mH) - 0.01 * (n @ n.mH)
    return a * (target_norm / a.abs().sum(-2).amax())


@pytest.mark.parametrize("kernel,d,n_chains,n_steps", _PLANE_MEMBER_CASES)
@pytest.mark.parametrize("target_norm", tuple(_LEVEL_NORMS))
def test_member_batched_plane_op_matches_plain_versions(
        cuda_device, kernel, d, n_chains, n_steps, target_norm):
    """The plane op's member axis through K6 or K5 (one forward and one
    adjoint launch a backward) against the plain versions on every ladder
    level, in both seed modes: totals, prefixes and the plane gradient; the
    first and last chain against the single-chain op on the card."""
    from qoc_tpu_torch.ops import chain
    fwd, bwd = ((chain.stream_fwd, chain.stream_bwd) if kernel == "K6"
                else (chain.plane_fwd, chain.plane_bwd))
    gen = torch.Generator(device=cuda_device).manual_seed(
        n_chains + int(10 * target_norm))
    a = _member_planes(gen, n_chains, n_steps, d, target_norm, cuda_device)
    g_total = torch.randn((n_chains, d, d), dtype=torch.complex64,
                          device=cuda_device, generator=gen)
    g_pref = torch.randn((n_chains, n_steps, d, d), dtype=torch.complex64,
                         device=cuda_device, generator=gen)

    def run(plain, x, g_t, g_p):
        x = x.clone().requires_grad_(True)
        total, prefixes = chain.plane_chain_propagate_prefixes(x, plain)
        last, = torch.autograd.grad(total, x, g_t, retain_graph=True)
        step, = torch.autograd.grad((total, prefixes), x, (g_t, g_p))
        return total.detach(), prefixes.detach(), last, step

    before = (fwd.launches, bwd.launches, bwd.step_launches)
    got = run(False, a, g_total, g_pref)
    assert (fwd.launches - before[0], bwd.launches - before[1],
            bwd.step_launches - before[2]) == (1, 2, 1)
    want = run(True, a, g_total, g_pref)
    torch.cuda.synchronize()
    rtols = (FWD_RTOL, FWD_RTOL, GRAD_RTOL, GRAD_RTOL)
    for x, y, rtol in zip(got, want, rtols):
        assert float((x - y).abs().max() / y.abs().max()) < rtol
    for m in (0, n_chains - 1):
        alone = run(False, a[m], g_total[m], g_pref[m])
        for x, y, rtol in zip(got, alone, rtols):
            assert float((x[m] - y).abs().max() / y.abs().max()) < rtol


def _lindblad_ensemble(d, n_points):
    """Example 6's open-system ensemble at Hilbert d (chip_smoke.py phase
    32's construction): 4 members of (1 + δ)·h0, one complex control, T1
    decay, |0><0| to |1><1|; the keyword arguments of
    grape_lindblad_ensemble."""
    import qoc_tpu_torch
    a = np.diag(np.sqrt(np.arange(1, d)), 1).astype(complex)
    h0 = 0.1 * a.conj().T @ a if d > 2 else np.diag([0.5, -0.5]) + 0j
    initial = np.zeros((1, d, d), complex)
    initial[0, 0, 0] = 1
    target = np.zeros((1, d, d), complex)
    target[0, 1, 1] = 1
    return dict(
        control_count=1, control_eval_count=n_points,
        costs=[qoc_tpu_torch.TargetDensityInfidelity(target)],
        evolution_time=10.0,
        hamiltonian=qoc_tpu_torch.EnsembleLinearHamiltonian(h0, a[None],
                                                            h0[None]),
        hamiltonian_params=np.linspace(-0.05, 0.05, 4)[:, None],
        initial_densities=initial, system_eval_count=n_points,
        complex_controls=True, log_iteration_step=0,
        lindblad_data=qoc_tpu_torch.ConstantLindblad(np.array([1e-3]),
                                                     a[None]),
        method=qoc_tpu_torch.LindbladMethod.MAGNUS_EXPM)


@pytest.mark.parametrize("d,launched", ((2, ("K1", "K2")),
                                        (17, ("K6 fwd", "K6 bwd"))))
def test_lindblad_ensemble_grape_launches(cuda_device, d, launched):
    """grape_lindblad_ensemble with 4 members: at d = 2 K1/K2's member
    axis, at d = 17 (superoperator 289, padded 320) K6's, once an iteration
    for all members; nothing else."""
    import qoc_tpu_torch
    from qoc_tpu_torch.ops import chain, expm_cuda
    wrappers = {"K1": chain.chain_fwd, "K2": chain.chain_bwd,
                "K3": expm_cuda.expm_fwd, "K4": expm_cuda.expm_frechet_fwd,
                "K5 fwd": chain.plane_fwd, "K5 bwd": chain.plane_bwd,
                "K6 fwd": chain.stream_fwd, "K6 bwd": chain.stream_bwd}
    before = {key: fn.launches for key, fn in wrappers.items()}
    result = qoc_tpu_torch.grape_lindblad_ensemble(
        iteration_count=3, device=cuda_device, **_lindblad_ensemble(d, 21))
    counts = {key: fn.launches - before[key]
              for key, fn in wrappers.items()}
    assert counts == {key: 3 if key in launched else 0 for key in counts}
    assert result.best_final_densities.shape == (4, 1, d, d)
    assert np.all(np.isfinite(result.best_final_densities))
    assert result.errors[-1] < result.errors[0]


# The bf16_3x precision mode (config.MXU_MODE): the second instantiation of
# K1, K2, K5 and K3/K4 at padded 64 (3 x TF32 tensor-core products, _D12A
# at degree 12) against the plain versions in the mode.


@pytest.fixture()
def bf16_3x(monkeypatch):
    from qoc_tpu_torch import config
    monkeypatch.setattr(config, "MXU_MODE", "bf16_3x")


def _mode_counters(*wrappers):
    return [(fn.launches, fn.mode_launches) for fn in wrappers]


@pytest.mark.parametrize("n_members,n_steps", ((1, 37), (3, 41), (133, 5)))
@pytest.mark.parametrize("target_norm", tuple(_LEVEL_NORMS))
def test_mode_chain_kernels_match_plain_versions(cuda_device, bf16_3x,
                                                 n_members, n_steps,
                                                 target_norm):
    """K1/K2 in the mode through the chain op's trajectory form on the
    member axis (one chain, S_m > 1 segments, one segment a chain on 133
    rows) against the plain versions in the mode, on every ladder level
    and in both seed modes, launched in their mode forms; the padded rows
    exactly the identity and the padded steps leaving the last prefix
    unchanged."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(n_members + int(10 * target_norm))
    d, n_b = 8, 5
    base = anti_hermitian_basis(rng, n_b, d)
    w = rng.normal(size=(n_members, n_steps, n_b)).astype(np.float32)
    norm1 = np.abs(np.einsum("mjk,kab->mjab", w, base)).sum(-2).max()
    basis = base * (target_norm / norm1)
    g_total = torch.as_tensor(
        rng.normal(size=(n_members, d, d)).astype(np.complex64),
        device=cuda_device)
    g_pref = torch.as_tensor(
        rng.normal(size=(n_members, n_steps, d, d)).astype(np.complex64),
        device=cuda_device)
    wt = torch.as_tensor(w, device=cuda_device)

    def run(plain):
        op = chain.ChainExpmPropagate(basis, cuda_device, torch.float32,
                                      plain=plain, return_prefixes=True)
        x = wt.clone().requires_grad_(True)
        total, prefixes = op(x)
        last, = torch.autograd.grad(total, x, g_total, retain_graph=True)
        step, = torch.autograd.grad((total, prefixes), x, (g_total, g_pref))
        return total.detach(), prefixes.detach(), last, step

    before = _mode_counters(chain.chain_fwd, chain.chain_bwd)
    got = run(False)
    after = _mode_counters(chain.chain_fwd, chain.chain_bwd)
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)] == \
        [(1, 1), (2, 2)]
    want = run(True)
    torch.cuda.synchronize()
    for x, y, rtol in zip(got, want, (FWD_RTOL, FWD_RTOL, GRAD_RTOL,
                                      GRAD_RTOL)):
        assert float((x - y).abs().max() / y.abs().max()) < rtol
    s_count, length = chain.segment_plan(n_steps, n_members)
    op = chain.ChainExpmPropagate(basis, cuda_device, torch.float32)
    w_seg = torch.zeros((n_members, s_count * length, n_b),
                        device=cuda_device)
    w_seg[:, :n_steps] = wt
    pref = chain.chain_fwd(w_seg.reshape(-1, length, n_b), op.basis,
                           chain._norm_max(wt, op.basis_ri, d)[0])
    pref = pref.reshape(n_members, s_count, length + 1, 64, 64)
    eye = torch.eye(64, dtype=torch.complex64, device=cuda_device)
    assert torch.equal(pref[..., d:, d:], eye[d:, d:].expand_as(
        pref[..., d:, d:]))
    assert not bool(pref[..., :d, d:].any() or pref[..., d:, :d].any())
    last = n_steps - (s_count - 1) * length
    tail = pref[:, -1, last + 1:]
    assert torch.equal(tail, pref[:, -1, last:last + 1].expand_as(tail))


@pytest.mark.parametrize("d,n_chains,n_steps", ((16, 1, 37), (64, 3, 21)))
@pytest.mark.parametrize("target_norm", tuple(_LEVEL_NORMS))
def test_mode_plane_kernels_match_plain_versions(cuda_device, bf16_3x, d,
                                                 n_chains, n_steps,
                                                 target_norm):
    """K5 in the mode through the plane op's trajectory form against the
    plain versions in the mode, on every ladder level, both seed modes, one
    chain and the member axis, launched in its mode forms."""
    from qoc_tpu_torch.ops import chain
    gen = torch.Generator(device=cuda_device).manual_seed(
        d + n_chains + int(10 * target_norm))
    a = _member_planes(gen, n_chains, n_steps, d, target_norm, cuda_device)
    g_total = torch.randn((n_chains, d, d), dtype=torch.complex64,
                          device=cuda_device, generator=gen)
    g_pref = torch.randn((n_chains, n_steps, d, d), dtype=torch.complex64,
                         device=cuda_device, generator=gen)

    def run(plain):
        x = a.clone().requires_grad_(True)
        total, prefixes = chain.plane_chain_propagate_prefixes(x, plain)
        last, = torch.autograd.grad(total, x, g_total, retain_graph=True)
        step, = torch.autograd.grad((total, prefixes), x, (g_total, g_pref))
        return total.detach(), prefixes.detach(), last, step

    before = _mode_counters(chain.plane_fwd, chain.plane_bwd)
    got = run(False)
    after = _mode_counters(chain.plane_fwd, chain.plane_bwd)
    assert [(x[0] - y[0], x[1] - y[1]) for x, y in zip(after, before)] == \
        [(1, 1), (2, 2)]
    want = run(True)
    torch.cuda.synchronize()
    for x, y, rtol in zip(got, want, (FWD_RTOL, FWD_RTOL, GRAD_RTOL,
                                      GRAD_RTOL)):
        assert float((x - y).abs().max() / y.abs().max()) < rtol


@pytest.mark.parametrize("kernel", ("K2", "K5"))
@pytest.mark.parametrize("target_norm", tuple(_LEVEL_NORMS))
def test_mode_resident_adjoints_match_plain_versions(cuda_device, bf16_3x,
                                                     kernel, target_norm):
    """K2 and K5's adjoint in the mode (AdjointTC) at d = 17 on 37 x 5
    segment chains, both seed modes: against the plain versions in the
    mode, the zero padding exactly zero, and the per-step mode with seeds
    zero but at the last step bitwise the last-step mode."""
    rng = np.random.default_rng(int(100 * target_norm) + 17)
    d, dp, s_count, length = 17, 64, 37, 5
    bwd, bwd_plain, args = _resident_adjoint_inputs(
        kernel, rng, d, s_count, length, target_norm, cuda_device)
    before = bwd.mode_launches
    for shape in ((s_count, d, d), (s_count, length, d, d)):
        seeds = torch.zeros(shape[:-2] + (dp, dp), dtype=torch.complex64,
                            device=cuda_device)
        seeds[..., :d, :d] = torch.as_tensor(
            (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
                np.complex64), device=cuda_device)
        got, want = bwd(*args, seeds), bwd_plain(*args, seeds)
        torch.cuda.synchronize()
        assert float((got - want).abs().max() / want.abs().max()) < GRAD_RTOL
        assert not bool(got[..., d:, :].any() or got[..., :, d:].any())
    assert bwd.mode_launches - before == 2
    only_last = torch.zeros_like(seeds)
    only_last[:, -1] = seeds[:, -1]
    assert torch.equal(bwd(*args, only_last),
                       bwd(*args, seeds[:, -1].contiguous()))


@pytest.mark.parametrize("d", (16, 64))
@pytest.mark.parametrize("target_norm", tuple(_LEVEL_NORMS))
def test_mode_expm_kernels_match_plain_versions(cuda_device, bf16_3x, d,
                                                target_norm):
    """K3/K4 at padded 64 in the mode against their plain versions in the
    mode on every ladder level (batches 37 and 133), launched in their mode
    forms; the padded rows exact."""
    from qoc_tpu_torch.ops import expm_cuda
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    for batch in (37, 133):
        a = _member_planes(gen, 1, batch, d, target_norm, cuda_device)[0]
        g = torch.randn(a.shape, dtype=torch.complex64, device=cuda_device,
                        generator=gen)
        before = _mode_counters(expm_cuda.expm_fwd,
                                expm_cuda.expm_frechet_fwd)
        k3, k4 = expm_cuda.expm_fwd(a), expm_cuda.expm_frechet_fwd(a, g)
        after = _mode_counters(expm_cuda.expm_fwd,
                               expm_cuda.expm_frechet_fwd)
        assert [(x[0] - y[0], x[1] - y[1]) for x, y in zip(after, before)] \
            == [(1, 1), (1, 1)]
        p3 = expm_cuda.expm_fwd_plain(a)
        p4 = expm_cuda.expm_frechet_plain(a, g)
        torch.cuda.synchronize()
        assert float((k3 - p3).abs().max() / p3.abs().max()) < FWD_RTOL
        assert float((k4 - p4).abs().max() / p4.abs().max()) < GRAD_RTOL
    if d < 64:
        x = expm_cuda._padded(a, 64)
        norm = expm_cuda._norm_max(x)
        u = expm_cuda._launch(False, 64, norm, x, tf32=1)
        dl = expm_cuda._launch(True, 64, norm, x, x, tf32=1)
        eye = torch.eye(64 - d, dtype=u.dtype, device=u.device)
        assert torch.equal(u[:, d:, d:], eye.expand_as(u[:, d:, d:]))
        assert not bool(u[:, :d, d:].any() or u[:, d:, :d].any())
        assert not bool(dl[:, d:].any() or dl[:, :, d:].any())


# chip_smoke.py MODE_RTOL: the mode's resident kernels against their plain
# versions in the mode (relative to the plain result's largest magnitude).
MODE_RTOL = 1.5e-5


def _mode_forward_case(entry, gen, target_norm, dev):
    """(kernel wrapper, plain version, its inputs, the real steps of each
    chain or None) of one entry of the mode's forward form (FwdTC) at d =
    64: K1 on one segment chain or 133 (S = 1, 133), on 5 members x 41
    steps as the chain op's member rows, K5's forward on 3 chains, or K3 at
    padded 64 on a ragged batch of 37 at d = 16. The chains end in two
    zero (padded) steps."""
    from qoc_tpu_torch.ops import chain, expm_cuda
    dp = chain.KERNEL_DP
    if entry == "K3":
        a = _member_planes(gen, 1, 37, 16, target_norm, dev)[0]
        return expm_cuda.expm_fwd, expm_cuda.expm_fwd_plain, (a,), None
    if entry == "K5":
        a = _member_planes(gen, 3, 23, dp, target_norm, dev)
        a[:, -2:] = 0
        return (chain.plane_fwd, chain.plane_fwd_plain,
                (a, chain._plane_norm_max(a)[0]), 21)
    n_b = 5
    h = torch.randn((n_b, dp, dp), dtype=torch.complex64, device=dev,
                    generator=gen)
    basis = -0.5j * (h + h.mH)
    if entry == "K1 members":
        n_members, n_steps = 5, 41
        s_count, length = chain.segment_plan(n_steps, n_members)
        w = torch.zeros((n_members, s_count * length, n_b), device=dev)
        w[:, :n_steps - 2] = torch.randn((n_members, n_steps - 2, n_b),
                                         device=dev, generator=gen)
        w = w.reshape(n_members * s_count, length, n_b)
        real = None
    else:
        s_count, length = (1, 29) if entry == "K1 S=1" else (133, 7)
        w = torch.randn((s_count, length, n_b), device=dev, generator=gen)
        w[:, -2:] = 0
        real = length - 2
    a = torch.einsum("slk,kab->slab", w.to(torch.complex64), basis)
    basis = basis * (target_norm / a.abs().sum(-2).amax())
    basis_ri = torch.view_as_real(basis).reshape(n_b, -1)
    norm = chain._norm_max(w.reshape(-1, n_b), basis_ri, dp)[0]
    return chain.chain_fwd, chain.chain_fwd_plain, (w, basis, norm), real


@pytest.mark.parametrize("entry", ("K1 S=1", "K1 S=133", "K1 members", "K5",
                                   "K3"))
@pytest.mark.parametrize("target_norm", tuple(_LEVEL_NORMS))
def test_mode_forward_form_matches_plain_versions(cuda_device, bf16_3x,
                                                  entry, target_norm):
    """Every entry of the mode's forward form (FwdTC) against its plain
    version in the mode within MODE_RTOL on every ladder level, launched
    once in the mode's form and never in the exact one; padded steps
    leave the prefix exactly as it was, K3's padding is exact."""
    gen = torch.Generator(device=cuda_device).manual_seed(
        len(entry) + int(10 * target_norm))
    fwd, plain, args, real = _mode_forward_case(entry, gen, target_norm,
                                                cuda_device)
    before = (fwd.launches, fwd.mode_launches)
    got = fwd(*args)
    assert (fwd.launches - before[0], fwd.mode_launches - before[1]) == \
        (1, 1)
    want = plain(*args)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) < MODE_RTOL
    if real is not None:
        tail = got[:, real + 1:]
        assert torch.equal(tail, got[:, real:real + 1].expand_as(tail))
    if entry == "K1 members":
        # The member rows' padded steps: each member's last segment ends
        # in zero steps, so its last prefix is its last real one.
        rows = got.reshape(5, -1, *got.shape[1:])
        assert torch.equal(rows[:, -1, -1], rows[:, -1, -3])
    if entry == "K3":
        from qoc_tpu_torch.ops import expm_cuda
        x = expm_cuda._padded(args[0], 64)
        u = expm_cuda._launch(False, 64, expm_cuda._norm_max(x), x, tf32=1)
        eye = torch.eye(48, dtype=u.dtype, device=u.device)
        assert torch.equal(u[:, 16:, 16:], eye.expand_as(u[:, 16:, 16:]))
        assert not bool(u[:, :16, 16:].any() or u[:, 16:, :16].any())


def test_mode_grape_launches_mode_forms(cuda_device, bf16_3x):
    """A GRAPE in the mode launches K1 and K2 in their mode forms only."""
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
    before = _mode_counters(chain.chain_fwd, chain.chain_bwd)
    result = qoc_tpu_torch.grape_schroedinger_discrete(
        n_c, n, [qoc_tpu_torch.TargetStateInfidelity(target)], 1.0, ham,
        initial, n, iteration_count=4, log_iteration_step=0,
        device=cuda_device)
    after = _mode_counters(chain.chain_fwd, chain.chain_bwd)
    assert [(x[0] - y[0], x[1] - y[1]) for x, y in zip(after, before)] == \
        [(4, 4), (4, 4)]
    assert result.errors[-1] < result.errors[0]


def test_mode_refusals_on_the_card(cuda_device, bf16_3x):
    """In the mode, K3/K4 above padded 64 and K6's route, which raised
    NotImplementedError before the tiled kernels had their mode form, run
    on the card in it: each launches its mode form once."""
    from qoc_tpu_torch.ops import chain, expm_cuda
    from qoc_tpu_torch.ops.expm import expm
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for d, call, fn in ((65, expm, expm_cuda.expm_fwd),
                        (260, chain.plane_chain_propagate, chain.stream_fwd)):
        a = _member_planes(gen, 1, 2, d, 0.5, cuda_device)[0]
        before = (fn.launches, fn.mode_launches)
        out = call(a)
        torch.cuda.synchronize()
        assert (fn.launches - before[0], fn.mode_launches - before[1]) == \
            (1, 1)
        assert bool(torch.isfinite(torch.view_as_real(out)).all())


# The bf16_3x mode on the tiled kernels: K3/K4 at padded 128-256 and K6 at
# padded 320-512, against their plain versions in the mode within
# MODE_RTOL.
MODE_RTOL = 1.5e-5


@pytest.mark.parametrize("d", (100, 180, 256))
@pytest.mark.parametrize("target_norm", tuple(_LEVEL_NORMS))
def test_mode_tiled_expm_kernels_match_plain_versions(cuda_device, bf16_3x,
                                                      d, target_norm):
    """K3/K4's tiled path in the mode (padded 128, 192, 256) against their
    plain versions in the mode on every ladder level, launched in their
    mode forms; the padded rows and columns exact."""
    from qoc_tpu_torch.ops import chain, expm_cuda
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    a = _member_planes(gen, 1, 37, d, target_norm, cuda_device)[0]
    g = torch.randn(a.shape, dtype=torch.complex64, device=cuda_device,
                    generator=gen)
    before = _mode_counters(expm_cuda.expm_fwd, expm_cuda.expm_frechet_fwd)
    k3, k4 = expm_cuda.expm_fwd(a), expm_cuda.expm_frechet_fwd(a.mH, g)
    after = _mode_counters(expm_cuda.expm_fwd, expm_cuda.expm_frechet_fwd)
    assert [(x[0] - y[0], x[1] - y[1]) for x, y in zip(after, before)] == \
        [(1, 1), (1, 1)]
    p3 = expm_cuda.expm_fwd_plain(a)
    p4 = expm_cuda.expm_frechet_plain(a.mH, g)
    torch.cuda.synchronize()
    assert chain.ladder_level(expm_cuda._norm_max(a)) == \
        _LEVEL_NORMS[target_norm]
    assert float((k3 - p3).abs().max() / p3.abs().max()) < MODE_RTOL
    assert float((k4 - p4).abs().max() / p4.abs().max()) < MODE_RTOL
    dp = expm_cuda.kernel_dp(d)
    if d < dp:
        x = expm_cuda._padded(a, dp)
        norm = expm_cuda._norm_max(x)
        u = expm_cuda._launch(False, dp, norm, x, tf32=1)
        dl = expm_cuda._launch(True, dp, norm, x, x, tf32=1)
        eye = torch.eye(dp - d, dtype=u.dtype, device=u.device)
        assert torch.equal(u[:, d:, d:], eye.expand_as(u[:, d:, d:]))
        assert not bool(u[:, :d, d:].any() or u[:, d:, :d].any())
        assert not bool(dl[:, d:].any() or dl[:, :, d:].any())


@pytest.mark.parametrize("d,batch", ((128, 1), (128, 133), (192, 1),
                                     (192, 133), (250, 2)))
def test_mode_tiled_expm_ragged_batches(cuda_device, bf16_3x, d, batch):
    """K3/K4's tiled mode forms on ragged batches (one matrix, and 133: a
    round of the card's resident blocks and one more), at padded 128, 192
    (whose exact K4 has another panel shape) and 256, levels 2 and 4,
    against their plain versions in the mode; the mode forms launched and
    the exact ones not."""
    from qoc_tpu_torch.ops import expm_cuda
    gen = torch.Generator(device=cuda_device).manual_seed(d + batch)
    for target_norm in (1.0, 7.0):
        a = _member_planes(gen, 1, batch, d, target_norm, cuda_device)[0]
        g = torch.randn(a.shape, dtype=torch.complex64, device=cuda_device,
                        generator=gen)
        before = _mode_counters(expm_cuda.expm_fwd,
                                expm_cuda.expm_frechet_fwd)
        k3 = expm_cuda.expm_fwd(a)
        k4 = expm_cuda.expm_frechet_fwd(a.mH, g)
        after = _mode_counters(expm_cuda.expm_fwd,
                               expm_cuda.expm_frechet_fwd)
        assert [(x[0] - y[0], x[1] - y[1]) for x, y in zip(after, before)] \
            == [(1, 1), (1, 1)]
        p3 = expm_cuda.expm_fwd_plain(a)
        p4 = expm_cuda.expm_frechet_plain(a.mH, g)
        torch.cuda.synchronize()
        assert float((k3 - p3).abs().max() / p3.abs().max()) < MODE_RTOL
        assert float((k4 - p4).abs().max() / p4.abs().max()) < MODE_RTOL


@pytest.mark.parametrize("d,n_chains,n_steps", (
    (260, 1, 37), (330, 1, 9), (400, 1, 9), (512, 1, 9), (260, 3, 5),
    (400, 3, 5)))
@pytest.mark.parametrize("target_norm", tuple(_LEVEL_NORMS))
def test_mode_stream_kernels_match_plain_versions(cuda_device, bf16_3x, d,
                                                  n_chains, n_steps,
                                                  target_norm):
    """K6 in the mode (padded 320, 384, 448, 512) through the plane op's
    trajectory form, one chain and the member axis, against the plain
    versions in the mode on every ladder level and in both seed modes,
    launched in its mode forms; the padded rows and steps exact."""
    _check_mode_stream(cuda_device, d, n_chains, n_steps, target_norm)


@pytest.mark.parametrize("dp", (320, 384, 448, 512))
@pytest.mark.parametrize("n_chains,n_steps", ((1, 6), (2, 4)))
def test_mode_stream_band_widths(cuda_device, bf16_3x, dp, n_chains,
                                 n_steps):
    """K6's mode form at each row band its wgmma takes as N (dp / 8 = 40,
    48, 56, 64 rows), one chain and the member axis, both seed modes, at
    levels 1 and 4 (squarings), d a few rows short of dp: as
    test_mode_stream_kernels_match_plain_versions."""
    for target_norm in (0.3, 7.0):
        _check_mode_stream(cuda_device, dp - 3, n_chains, n_steps,
                           target_norm)


def _check_mode_stream(cuda_device, d, n_chains, n_steps, target_norm):
    """K6's mode forms through the plane op (n_chains chains of n_steps
    steps at d) against its plain version in the mode, totals, prefixes
    and both seed modes' gradients within MODE_RTOL; the mode forms
    launched and the exact ones not; padded rows and steps exact."""
    from qoc_tpu_torch.ops import chain
    gen = torch.Generator(device=cuda_device).manual_seed(
        d + n_chains + int(10 * target_norm))
    a = _member_planes(gen, n_chains, n_steps, d, target_norm, cuda_device)
    g_total = torch.randn((n_chains, d, d), dtype=torch.complex64,
                          device=cuda_device, generator=gen)
    g_pref = torch.randn((n_chains, n_steps, d, d), dtype=torch.complex64,
                         device=cuda_device, generator=gen)

    def run(plain):
        x = a.clone().requires_grad_(True)
        total, prefixes = chain.plane_chain_propagate_prefixes(x, plain)
        last, = torch.autograd.grad(total, x, g_total, retain_graph=True)
        step, = torch.autograd.grad((total, prefixes), x, (g_total, g_pref))
        return total.detach(), prefixes.detach(), last, step

    before = _mode_counters(chain.stream_fwd, chain.stream_bwd)
    got = run(False)
    after = _mode_counters(chain.stream_fwd, chain.stream_bwd)
    assert [(x[0] - y[0], x[1] - y[1]) for x, y in zip(after, before)] == \
        [(1, 1), (2, 2)]
    want = run(True)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert float((x - y).abs().max() / y.abs().max()) < MODE_RTOL
    dp = chain.kernel_dp(d)
    s_count, length = chain.stream_segment_plan(n_steps, n_chains)
    a_seg = torch.zeros((n_chains, s_count * length, dp, dp),
                        dtype=torch.complex64, device=cuda_device)
    a_seg[:, :n_steps, :d, :d] = a
    pref = chain.stream_fwd(a_seg.reshape(-1, length, dp, dp),
                            chain._plane_norm_max(a)[0])
    pref = pref.reshape(n_chains, s_count, length + 1, dp, dp)
    eye = torch.eye(dp - d, dtype=torch.complex64, device=cuda_device)
    assert torch.equal(pref[..., d:, d:], eye.expand_as(pref[..., d:, d:]))
    assert not bool(pref[..., :d, d:].any() or pref[..., d:, :d].any())
    last = n_steps - (s_count - 1) * length
    tail = pref[:, -1, last + 1:]
    assert torch.equal(tail, pref[:, -1, last:last + 1].expand_as(tail))


@pytest.mark.parametrize("d", (260, 400))
def test_mode_stream_backward_keeps_its_forward_mode(cuda_device,
                                                     monkeypatch, d):
    """K6's adjoint runs in its forward's precision mode whatever the
    switch says by the backward: a forward in the mode launches the mode's
    adjoint after the switch went back to highest, and the reverse."""
    from qoc_tpu_torch import config
    from qoc_tpu_torch.ops import chain
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    a = _member_planes(gen, 1, 4, d, 0.3, cuda_device)[0]
    for mode, other, tf32 in (("bf16_3x", "highest", 1),
                              ("highest", "bf16_3x", 0)):
        monkeypatch.setattr(config, "MXU_MODE", mode)
        x = a.clone().requires_grad_(True)
        total = chain.plane_chain_propagate(x)
        monkeypatch.setattr(config, "MXU_MODE", other)
        before = (chain.stream_bwd.launches, chain.stream_bwd.mode_launches)
        torch.autograd.grad(total.abs().sum(), x)
        assert (chain.stream_bwd.launches - before[0],
                chain.stream_bwd.mode_launches - before[1]) == (1, tf32)


@pytest.mark.parametrize("kernel", ("K2", "K5", "K4"))
@pytest.mark.parametrize("s_count", (1, 133))
@pytest.mark.parametrize("target_norm", (0.3, 1.0, 2.5, 7.0))
def test_mode_adjoint_form(cuda_device, bf16_3x, kernel, s_count,
                           target_norm):
    """The resident adjoints' bf16_3x form (K2, K5's adjoint, K4 at padded
    64: csrc/chain_common.cuh AdjointTC) on ladder levels 1-4 at
    d = 17, S = 1 and 133 segment chains of 5 steps (K4: 1 and 133
    matrices), both seed modes: within MODE_RTOL of the plain version in
    the mode, launched as the mode's (the mode counter moves, the exact one
    does not)."""
    from qoc_tpu_torch.ops import chain, expm_cuda
    rng = np.random.default_rng(int(100 * target_norm) + s_count)
    d, dp, length = 17, 64, 5
    if kernel == "K4":
        gen = torch.Generator(device=cuda_device).manual_seed(s_count)
        a = expm_cuda._padded(_member_planes(
            gen, 1, s_count, d, target_norm, cuda_device)[0], dp)
        g = expm_cuda._padded(torch.randn(
            (s_count, d, d), dtype=torch.complex64, device=cuda_device,
            generator=gen), dp)
        cases = (((a, g), None),)
        bwd, plain = expm_cuda.expm_frechet_fwd, expm_cuda.expm_frechet_plain
    else:
        bwd, plain, args = _resident_adjoint_inputs(
            kernel, rng, d, s_count, length, target_norm, cuda_device)
        cases = []
        for shape in ((s_count, d, d), (s_count, length, d, d)):
            seeds = torch.zeros(shape[:-2] + (dp, dp),
                                dtype=torch.complex64, device=cuda_device)
            seeds[..., :d, :d] = torch.as_tensor(
                (rng.normal(size=shape)
                 + 1j * rng.normal(size=shape)).astype(np.complex64),
                device=cuda_device)
            cases.append((args, seeds))
    for args, seeds in cases:
        full = args if seeds is None else args + (seeds,)
        before = (bwd.launches, bwd.mode_launches)
        got = bwd(*full)
        assert (bwd.launches - before[0],
                bwd.mode_launches - before[1]) == (1, 1)
        want = plain(*full)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()
                     / want.abs().max()) < MODE_RTOL


@pytest.mark.parametrize("target_norm", (0.3, 1.0, 2.5, 7.0))
def test_mode_adjoint_form_member_rows(cuda_device, bf16_3x, target_norm):
    """K2's bf16_3x form on the chain op's member rows (5 chains of 203
    steps, several segments a chain) through its trajectory form, both seed
    modes, levels 1-4: gradients within MODE_RTOL of the plain op in the
    mode, and every K2 launch the mode's."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(int(10 * target_norm) + 5)
    n_members, n_steps, d, n_b = 5, 203, 8, 5
    base = anti_hermitian_basis(rng, n_b, d)
    w = rng.normal(size=(n_members, n_steps, n_b)).astype(np.float32)
    norm = np.abs(np.einsum("mjk,kab->mjab", w, base)).sum(-1).max()
    basis = base * (target_norm / norm)
    g_total = torch.as_tensor(
        rng.normal(size=(n_members, d, d)).astype(np.complex64),
        device=cuda_device)
    g_pref = torch.as_tensor(
        rng.normal(size=(n_members, n_steps, d, d)).astype(np.complex64),
        device=cuda_device)
    wt = torch.as_tensor(w, device=cuda_device)

    def grads(plain):
        op = chain.ChainExpmPropagate(basis, cuda_device, torch.float32,
                                      plain=plain, return_prefixes=True)
        x = wt.clone().requires_grad_(True)
        total, prefixes = op(x)
        last, = torch.autograd.grad(total, x, g_total, retain_graph=True)
        step, = torch.autograd.grad((total, prefixes), x, (g_total, g_pref))
        return last, step

    before = (chain.chain_bwd.launches, chain.chain_bwd.mode_launches)
    got = grads(False)
    assert (chain.chain_bwd.launches - before[0],
            chain.chain_bwd.mode_launches - before[1]) == (2, 2)
    want = grads(True)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert float((x - y).abs().max() / y.abs().max()) < MODE_RTOL


def _lbfgs_headline_loss(dev, plain):
    """(loss of the flat real controls, their initial values) of the
    headline's Hamiltonian (chip_smoke.bench_problem: d = 64, 10 complex
    controls, seed 0) at 64 steps of the headline's dt, whose chain op runs
    K1/K2 or, with ``plain``, their plain versions."""
    from qoc_tpu_torch.core.common import (slap_controls_torch,
                                           strip_controls_torch)
    from qoc_tpu_torch.core.schroedinger import fused_weights
    from qoc_tpu_torch.ops.chain import ChainExpmPropagate
    n_steps = 64
    pstate, ham, costs = _chip_smoke().bench_problem(
        64, 10, n_steps + 1, n_steps + 1, 0.01 * n_steps)
    dt = float(pstate.dt)
    op = ChainExpmPropagate(ham.generator_basis(dt), dev, torch.float32,
                            plain=plain)
    times = torch.arange(n_steps, dtype=torch.float32, device=dev) * dt
    cet = torch.as_tensor(pstate.control_eval_times, dtype=torch.float32,
                          device=dev)
    initial = torch.as_tensor(pstate.initial_states, dtype=torch.complex64,
                              device=dev)

    def loss(flat):
        controls = slap_controls_torch(True, flat, pstate.controls_shape)
        states = op(fused_weights(controls, times, cet, dt)) @ initial
        return costs[0].cost(controls, states, n_steps)

    x0 = strip_controls_torch(True, torch.as_tensor(
        pstate.initial_controls, dtype=torch.complex64, device=dev))
    return loss, x0


@pytest.mark.parametrize("mode", ("highest", "bf16_3x"))
def test_lbfgs_update_launches_and_matches_plain_versions(cuda_device,
                                                          monkeypatch,
                                                          mode):
    """The device L-BFGS's first update on the headline's Hamiltonian at 64
    steps: the loss and gradient and the line search's ls_steps + 1 forward
    losses launch K1 ls_steps + 2 times and K2 once (in the mode, every
    launch in the mode's forms); the new parameters agree with the same
    update on a loss whose chain op runs its plain versions, within 1e-5
    exact and MODE_RTOL in the mode (relative to the largest parameter)."""
    from qoc_tpu_torch import LBFGS, config
    from qoc_tpu_torch.ops import chain
    monkeypatch.setattr(config, "MXU_MODE", mode)
    optimizer = LBFGS()

    def first_update(plain):
        loss, x0 = _lbfgs_headline_loss(cuda_device, plain)
        flat = x0.clone().requires_grad_(True)
        error = loss(flat)
        grads, = torch.autograd.grad(error, flat)
        _, params = optimizer.update(optimizer.init_state(x0), grads, x0,
                                     error.detach(), loss)
        return params

    counters = (chain.chain_fwd, chain.chain_bwd)
    before = _mode_counters(*counters)
    got = first_update(False)
    after = _mode_counters(*counters)
    want = first_update(True)
    torch.cuda.synchronize()
    k1 = optimizer.ls_steps + 2
    in_mode = (k1, 1) if mode == "bf16_3x" else (0, 0)
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)] == \
        [(k1, in_mode[0]), (1, in_mode[1])]
    rtol = MODE_RTOL if mode == "bf16_3x" else 1e-5
    assert float((got - want).abs().max() / want.abs().max()) < rtol
