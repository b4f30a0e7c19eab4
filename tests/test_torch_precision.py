"""The bf16_3x precision mode of the port (``config.MXU_MODE``), on the CPU.

The mode is ``qoc_tpu``'s opt-in ``QOC_TPU_MXU_PRECISION=bf16_3x``. In the
port every float32 product of the propagation is the 3-pass split
x_hi y_hi + x_hi y_lo + x_lo y_hi of TF32 operands (the kernels run it on
the tensor cores) and degree 12 is the 4-product scheme ``_D12A``; here
their plain versions run on the CPU in float32. The oracles are
``qoc_tpu``'s float64 functions (its XLA paths, no interpret-mode Pallas),
``scipy.linalg.expm`` and float64 products.

Tolerances: a 3-pass TF32 product carries about 2^-21 relative (tested
against 2^-19 here, one pass against 2^-12); through the ladder and the
chains the mode stays within 1e-5 (totals, exps) and 1e-4 (gradients) of
float64, where ``qoc_tpu``'s own bf16_3x ceiling is 1e-3 and 5e-3.
"""

import importlib

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import (LindbladProblem, Problem, anti_hermitian_basis,
                          f32_exact)

torch.set_num_threads(1)

MODE_FWD_RTOL = 1e-5
MODE_GRAD_RTOL = 1e-4
# Batch-max 1-norms on each ladder level: degree 4, 8, 12 (_D12A in the
# mode), 19 and scaling and squaring.
LEVEL_NORMS = ((0, 0.03), (1, 0.3), (2, 1.0), (3, 2.5), (4, 7.0))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture()
def bf16_3x(monkeypatch):
    """The port's switch set to the mode for one test (restored after)."""
    from qoc_tpu_torch import config
    monkeypatch.setattr(config, "MXU_MODE", "bf16_3x")


def test_switch_values_and_validation(monkeypatch):
    from qoc_tpu_torch import config
    assert config.MXU_MODES == ("highest", "bf16_3x")
    try:
        monkeypatch.setenv("QOC_TPU_MXU_PRECISION", "BF16_3x")
        assert importlib.reload(config).MXU_MODE == "bf16_3x"
        monkeypatch.delenv("QOC_TPU_MXU_PRECISION")
        assert importlib.reload(config).MXU_MODE == "highest"
        monkeypatch.setenv("QOC_TPU_MXU_PRECISION", "bf16")
        with pytest.raises(ValueError, match="QOC_TPU_MXU_PRECISION"):
            importlib.reload(config)
    finally:
        monkeypatch.delenv("QOC_TPU_MXU_PRECISION", raising=False)
        importlib.reload(config)
    assert config.MXU_MODE == "highest"
    assert config.mxu_mode(torch.float32) == "highest"
    monkeypatch.setattr(config, "MXU_MODE", "bf16_3x")
    assert config.mxu_mode(torch.float32) == "bf16_3x"
    assert config.mxu_mode(torch.complex64) == "bf16_3x"
    # Float64 ignores the mode, as qoc_tpu's _mul does.
    assert config.mxu_mode(torch.float64) == "highest"
    assert config.mxu_mode(torch.complex128, "bf16_3x") == "highest"
    assert config.mxu_mode(torch.float32, "highest") == "highest"
    with pytest.raises(ValueError, match="bf16_3x"):
        config.mxu_mode(torch.float32, "tf32")


def _bits(*patterns):
    return torch.from_numpy(np.array(patterns, dtype=np.uint32).view(
        np.float32).copy())


def _as_bits(x):
    return [int(v) for v in x.numpy().view(np.uint32)]


def test_split_tf32_rounds_to_nearest_ties_away():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (cvt.rna.tf32.f32); lo = tf32(x - hi)."""
    from qoc_tpu_torch.ops.chain import _split_tf32
    x = _bits(
        0x3F800000,   # 1.0: exact
        0x3F801000,   # 1 + 2^-11: a tie, away from zero to 1 + 2^-10
        0x3F800FFF,   # just below the tie: down to 1
        0xBF801000,   # -(1 + 2^-11): a tie, away from zero
        0x3F803000,   # 1 + 3 2^-11: a tie, up to 1 + 2^-9
        0x00000000,   # +0
        0x80000000,   # -0
        0x7F800000,   # +inf
        0xFF800000,   # -inf
        0x3F801001)   # above the tie: up
    hi, lo = _split_tf32(x)
    assert _as_bits(hi) == [0x3F800000, 0x3F802000, 0x3F800000, 0xBF802000,
                            0x3F804000, 0x00000000, 0x80000000, 0x7F800000,
                            0xFF800000, 0x3F802000]
    # Every hi has its 13 low bits clear, and so has every finite lo.
    assert all(b & 0x1FFF == 0 for b in _as_bits(hi))
    assert all(b & 0x1FFF == 0 for b, v in zip(_as_bits(lo), lo)
               if torch.isfinite(v))
    assert lo[0] == 0 and lo[1] == -2.0 ** -11 and lo[3] == 2.0 ** -11
    # Below the tie the remainder is 2^-11 - 2^-23, rounded to 2^-11.
    assert lo[2] == 2.0 ** -11
    assert torch.isnan(lo[7]) and torch.isnan(lo[8])
    # hi + lo carries 22 bits: x itself here, where the remainder fits.
    assert float(hi[1] + lo[1]) == float(x[1])
    # Complex: real and imaginary planes split alone.
    z = torch.complex(x[:5], x[5:]).to(torch.complex64)
    zh, zl = _split_tf32(z)
    assert torch.equal(torch.view_as_real(zh)[:, 0], hi[:5])
    assert torch.equal(torch.view_as_real(zh)[:, 1], hi[5:])


@pytest.mark.parametrize("complex_", (False, True))
def test_three_pass_product_accuracy(complex_):
    """The 3-pass product is within 2^-19 of float64 (relative to
    |X| |Y|, element by element); one TF32 pass is worse than 2^-12."""
    from qoc_tpu_torch.ops.chain import _matmul_3x, _split_tf32
    rng = np.random.default_rng(3)
    shape = (4, 8, 8)
    x, y = rng.normal(size=shape), rng.normal(size=shape)
    if complex_:
        x = x + 1j * rng.normal(size=shape)
        y = y + 1j * rng.normal(size=shape)
    dtype = torch.complex64 if complex_ else torch.float32
    xt, yt = torch.as_tensor(x).to(dtype), torch.as_tensor(y).to(dtype)
    want = xt.to(torch.complex128 if complex_ else torch.float64)
    want = (want @ yt.to(want.dtype)).numpy()
    scale = (np.abs(xt.numpy()).astype(np.float64)
             @ np.abs(yt.numpy()).astype(np.float64))
    got = _matmul_3x(xt, yt).numpy()
    assert np.max(np.abs(got - want) / scale) < 2.0 ** -19
    one_pass = (_split_tf32(xt)[0] @ _split_tf32(yt)[0]).numpy()
    assert np.max(np.abs(one_pass - want) / scale) > 2.0 ** -12


@pytest.fixture()
def exact_jax_dot(monkeypatch):
    """qoc_tpu's kernel-body product in float64 (its _dot asks for a float32
    result), so its _D12A functions run exact at float64."""
    import qoc_tpu.ops.expm_pallas as ep
    monkeypatch.setattr(ep, "_dot", lambda x, y: jnp.matmul(
        x, y, precision=jax.lax.Precision.HIGHEST))
    return ep


@pytest.mark.parametrize("norm", (0.5, 1.2))
def test_d12a_matches_qoc_tpu_and_taylor12(exact_jax_dot, norm):
    """The port's _D12A (value and dual form) against qoc_tpu's
    _taylor12_fast_m / _taylor12_fast_dual, called directly (1e-12), and
    against Paterson-Stockmeyer Taylor-12 in float64: 1e-8, because the
    scheme's coefficients carry 9 significant digits (qoc_tpu's own), which
    leaves about 6e-9 in every Taylor coefficient, the constant one too,
    far below float32's rounding."""
    from qoc_tpu_torch.ops.chain import _Dual, _taylor12, _taylor12_4
    ep = exact_jax_dot
    rng = np.random.default_rng(12)
    d = 6
    m = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    m *= norm / np.abs(m).sum(0).max()
    dm = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    eye = np.eye(d)
    want = np.asarray(ep._taylor12_fast_m(jnp.asarray(m), jnp.asarray(eye)))
    want_v, want_t = (np.asarray(x) for x in ep._taylor12_fast_dual(
        (jnp.asarray(m), jnp.asarray(dm)), jnp.asarray(eye)))
    mt, dmt = torch.as_tensor(m), torch.as_tensor(dm)
    eyet = torch.eye(d, dtype=torch.complex128)
    got = _taylor12_4(mt, eyet).numpy()
    dual = _taylor12_4(_Dual(mt, dmt), eyet)
    assert _rel(got, want) < 1e-12
    assert _rel(dual.v.numpy(), want_v) < 1e-12
    assert _rel(dual.dv.numpy(), want_t) < 1e-12
    ps = _taylor12(_Dual(mt, dmt), eyet)
    assert _rel(got, ps.v.numpy()) < 1e-8
    assert _rel(dual.dv.numpy(), ps.dv.numpy()) < 1e-8


def _mode_expm_case(level, norm):
    rng = np.random.default_rng(40 + level)
    d = 8
    a = anti_hermitian_basis(rng, 3, d) + 0.3 * rng.normal(size=(3, d, d))
    return (a * (norm / np.abs(a).sum(-2).max())).astype(np.complex64)


@pytest.fixture(scope="module")
def jax_mode_expm():
    """qoc_tpu's XLA expm_taylor under _MXU_MODE = "bf16_3x" on every level's
    input, traced once for all of them (the mode is read at trace time)."""
    import qoc_tpu.ops.expm_pallas as ep
    from qoc_tpu.ops.expm import expm_taylor as jax_expm_taylor
    old = ep._MXU_MODE
    jax.clear_caches()
    ep._MXU_MODE = "bf16_3x"
    try:
        return {level: np.asarray(jax_expm_taylor(jnp.asarray(
            _mode_expm_case(level, norm)))) for level, norm in LEVEL_NORMS}
    finally:
        ep._MXU_MODE = old
        jax.clear_caches()


@pytest.mark.parametrize("level,norm", LEVEL_NORMS)
def test_mode_expm_matches_qoc_tpu_xla_mode(jax_mode_expm, bf16_3x, level,
                                            norm):
    """The port's expm (K3's plain version, d = 8) in the mode and complex64
    against qoc_tpu's XLA expm_taylor under _MXU_MODE = "bf16_3x", both
    within their mode's envelope of scipy.linalg.expm: 1e-5 for the port's
    3 x TF32, 1e-3 for the JAX package's 3 x bf16."""
    from qoc_tpu_torch.ops import expm_cuda
    from qoc_tpu_torch.ops.chain import ladder_level
    from qoc_tpu_torch.ops.expm import expm
    a = _mode_expm_case(level, norm)
    want = np.stack([scipy.linalg.expm(x.astype(np.complex128)) for x in a])
    at = torch.as_tensor(a)
    assert ladder_level(expm_cuda._norm_max(at)) == level
    got = expm(at).numpy()
    assert _rel(got, want) < MODE_FWD_RTOL
    # The exact-f32 ladder differs from the mode, and the mode's plain
    # version is what expm ran.
    assert np.array_equal(got, expm_cuda.expm_fwd_plain(at).numpy())
    exact = expm_cuda.expm_fwd_plain(at, "highest").numpy()
    assert _rel(exact, want) < MODE_FWD_RTOL
    jax_got = jax_mode_expm[level]
    assert jax_got.dtype == np.complex64
    assert _rel(jax_got, want) < 1e-3
    assert _rel(got, jax_got) < 1e-3


def _mode_frechet_case(level, norm):
    rng = np.random.default_rng(60 + level)
    d = 5
    b = rng.normal(size=(2, d, d)) + 1j * rng.normal(size=(2, d, d))
    b = (b * (norm / np.abs(b).sum(-2).max())).astype(np.complex64)
    g = (rng.normal(size=(2, d, d))
         + 1j * rng.normal(size=(2, d, d))).astype(np.complex64)
    return b, g


@pytest.mark.parametrize("level,norm", LEVEL_NORMS)
def test_mode_frechet_matches_float64(bf16_3x, level, norm):
    """K4's plain version in the mode (dual _D12A at level 2) against the
    float64 Fréchet derivative by the block identity of scipy's expm."""
    from qoc_tpu_torch.ops.expm_cuda import expm_frechet_plain
    b, g = _mode_frechet_case(level, norm)
    d = b.shape[-1]
    want = []
    for bb, gg in zip(b.astype(np.complex128), g.astype(np.complex128)):
        block = np.block([[bb, gg], [np.zeros_like(bb), bb]])
        want.append(scipy.linalg.expm(block)[:d, d:])
    got = expm_frechet_plain(torch.as_tensor(b), torch.as_tensor(g))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), np.stack(want)) < MODE_GRAD_RTOL


@jax.jit
def _jax_chain(w, basis, ct_total, ct_pref):
    """qoc_tpu's reference chain (float64) and the weight gradient, by
    jax.vjp, for PyTorch-convention gradients of the total alone
    (ct_pref None) or of the total and every prefix."""
    from qoc_tpu.ops.chain_pallas import chain_expm_propagate_reference
    prefixes = ct_pref is not None
    out, vjp = jax.vjp(lambda x: chain_expm_propagate_reference(
        x, basis, return_prefixes=prefixes), w)
    cts = ((jnp.conjugate(ct_total), jnp.conjugate(ct_pref)) if prefixes
           else jnp.conjugate(ct_total))
    return out, vjp(cts)[0]


def _mode_chain_case(level, norm, per_step):
    rng = np.random.default_rng(70 + level)
    d, n_steps, n_b = 4, 16, 3
    base = anti_hermitian_basis(rng, n_b, d)
    w = f32_exact(rng.normal(size=(n_steps, n_b)))
    basis = base * (norm / np.abs(np.einsum("jk,kab->jab", w,
                                            base)).sum(-2).max())
    basis = basis.astype(np.complex64).astype(np.complex128)
    ct_total = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    ct_pref = (rng.normal(size=(n_steps, d, d))
               + 1j * rng.normal(size=(n_steps, d, d))) if per_step else None
    out, grad = _jax_chain(jnp.asarray(w), jnp.asarray(basis),
                           jnp.asarray(ct_total),
                           None if ct_pref is None else jnp.asarray(ct_pref))
    out = [np.asarray(x) for x in (out if per_step else (out,))]
    return w, basis, [ct_total] + ([ct_pref] if per_step else []), out, \
        np.asarray(grad)


@pytest.mark.parametrize("op", ("chain", "plane"))
@pytest.mark.parametrize("per_step", (False, True))
@pytest.mark.parametrize("level,norm", LEVEL_NORMS)
def test_mode_chain_ops_match_qoc_tpu(bf16_3x, op, per_step, level, norm):
    """ChainExpmPropagate (K1/K2's plain versions) and PlaneChainPropagate
    (K5's) in the mode, float32 on the CPU, on every ladder level, with the
    gradient of the total alone (last-step seeds) and of every prefix too
    (per-step seeds), against qoc_tpu's float64 reference chain."""
    from qoc_tpu_torch.ops.chain import (ChainExpmPropagate, _norm_max,
                                         ladder_level, plane_chain_propagate)
    w, basis, cts, want, g_want = _mode_chain_case(level, norm, per_step)
    d = basis.shape[-1]
    if op == "chain":
        port = ChainExpmPropagate(basis, "cpu", torch.float32,
                                  return_prefixes=per_step)
        assert ladder_level(_norm_max(torch.as_tensor(w, dtype=torch.float32),
                                      port.basis_ri, d)[0]) == level
    else:
        g = torch.as_tensor(basis, dtype=torch.complex64).reshape(-1, d * d)

        def port(wt):
            return plane_chain_propagate((wt.to(g.dtype) @ g).reshape(
                -1, d, d), False, per_step)
    wt = torch.tensor(w, dtype=torch.float32, requires_grad=True)
    out = port(wt)
    out = out if per_step else (out,)
    assert all(x.dtype == torch.complex64 for x in out)
    g_got, = torch.autograd.grad(out, wt, [
        torch.as_tensor(c, dtype=torch.complex64) for c in cts])
    for got, ref in zip(out, want):
        assert _rel(got.detach().numpy(), ref) < MODE_FWD_RTOL
    assert _rel(g_got.numpy(), g_want) < MODE_GRAD_RTOL


def test_mode_runs_the_mode_and_backward_keeps_its_forward_mode(monkeypatch):
    """The op reads the switch at call time: float32 results differ between
    the modes (the products differ), float64 results do not; a backward
    runs in its forward's mode whatever the switch says by then."""
    from qoc_tpu_torch import config
    from qoc_tpu_torch.ops.chain import ChainExpmPropagate
    w, basis, cts, _, _ = _mode_chain_case(2, 1.0, False)
    results = {}
    for dtype in (torch.float32, torch.float64):
        op = ChainExpmPropagate(basis, "cpu", dtype)
        for mode in ("highest", "bf16_3x"):
            monkeypatch.setattr(config, "MXU_MODE", mode)
            wt = torch.tensor(w, dtype=dtype, requires_grad=True)
            total = op(wt)
            # Flip the switch between forward and backward.
            monkeypatch.setattr(config, "MXU_MODE", "highest" if mode ==
                                "bf16_3x" else "bf16_3x")
            grad, = torch.autograd.grad(
                total, wt, torch.as_tensor(cts[0]).to(total.dtype))
            results[dtype, mode] = (total.detach(), grad)
    for mode in ("highest", "bf16_3x"):
        monkeypatch.setattr(config, "MXU_MODE", mode)
        op = ChainExpmPropagate(basis, "cpu", torch.float32)
        wt = torch.tensor(w, dtype=torch.float32, requires_grad=True)
        grad, = torch.autograd.grad(op(wt), wt, torch.as_tensor(
            cts[0]).to(torch.complex64))
        assert torch.equal(grad, results[torch.float32, mode][1])
    f32 = [results[torch.float32, m][0] for m in ("highest", "bf16_3x")]
    f64 = [results[torch.float64, m] for m in ("highest", "bf16_3x")]
    assert not torch.equal(*f32)
    assert torch.equal(f64[0][0], f64[1][0])
    assert torch.equal(f64[0][1], f64[1][1])


def test_mode_grape_matches_qoc_tpu(bf16_3x):
    """A 5-iteration Adam GRAPE at d = 4 through the fused route in the mode
    (float32 on the CPU: K1/K2's plain versions in the mode) against
    qoc_tpu's float64 run."""
    import qoc_tpu
    import qoc_tpu_torch
    problem = Problem()
    common = dict(complex_controls=True, iteration_count=5,
                  log_iteration_step=0)
    want = qoc_tpu.grape_schroedinger_discrete(
        problem.n_c, problem.n_steps, problem.jax_costs,
        problem.evolution_time, problem.jax_hamiltonian, problem.initial,
        problem.n_steps, initial_controls=problem.controls,
        max_control_norms=problem.max_control_norms, **common)
    got = qoc_tpu_torch.grape_schroedinger_discrete(
        problem.n_c, problem.n_steps, problem.torch_costs,
        problem.evolution_time, problem.torch_hamiltonian,
        problem.torch_initial, problem.n_steps,
        initial_controls=problem.torch_controls,
        max_control_norms=problem.torch_max_control_norms, device="cpu",
        dtype=torch.float32, **common)
    assert got.iteration_count_ran == want.iteration_count_ran == 5
    np.testing.assert_allclose(got.errors, want.errors, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-4)


def _planes(rng, d, n=1, norm=0.5):
    """n anti-Hermitian planes at d, each of 1-norm about ``norm``."""
    return anti_hermitian_basis(rng, n, d) * (norm / d)


def _expm64(a):
    return np.stack([scipy.linalg.expm(x) for x in a.reshape(
        -1, *a.shape[-2:])]).reshape(a.shape)


def _frechet64(b, g):
    d = b.shape[-1]
    return np.stack([scipy.linalg.expm(np.block([[x, y], [0 * x, x]]))[:d, d:]
                     for x, y in zip(b, g)])


def _chain64(a):
    """(prefixes, total) of exp(a_{B-1}) ... exp(a_0), float64."""
    p = np.eye(a.shape[-1])
    out = []
    for u in _expm64(a):
        p = u @ p
        out.append(p)
    return np.stack(out), p


def _mode_route_calls():
    """The routes whose kernels first had no bf16_3x form, each as the call
    that raised in the mode then, with its float64 oracle: K3/K4's tiled path
    (expm and K4's wrapper at d = 65, padded 128), expm_taylor on
    torch.matmul (qoc_tpu's _mul), and K6's route (the plane op and K6's
    wrapper at d = 260, padded 320)."""
    from qoc_tpu_torch.ops import chain, expm_cuda
    from qoc_tpu_torch.ops.expm import expm, expm_taylor
    rng = np.random.default_rng(5)
    a65, g65 = _planes(rng, 65, 2), _planes(rng, 65, 2)
    a8 = _planes(rng, 8, 3, norm=3.0)
    a260 = _planes(rng, 260, 2, norm=0.6)
    c64 = torch.complex64
    pref64 = _chain64(a260)[0]

    def k6_wrapper():
        seg = torch.as_tensor(a260).to(c64)[None]
        return chain.stream_fwd(seg, chain._plane_norm_max(seg)[0])[0, 1:]

    return {
        "expm padded 128": (lambda: expm(torch.as_tensor(a65).to(c64)),
                            lambda: _expm64(a65)),
        "K4 wrapper padded 128": (
            lambda: expm_cuda.expm_frechet_fwd(torch.as_tensor(a65).to(c64),
                                               torch.as_tensor(g65).to(c64)),
            lambda: _frechet64(a65, g65)),
        "expm_taylor": (lambda: expm_taylor(torch.as_tensor(a8).to(c64)),
                        lambda: _expm64(a8)),
        "plane op padded 320": (
            lambda: chain.plane_chain_propagate(torch.as_tensor(a260).to(c64)),
            lambda: pref64[-1]),
        "K6 wrapper": (k6_wrapper, lambda: pref64),
    }


@pytest.mark.parametrize("case", sorted(_mode_route_calls()))
def test_routes_without_the_mode_refuse_it(bf16_3x, case):
    """The calls that raised NotImplementedError in the mode before the
    tiled kernels had their mode form now run in it: complex64 work in the
    mode within MODE_FWD_RTOL of float64 (scipy's expm, the block identity
    for K4, an expm product for the chain), on the mode's plain versions
    (the products differ from the exact f32 ones)."""
    from qoc_tpu_torch import config
    call, oracle = _mode_route_calls()[case]
    got = call()
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), oracle()) < MODE_FWD_RTOL
    config.MXU_MODE = "highest"   # the fixture restores it
    assert not torch.equal(got, call())


def test_grape_refuses_the_mode_on_the_blocked_route(bf16_3x):
    """The entry point at d = 65 (the blocked route, K3/K4 at padded 128),
    which refused the mode before the tiled kernels had their mode form,
    runs in the mode in float32: its errors and controls within the mode's
    envelope of the float64 run."""
    import qoc_tpu_torch
    problem = Problem(d=65, n_c=1, n_steps=3)
    args = (problem.n_c, problem.n_steps, problem.torch_costs,
            problem.evolution_time, problem.torch_hamiltonian,
            problem.torch_initial, problem.n_steps)
    kwargs = dict(complex_controls=True, iteration_count=2,
                  log_iteration_step=0,
                  initial_controls=problem.torch_controls, device="cpu")
    got = qoc_tpu_torch.grape_schroedinger_discrete(
        *args, dtype=torch.float32, **kwargs)
    want = qoc_tpu_torch.grape_schroedinger_discrete(
        *args, dtype=torch.float64, **kwargs)
    assert got.iteration_count_ran == want.iteration_count_ran == 2
    np.testing.assert_allclose(got.errors, want.errors, rtol=0,
                               atol=MODE_FWD_RTOL)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=MODE_GRAD_RTOL)


def test_mode_squarings_on_d_form(bf16_3x):
    """Level 4 in the mode squares D = X - I (D' = 2 D + D D), masked per
    matrix: a batch with 0 and 6 squarings, exp and its Fréchet derivative
    (K3/K4's plain versions) within the mode's envelope of float64; the
    squarings' result differs from squaring X itself only by the order of
    the sums."""
    from qoc_tpu_torch.ops import expm_cuda
    from qoc_tpu_torch.ops.chain import (_matmul_3x, _squaring_count,
                                         _taylor19, ladder_level)
    rng = np.random.default_rng(44)
    d = 6
    a = anti_hermitian_basis(rng, 2, d) + 0.2 * rng.normal(size=(2, d, d))
    a = a * (np.array([0.5, 40.0]) / np.abs(a).sum(-2).max(-1))[:, None,
                                                                  None]
    g = rng.normal(size=(2, d, d)) + 1j * rng.normal(size=(2, d, d))
    at = torch.as_tensor(a).to(torch.complex64)
    gt = torch.as_tensor(g).to(torch.complex64)
    assert ladder_level(expm_cuda._norm_max(at)) == 4
    assert _squaring_count(at, 1.0).tolist() == [0, 6]
    got = expm_cuda.expm_fwd_plain(at)
    assert _rel(got.numpy(), _expm64(a)) < MODE_FWD_RTOL
    assert _rel(expm_cuda.expm_frechet_plain(at, gt).numpy(),
                _frechet64(a, g)) < MODE_GRAD_RTOL
    # Squaring X: the same exp to the mode's rounding, another sum.
    eye = torch.eye(d, dtype=torch.complex64)
    x = _taylor19(at[1] / 64, eye, _matmul_3x)
    for _ in range(6):
        x = _matmul_3x(x, x)
    assert _rel(got[1].numpy(), x.numpy()) < MODE_FWD_RTOL
    assert not torch.equal(got[1], x)


def test_mode_d12a_dual_on_the_tiled_sizes(bf16_3x):
    """K4's plain version in the mode at degree 12 (the dual _D12A) at
    d = 65 (padded 128): within the mode's envelope of the float64 Fréchet
    derivative, and of the dual Paterson-Stockmeyer Taylor-12 in the mode,
    which it replaces."""
    from qoc_tpu_torch.ops import expm_cuda
    from qoc_tpu_torch.ops.chain import (_Dual, _matmul_3x, _taylor12,
                                         ladder_level)
    rng = np.random.default_rng(12)
    d = 65
    b = anti_hermitian_basis(rng, 2, d) + 0.2 * rng.normal(size=(2, d, d))
    b = b * (1.0 / np.abs(b).sum(-2).max())
    g = rng.normal(size=(2, d, d)) + 1j * rng.normal(size=(2, d, d))
    bt = torch.as_tensor(b).to(torch.complex64)
    gt = torch.as_tensor(g).to(torch.complex64)
    assert ladder_level(expm_cuda._norm_max(bt)) == 2
    got = expm_cuda.expm_frechet_plain(bt, gt)
    assert _rel(got.numpy(), _frechet64(b, g)) < MODE_GRAD_RTOL
    ps = _taylor12(_Dual(bt, gt), torch.eye(d, dtype=torch.complex64),
                   _matmul_3x).dv
    assert _rel(got.numpy(), ps.numpy()) < MODE_GRAD_RTOL


def test_mode_lindblad_grape_on_the_k6_route_matches_qoc_tpu(bf16_3x,
                                                             capsys):
    """grape_lindblad_discrete at d = 17 (superoperator 289, padded 320:
    K6's route) in the mode, float32, 2 steps and 2 Adam iterations,
    against qoc_tpu's float64 run: errors, best controls and densities."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.models import LindbladMethod as JaxMethod
    from qoc_tpu_torch.models import LindbladMethod
    problem = LindbladProblem(d=17, n_steps=2, evolution_time=0.15)
    common = dict(complex_controls=True, iteration_count=2,
                  initial_controls=problem.controls,
                  max_control_norms=problem.max_control_norms)
    want = qoc_tpu.grape_lindblad_discrete(
        problem.n_c, problem.n_steps, problem.jax_costs,
        problem.evolution_time, problem.initial, problem.n_steps,
        hamiltonian=problem.jax_hamiltonian,
        lindblad_data=problem.jax_lindblad, method=JaxMethod.MAGNUS_EXPM,
        log_iteration_step=0, **common)
    got = qoc_tpu_torch.grape_lindblad_discrete(
        problem.n_c, problem.n_steps, problem.torch_costs,
        problem.evolution_time, problem.torch_initial, problem.n_steps,
        hamiltonian=problem.torch_hamiltonian,
        lindblad_data=problem.torch_lindblad,
        method=LindbladMethod.MAGNUS_EXPM, device="cpu", dtype=torch.float32,
        log_iteration_step=1, **common)
    assert "Lindblad propagation path = streamed chain" in \
        capsys.readouterr().out
    assert got.iteration_count_ran == 2
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=MODE_FWD_RTOL)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=MODE_GRAD_RTOL)
    np.testing.assert_allclose(got.best_final_densities,
                               np.asarray(want.best_final_densities),
                               rtol=0, atol=MODE_FWD_RTOL)


def test_mode_padded_steps_are_exact_at_padded_320(bf16_3x):
    """K6's plain versions in the mode at padded 320 (d = 260 zero-padded,
    as the card runs them): the padded rows and columns of every prefix
    exactly the identity's, the prefixes after the last real step bitwise
    the last real one (P + (U - I) P with U = I), and the adjoint's padded
    steps carrying T unchanged (zero gradient outside d, the same gradient
    on every padded step)."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(320)
    d, dp = 260, 320
    a = torch.zeros((1, 4, dp, dp), dtype=torch.complex64)
    a[0, :2, :d, :d] = torch.as_tensor(_planes(rng, d, 2, norm=0.02))
    norm = chain._plane_norm_max(a)[0]
    assert chain.ladder_level(norm) == 0
    pref = chain.stream_fwd(a, norm)
    eye = torch.eye(dp - d, dtype=torch.complex64)
    assert torch.equal(pref[..., d:, d:], eye.expand_as(pref[..., d:, d:]))
    assert not bool(pref[..., :d, d:].any() or pref[..., d:, :d].any())
    assert torch.equal(pref[0, 3:], pref[0, 2:3].expand_as(pref[0, 3:]))
    seeds = torch.zeros((1, dp, dp), dtype=torch.complex64)
    seeds[0, :d, :d] = torch.as_tensor(_planes(rng, d, 1)[0])
    grad = chain.stream_bwd(a, chain._plane_norm_max(a)[1], pref, seeds)
    assert not bool(grad[..., d:, :].any() or grad[..., :, d:].any())
    assert torch.equal(grad[0, 3], grad[0, 2])
    assert bool(grad[0, 1].abs().max() > 0)


@pytest.mark.parametrize("level", range(5))
def test_mode_identity_and_padded_steps_are_exact(bf16_3x, level):
    """In the mode exp(0) is I exactly on every ladder level (_D12A in its
    exact-identity form), and a chain step with U = I (a padded step, zero
    weights) leaves the prefix bitwise unchanged (P + (U - I) P), as the
    kernels' zero padding needs."""
    from qoc_tpu_torch.ops.chain import (_expm_ladder, chain_fwd_plain,
                                         plane_bwd_plain, plane_fwd_plain)
    eye = torch.eye(6, dtype=torch.complex64)
    zero = torch.zeros((3, 6, 6), dtype=torch.complex64)
    assert torch.equal(_expm_ladder(zero, level, "bf16_3x"),
                       eye.expand(3, 6, 6))
    rng = np.random.default_rng(level)
    n_b, d = 3, 6
    basis = torch.as_tensor(anti_hermitian_basis(rng, n_b, d)).to(
        torch.complex64)
    w = torch.zeros((2, 9, n_b))
    w[:, :5] = torch.as_tensor(rng.normal(size=(2, 5, n_b)) * 0.3)
    norm = torch.tensor([0.03, 0.3, 1.0, 2.5, 7.0][level])
    pref = chain_fwd_plain(w, basis, norm)
    assert torch.equal(pref[:, 6:], pref[:, 5:6].expand_as(pref[:, 6:]))
    a = torch.zeros((2, 9, d, d), dtype=torch.complex64)
    a[:, :5] = torch.einsum("stk,kab->stab", w[:, :5].to(torch.complex64),
                            basis)
    pref = plane_fwd_plain(a, norm)
    assert torch.equal(pref[:, 6:], pref[:, 5:6].expand_as(pref[:, 6:]))
    # The adjoint's T update over the padded steps: the last-step seed is
    # carried through U^H = I unchanged (T + (U^H - I) T), so every padded
    # step sees the same T and the same prefix, and the same gradient.
    seeds = torch.as_tensor(rng.normal(size=(2, d, d))).to(torch.complex64)
    grad = plane_bwd_plain(a, norm, pref, seeds)
    assert torch.equal(grad[:, 6:], grad[:, 5:6].expand_as(grad[:, 6:]))
    assert bool(grad[:, 5].abs().max() > 0)
