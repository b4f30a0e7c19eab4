"""The port's Schrödinger path against qoc_tpu (float64, CPU): the loss and
its gradient, a short Adam GRAPE trajectory, evolve, the refusals of what
is not ported yet, the default device, and a run with JAX made
unimportable (step costs and intermediate states:
tests/test_torch_stepcost.py).

Tolerances: relative 1e-6 on the loss and 1e-5 on the gradient (the port's
f32-calibrated Taylor ladder against JAX x64's f64 expm), 1e-6 on
per-iteration GRAPE errors, 1e-5 on the best controls, 1e-8 on evolved
states.
"""

import functools
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import Problem, not_a_grape_file, saved_errors

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """qoc_tpu's loss and control gradient of Problem(), once for the cases
    that share it."""
    from qoc_tpu.core.common import slap_controls_jax
    from qoc_tpu.core.schroedinger import (
        build_schroedinger_loss as jax_build_loss)
    from qoc_tpu_torch.core.common import strip_controls
    problem = Problem()
    shape = (problem.n_steps, problem.n_c)
    jax_loss = jax_build_loss(problem.jax_pstate())
    (want, _), g_want = jax.jit(jax.value_and_grad(
        lambda f: jax_loss(slap_controls_jax(True, f, shape)),
        has_aux=True))(jnp.asarray(strip_controls(True, problem.controls)))
    return float(want), np.asarray(g_want)


@pytest.mark.parametrize("time_block_size", (None, 7))
def test_loss_and_gradient_match_jax(time_block_size):
    """One time block, and four blocks of 7 steps (the last one short),
    against one qoc_tpu reference."""
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss

    problem = Problem()
    shape = (problem.n_steps, problem.n_c)
    flat = strip_controls(True, problem.controls)
    want, g_want = _jax_reference()

    loss = build_schroedinger_loss(problem.torch_pstate(),
                                   torch.device("cpu"), torch.float64,
                                   time_block_size=time_block_size)
    flat_t = torch.tensor(flat, requires_grad=True)
    got, _ = loss(slap_controls_torch(True, flat_t, shape))
    g_got, = torch.autograd.grad(got, flat_t)
    assert float(got.detach()) == pytest.approx(want, rel=1e-6)
    assert np.abs(g_got.numpy() - g_want).max() / np.abs(g_want).max() \
        < 1e-5


def _grape_both(problem, iterations, min_error):
    import qoc_tpu
    import qoc_tpu_torch

    common = dict(complex_controls=True, iteration_count=iterations,
                  log_iteration_step=0, min_error=min_error)
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
        max_control_norms=problem.torch_max_control_norms,
        device="cpu", dtype=torch.float64, **common)
    return want, got


@pytest.mark.parametrize("max_norm,stop_at", ((10.0, None), (0.35, 2)))
def test_grape_trajectory_matches_jax(max_norm, stop_at):
    """5 Adam iterations: per-iteration errors, the best iterate and the
    run length agree. The second case runs against the control-norm clip
    and stops at iteration ``stop_at`` on ``min_error``."""
    from qoc_tpu_torch.core.common import clip_control_norms
    problem = Problem(max_norm=max_norm)
    # Start on the norm bound where the draw exceeds it, so the updates
    # push controls out and the clip projection is exercised.
    problem.controls = clip_control_norms(problem.controls,
                                          problem.max_control_norms)
    problem.torch_controls = problem.controls
    min_error = 0.0
    if stop_at is not None:
        _, probe = _grape_both(problem, 5, 0.0)
        min_error = 0.5 * (probe.errors[stop_at - 1] + probe.errors[stop_at])
    want, got = _grape_both(problem, 5, min_error)
    expected_ran = 5 if stop_at is None else stop_at + 1
    assert got.iteration_count_ran == want.iteration_count_ran == expected_ran
    np.testing.assert_allclose(got.errors, want.errors, rtol=0, atol=1e-6)
    assert got.best_iteration == want.best_iteration
    assert got.best_error == pytest.approx(want.best_error, abs=1e-6)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.best_final_states,
                               np.asarray(want.best_final_states), rtol=0,
                               atol=1e-6)
    assert np.all(np.abs(got.best_controls) <= max_norm + 1e-12)


@pytest.mark.parametrize("with_controls", (True, False))
def test_evolve_matches_jax(with_controls):
    import qoc_tpu
    import qoc_tpu_torch

    problem = Problem(n_steps=40)
    controls = problem.controls if with_controls else None
    want = qoc_tpu.evolve_schroedinger_discrete(
        problem.evolution_time, problem.jax_hamiltonian, problem.initial,
        problem.n_steps, controls=controls, costs=problem.jax_costs)
    got = qoc_tpu_torch.evolve_schroedinger_discrete(
        problem.evolution_time, problem.torch_hamiltonian,
        problem.torch_initial, problem.n_steps, controls=controls,
        costs=problem.torch_costs, device="cpu")
    np.testing.assert_allclose(got.final_states,
                               np.asarray(want.final_states), rtol=0,
                               atol=1e-8)
    assert got.error == pytest.approx(want.error, abs=1e-8)


def _refusals(directory):
    """case: (kwargs, what it does now): the exception it raises, or None
    for a run whose save rows (a save file) are checked."""
    return {
        "save_file_path": (dict(save_file_path=str(directory / "run.h5"),
                                save_iteration_step=1), None),
        "save_iteration_step": (dict(save_iteration_step=5), None),
        "resume_from": (dict(resume_from=not_a_grape_file(directory)),
                        (ValueError, "not a GRAPE save file")),
        "mesh": (dict(mesh=object()), (NotImplementedError, "slice")),
    }


@pytest.mark.parametrize("case", ("mesh", "resume_from", "save_file_path",
                                  "save_iteration_step"))
def test_unported_features_raise_not_implemented(case, tmp_path):
    """``mesh`` is not ported (ROADMAP Queue 1 item 8); save files and
    resume are: a save file gets its rows, save_iteration_step without
    one saves nothing, and a resume_from without GRAPE rows is refused as
    in qoc_tpu."""
    import qoc_tpu_torch

    problem = Problem()
    kwargs, raises = _refusals(tmp_path)[case]

    def run():
        return qoc_tpu_torch.grape_schroedinger_discrete(
            problem.n_c, problem.n_steps, problem.torch_costs,
            problem.evolution_time, problem.torch_hamiltonian,
            problem.torch_initial, problem.n_steps, complex_controls=True,
            iteration_count=1, log_iteration_step=0, device="cpu", **kwargs)

    if raises is not None:
        with pytest.raises(raises[0], match=raises[1]):
            run()
        return
    result = run()
    if "save_file_path" in kwargs:
        np.testing.assert_array_equal(saved_errors(kwargs["save_file_path"]),
                                      result.errors)
    else:
        assert result.iteration_count_ran == 1
        assert not (tmp_path / "run.h5").exists()


def test_default_device_needs_cuda(monkeypatch):
    """device=None is the card; without one the call raises and names the
    CPU option instead of running there."""
    from qoc_tpu_torch.config import resolve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve()
    assert resolve("cpu") == (torch.device("cpu"), torch.float64)


def test_grape_runs_without_jax():
    """With ``jax``, ``h5py`` and ``filelock`` made unimportable, the port
    imports and runs a 3-iteration GRAPE on the fused route, one with an M4
    torch callable on the plane route and, through
    ``qoc_tpu_torch.parallel``, a robust multistart: none is a dependency
    of it."""
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "h5py", "filelock"):
            sys.modules[name] = None
        import numpy as np
        import torch
        import qoc_tpu_torch
        d, n_c, n = 3, 1, 12
        rng = np.random.default_rng(0)
        h0 = rng.normal(size=(d, d)); h0 = h0 + h0.T
        ham = qoc_tpu_torch.LinearHamiltonian(h0, 0.5 * np.ones((n_c, d, d)))
        initial = np.zeros((1, d, 1)); initial[0, 0] = 1
        target = np.zeros((1, d, 1)); target[0, -1] = 1
        costs = [qoc_tpu_torch.TargetStateInfidelity(target)]
        result = qoc_tpu_torch.grape_schroedinger_discrete(
            n_c, n, costs, 1.0, ham, initial, n, iteration_count=3,
            log_iteration_step=1, device="cpu")
        assert result.iteration_count_ran == 3
        assert np.all(np.isfinite(result.errors))
        h0_t = torch.as_tensor(h0 + 0j)
        op = torch.full((d, d), 0.5 + 0j).triu()
        def callable_ham(c, t):
            return torch.cos(t) * h0_t + c[0] * op + c[0].conj() * op.mH
        m4 = qoc_tpu_torch.grape_schroedinger_discrete(
            n_c, n, costs, 1.0, callable_ham, initial, n, iteration_count=3,
            log_iteration_step=1,
            magnus_policy=qoc_tpu_torch.models.MagnusPolicy.M4, device="cpu")
        assert m4.iteration_count_ran == 3
        assert np.all(np.isfinite(m4.errors))
        import qoc_tpu_torch.parallel
        ens = qoc_tpu_torch.EnsembleLinearHamiltonian(
            h0, 0.5 * np.ones((n_c, d, d)), h0[None])
        robust = qoc_tpu_torch.parallel.grape_schroedinger_multistart(
            n_c, n, costs, 1.0, ens, initial, n, n_starts=2,
            hamiltonian_params=[[-0.05], [0.05]], iteration_count=2,
            log_iteration_step=1, device="cpu")
        assert robust.best_final_states.shape == (2, 1, d, 1)
        assert "jax" not in {m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None}
        print("ran without jax", result.best_error, m4.best_error)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=_REPO,
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stderr
    assert "ran without jax" in proc.stdout
    assert "propagation path = fused chain" in proc.stdout
    assert "propagation path = plane chain" in proc.stdout


def _loss_and_gradient_both(problem, magnus, **port_kwargs):
    """qoc_tpu's loss and control gradient on its default route, and the
    port's with ``port_kwargs`` (CPU, float64)."""
    from qoc_tpu.core.common import slap_controls_jax
    from qoc_tpu.core.schroedinger import (
        build_schroedinger_loss as jax_build_loss)
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss

    shape = (problem.n_steps, problem.n_c)
    flat = strip_controls(True, problem.controls)
    jax_loss = jax_build_loss(problem.jax_pstate(magnus=magnus))
    (want, _), g_want = jax.jit(jax.value_and_grad(
        lambda f: jax_loss(slap_controls_jax(True, f, shape)),
        has_aux=True))(jnp.asarray(flat))
    loss = build_schroedinger_loss(problem.torch_pstate(magnus=magnus),
                                   torch.device("cpu"), torch.float64,
                                   log_path=True, **port_kwargs)
    flat_t = torch.tensor(flat, requires_grad=True)
    got, _ = loss(slap_controls_torch(True, flat_t, shape))
    g_got, = torch.autograd.grad(got, flat_t)
    return float(got.detach()), float(want), g_got.numpy(), np.asarray(g_want)


@pytest.mark.parametrize("case", ("d8 M4 callable", "d72 M2 linear"))
def test_blocked_route_matches_jax(case, capsys):
    """The blocked route (expm + tree product) on loss and control
    gradient: a d = 8 torch callable under M4 with the plane route turned
    off, and a d = 72 LinearHamiltonian, which takes it by its size."""
    if case == "d8 M4 callable":
        problem, magnus = Problem(d=8, n_steps=13).use_callables(), "M4"
        kwargs = dict(allow_plane_chain=False, time_block_size=5)
    else:
        problem, magnus, kwargs = Problem(d=72, n_steps=4), "M2", {}
    got, want, g_got, g_want = _loss_and_gradient_both(problem, magnus,
                                                       **kwargs)
    assert "propagation path = blocked expm" in capsys.readouterr().out
    assert got == pytest.approx(want, rel=1e-6)
    assert np.abs(g_got - g_want).max() / np.abs(g_want).max() < 1e-5


def test_blocked_route_grape_trajectory_matches_jax():
    """2 Adam iterations at d = 72 (the port's blocked route, qoc_tpu's
    default one): per-iteration errors and the best iterate agree."""
    problem = Problem(d=72, n_steps=4)
    want, got = _grape_both(problem, 2, 0.0)
    assert got.iteration_count_ran == want.iteration_count_ran == 2
    np.testing.assert_allclose(got.errors, want.errors, rtol=0, atol=1e-6)
    assert got.best_iteration == want.best_iteration
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("d,magnus,allow_plane_chain,path", (
    (8, "M2", True, "fused chain, plain torch on cpu"),
    (8, "M4", True, "plane chain, plain torch on cpu"),
    (8, "M4", False, "blocked expm + tree product, plain torch on cpu"),
    (72, "M2", True, "blocked expm + tree product, plain torch on cpu"),
    (300, "M2", True, "streamed chain, plain torch on cpu"),
    (600, "M2", True, "blocked expm + tree product, Padé-13 on "
                      "torch.linalg.solve (d > 256)"),
))
def test_route_table(d, magnus, allow_plane_chain, path, capsys):
    """The route by the problem alone (core/schroedinger.py): the loss is
    built, nothing propagated. 256 < padded d <= 512 takes K6's streamed
    route."""
    from qoc_tpu_torch.core.schroedinger import build_schroedinger_loss
    pstate = Problem(d=d, n_c=1, n_steps=3).torch_pstate(magnus=magnus)
    build = lambda: build_schroedinger_loss(  # noqa: E731
        pstate, torch.device("cpu"), torch.float64, log_path=True,
        allow_plane_chain=allow_plane_chain)
    build()
    assert "propagation path = " + path in capsys.readouterr().out
