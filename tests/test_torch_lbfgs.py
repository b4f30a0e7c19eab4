"""The port's optimizers and host loop against qoc_tpu's (float64, CPU).

- ``LBFGS.update`` / ``update_batch`` against ``update_jax`` /
  ``update_jax_batch`` on a seeded quadratic: states and parameters after 6
  updates within 1e-12 (relative); the host twin ``run`` against
  ``qoc_tpu``'s on Rosenbrock within 1e-10.
- GRAPE on tests/test_lbfgs.py's problem (d = 2, 11 steps): ``LBFGS()`` on
  the fused loop and through an identity ``impose_control_conditions``
  hook (the host loop) and ``LBFGSB()``, each against ``qoc_tpu``'s same
  call (errors and best controls, 1e-9); the port's fused L-BFGS against
  its host loop within 1e-10 (tests/test_lbfgs.py:229), also for the
  Schrödinger and Lindblad ensembles; Adam's and SGD's numpy twins
  against ``qoc_tpu``'s on a quadratic, and GRAPE through a hook against
  the port's fused loop (1e-12).
- examples/1_transmon_pi_decoherence.py's problem under RKDP5 with
  ``LBFGSB()`` and an identity hook (1 iteration, atol 1e-10: the first
  evaluation's error within tests/test_torch_lindblad.py's single-lane
  1e-9, the errors of scipy's later evaluations, the controls and the
  densities within limits set by the measured sensitivity),
  Lindblad MAGNUS_EXPM with ``LBFGS()``, and an ensemble and a multistart
  with ``LBFGS()`` against ``qoc_tpu`` on a one-device mesh.
- ``ans_jacobian`` against ``qoc_tpu``'s for a real scalar, an array and a
  complex-input function (1e-12), and the host loop's bookkeeping: the
  paired loss and gradient calls cost one evaluation, iteration_count 0
  evaluates the initial controls, a multistart refuses ``LBFGSB()`` with
  ``ValueError`` and a save file is still refused.

Each ``qoc_tpu`` reference is computed once (``functools.cache``); its
compiles are most of this file's time.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)

torch.set_num_threads(1)

_ITERATIONS = 6


# ---------------------------------------------------------------------------
# The optimizer alone
# ---------------------------------------------------------------------------


def _quadratic(rng, n):
    q = rng.normal(size=(n, n))
    return q @ q.T + n * np.eye(n), rng.normal(size=n)


@pytest.mark.parametrize("form", ("single", "batch"))
def test_update_matches_update_jax(form):
    """6 updates of the device L-BFGS (history 3, so the ring wraps) on a
    seeded quadratic, one run or a batch of 3 with candidate 1 frozen from
    the fourth update: every state entry and the parameters."""
    from qoc_tpu.optim import LBFGS as JaxLBFGS
    from qoc_tpu_torch.optim import LBFGS
    rng = np.random.default_rng(4)
    a, b = _quadratic(rng, 9)
    x0 = rng.normal(size=(3, 9) if form == "batch" else 9)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.as_tensor(a), \
        torch.as_tensor(b)

    def jax_loss(x):
        return 0.5 * x @ ja @ x - jb @ x

    def torch_loss(x):
        return 0.5 * torch.sum((x @ ta) * x, -1) - x @ tb

    want_opt, opt = JaxLBFGS(history=3), LBFGS(history=3)
    jx, tx = jnp.asarray(x0), torch.as_tensor(x0)
    if form == "batch":
        js, ts = jax.vmap(want_opt.init_state)(jx), opt.init_state_batch(tx)

        @jax.jit
        def step_jax(js, jx, keep):
            f0, g = jax.vmap(jax.value_and_grad(jax_loss))(jx)
            new_js, new_jx = want_opt.update_jax_batch(
                js, g, jx, f0, jax.vmap(jax_loss))
            return (jax.tree_util.tree_map(
                lambda new, old: jnp.where(
                    keep.reshape((-1,) + (1,) * (new.ndim - 1)), old, new),
                new_js, js), jnp.where(keep[:, None], jx, new_jx))
    else:
        js, ts = want_opt.init_state(jx), opt.init_state(tx)

        @jax.jit
        def step_jax(js, jx, keep):
            f0, g = jax.value_and_grad(jax_loss)(jx)
            return want_opt.update_jax(js, g, jx, f0, jax_loss)
    for step in range(6):
        frozen = torch.tensor([False, step >= 3, False])
        js, jx = step_jax(js, jx, jnp.asarray(frozen.numpy()))
        x = tx.clone().requires_grad_(True)
        tf0 = torch_loss(x)
        tg, = torch.autograd.grad(tf0.sum(), x)
        if form == "batch":
            ts, tx = opt.update_batch(ts, tg, tx, frozen, tf0.detach(),
                                      torch_loss)
        else:
            ts, tx = opt.update(ts, tg, tx, tf0.detach(), torch_loss)
    for key, want in js.items():
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12,
                               atol=1e-12)


def test_host_run_matches_qoc_tpu_on_rosenbrock():
    """The numpy twin (sequential backtracking on the same ladder) against
    qoc_tpu's, 40 iterations from (-1.2, 1): every iterate."""
    from qoc_tpu.optim import LBFGS as JaxLBFGS
    from qoc_tpu_torch.optim import LBFGS

    def trace(opt):
        iterates = []

        def function(x):
            return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2, False

        def jacobian(x):
            iterates.append(np.array(x))
            return np.array([-2 * (1 - x[0]) - 400 * x[0] * (x[1] - x[0] ** 2),
                             200 * (x[1] - x[0] ** 2)]), False

        opt.run(function, 40, np.array([-1.2, 1.0]), jacobian)
        return np.array(iterates)

    want, got = trace(JaxLBFGS(ls_steps=10)), trace(LBFGS(ls_steps=10))
    assert got.shape == want.shape == (40, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert np.linalg.norm(got[-1] - 1.0) < np.linalg.norm(got[0] - 1.0)


# ---------------------------------------------------------------------------
# GRAPE
# ---------------------------------------------------------------------------


def _grape_problem():
    """tests/test_lbfgs.py's problem: d = 2, H = σz/2 + c a + conj(c) a^H,
    |0> to |1>, 11 control and system points, T = 10; in both packages."""
    from qoc_tpu.models import LinearHamiltonian
    from qoc_tpu.standard import (SIGMA_Z, TargetStateInfidelity,
                                  get_annihilation_operator)
    from qoc_tpu_torch import convert
    hamiltonian = LinearHamiltonian(np.asarray(SIGMA_Z) / 2,
                                    np.stack((get_annihilation_operator(2),)))
    initial = np.array([[[1.0], [0.0]]])
    costs = [TargetStateInfidelity(np.array([[[0.0], [1.0]]]))]
    return {"jax": (costs, hamiltonian, initial),
            "torch": ([convert.target_state_infidelity(costs[0])],
                      convert.linear_hamiltonian(hamiltonian),
                      convert.states(initial))}


def _grape(package, optimizer, hook=False, iteration_count=_ITERATIONS):
    """grape_schroedinger_discrete of ``package`` ("jax" or "torch") with
    ``optimizer`` (its class name) on _grape_problem; ``hook``: an identity
    impose_control_conditions hook, which forces the host loop."""
    import qoc_tpu
    import qoc_tpu_torch
    costs, hamiltonian, initial = _grape_problem()[package]
    if package == "jax":
        grape = qoc_tpu.grape_schroedinger_discrete
        make = getattr(qoc_tpu.optim, optimizer)
    else:
        grape = functools.partial(qoc_tpu_torch.grape_schroedinger_discrete,
                                  device="cpu")
        make = getattr(qoc_tpu_torch.optim, optimizer)
    calls = []

    def identity(controls):
        calls.append(np.asarray(controls).shape)
        return controls

    result = grape(1, 11, costs, 10, hamiltonian, initial, 11,
                   complex_controls=True, iteration_count=iteration_count,
                   log_iteration_step=0, optimizer=make(),
                   impose_control_conditions=identity if hook else None)
    if hook:
        assert calls and set(calls) == {(11, 1)}
    return result


@functools.cache
def _jax_grape(optimizer, hook):
    return _grape("jax", optimizer, hook)


def _assert_same_run(got, want, tol, errors=True):
    if errors:
        np.testing.assert_allclose(got.errors, np.asarray(want.errors),
                                   rtol=0, atol=tol)
    assert got.best_iteration == want.best_iteration
    assert got.best_error == pytest.approx(float(want.best_error), abs=tol)
    np.testing.assert_allclose(got.best_controls,
                               np.asarray(want.best_controls), rtol=0,
                               atol=tol)
    evolved = ("best_final_states" if hasattr(got, "best_final_states")
               else "best_final_densities")
    np.testing.assert_allclose(getattr(got, evolved),
                               np.asarray(getattr(want, evolved)), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("hook", (False, True), ids=("fused", "host"))
def test_grape_lbfgs_matches_jax(hook):
    """LBFGS() on the fused loop (the ladder as sequential forward losses)
    and through an identity hook on the host loop (the numpy twin), each
    against qoc_tpu's same call: the best error, iteration, controls and
    final states (qoc_tpu's host loop keeps no error history)."""
    got = _grape("torch", "LBFGS", hook)
    want = _jax_grape("LBFGS", hook)
    assert got.iteration_count_ran == _ITERATIONS
    assert got.errors.shape == (_ITERATIONS,)
    assert got.best_error < got.errors[0]
    _assert_same_run(got, want, 1e-9, errors=not hook)


def _port_ensemble(hook, lindblad=False):
    """The port's grape_schroedinger_ensemble (or grape_lindblad_ensemble,
    under MAGNUS_EXPM) of _parallel's members with LBFGS(), 4 iterations,
    through an identity hook (the host loop) or not."""
    import qoc_tpu_torch
    from qoc_tpu_torch.models import LindbladMethod
    from torch_parity import LindbladEnsembleProblem
    kwargs = dict(complex_controls=True, iteration_count=4,
                  log_iteration_step=0, optimizer=qoc_tpu_torch.LBFGS(),
                  impose_control_conditions=(lambda c: c) if hook else None,
                  device="cpu")
    if lindblad:
        problem = LindbladEnsembleProblem(n_members=2)
        return qoc_tpu_torch.grape_lindblad_ensemble(
            1, problem.control_eval_count, problem.torch_costs,
            problem.evolution_time, problem.torch_hamiltonian,
            problem.params, problem.torch_initial,
            problem.system_eval_count, lindblad_data=problem.torch_lindblad,
            initial_controls=problem.controls,
            method=LindbladMethod.MAGNUS_EXPM, **kwargs)
    costs, _, initial = _grape_problem()["torch"]
    a = np.array([[0, 1], [0, 0]], dtype=complex)
    sz = np.diag([1.0, -1.0]) + 0j
    members = qoc_tpu_torch.EnsembleLinearHamiltonian(sz / 2, a[None],
                                                      sz[None] / 2)
    return qoc_tpu_torch.grape_schroedinger_ensemble(
        1, 11, costs, 10, members, np.linspace(-0.05, 0.05, 3)[:, None],
        initial, 11, **kwargs)


@pytest.mark.parametrize("entry", ("discrete", "ensemble",
                                   "lindblad ensemble"))
def test_grape_lbfgs_fused_matches_host_loop(entry):
    """The device ladder's select (the first Armijo-feasible rung) and the
    host's sequential backtracking walk the same ladder in the same order:
    the same trajectory (tests/test_lbfgs.py:229's check, on the port),
    for grape_schroedinger_discrete, grape_schroedinger_ensemble and
    grape_lindblad_ensemble, whose host loop an identity
    impose_control_conditions hook opens."""
    if entry == "discrete":
        fused = _grape("torch", "LBFGS")
        host = _grape("torch", "LBFGS", hook=True)
    else:
        fused, host = (_port_ensemble(hook, entry == "lindblad ensemble")
                       for hook in (False, True))
    _assert_same_run(host, fused, 1e-10)


def test_grape_lbfgsb_matches_jax():
    """LBFGSB() on the host loop (scipy's line search) against qoc_tpu's:
    the best iterate; every scipy loss and gradient call pair costs one
    evaluation, counted by the port's error history."""
    got = _grape("torch", "LBFGSB")
    _assert_same_run(got, _jax_grape("LBFGSB", False), 1e-9, errors=False)
    assert got.best_error < got.errors[0]
    assert got.iteration_count_ran == got.errors.size


@pytest.mark.parametrize("optimizer", ("Adam", "SGD"))
def test_host_twins_match_qoc_tpu_and_the_fused_loop(optimizer):
    """Adam's and SGD's numpy twins (``run``, ``update_np``) against
    qoc_tpu's host ``run`` on the same loss and gradient, every iterate
    within 1e-12 (Adam with its decay, scaling and clipping); and GRAPE
    through an identity hook (the host loop) against the port's fused
    loop, every error and the best iterate within 1e-12."""
    import qoc_tpu.optim
    import qoc_tpu_torch.optim
    kwargs = (dict(learning_rate=0.05, learning_rate_decay=30.0,
                   scale_grads=2.0, clip_grads=0.4)
              if optimizer == "Adam" else dict(learning_rate=0.05))
    rng = np.random.default_rng(9)
    a, b = _quadratic(rng, 7)

    def trace(opt):
        iterates = []

        def jacobian(x):
            iterates.append(np.array(x))
            return a @ x - b, len(iterates) == 9

        opt.run(lambda x: (0.5 * x @ a @ x - b @ x, False), 12,
                np.ones(7), jacobian)
        return np.array(iterates)

    want = trace(getattr(qoc_tpu.optim, optimizer)(**kwargs))
    got = trace(getattr(qoc_tpu_torch.optim, optimizer)(**kwargs))
    assert got.shape == want.shape == (9, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    host = _grape("torch", optimizer, hook=True)
    _assert_same_run(host, _grape("torch", optimizer), 1e-12)


def test_host_loop_bookkeeping(capsys):
    """iteration_count 0 evaluates the initial controls; a paired loss and
    gradient at one point cost one loss evaluation; rows are logged in the
    reference's format."""
    import qoc_tpu_torch
    from qoc_tpu_torch.core import graperunner
    from qoc_tpu_torch.models import GrapeSchroedingerResult
    costs, hamiltonian, initial = _grape_problem()["torch"]
    none = _grape("torch", "LBFGSB", iteration_count=0)
    fused = _grape("torch", "Adam", iteration_count=0)
    assert none.iteration_count_ran == 0 and none.errors.shape == (0,)
    assert none.best_error == pytest.approx(fused.best_error, abs=1e-15)
    np.testing.assert_allclose(none.best_controls, fused.best_controls)

    class Pstate:
        complex_controls, controls_shape = True, (11, 1)
        max_control_norms = np.array([1.0])
        initial_controls = np.full((11, 1), 0.1 + 0.2j)
        impose_control_conditions = None
        iteration_count, min_error = 3, 0.0
        should_log, log_iteration_step, final_iteration = True, 1, 2
        should_save = False

        class optimizer:
            @staticmethod
            def run(function, iterations, x0, jacobian):
                for _ in range(iterations):
                    function(x0)
                    jacobian(x0)
                    x0 = x0 * 0.5

    evaluations = []

    def loss_flat(flat):
        evaluations.append(1)
        return torch.sum(flat ** 2), torch.zeros((1, 2, 1),
                                                 dtype=torch.complex128)

    result = GrapeSchroedingerResult()
    graperunner.run_grape(Pstate, result, loss_flat, torch.device("cpu"),
                          torch.float64)
    assert len(evaluations) == 3 and result.iteration_count_ran == 3
    np.testing.assert_allclose(result.errors, 11 * 0.05 * 0.25 ** np.arange(3))
    assert result.best_iteration == 2
    rows = capsys.readouterr().out.splitlines()
    assert [row.split("|")[0].strip() for row in rows] == ["0", "1", "2"]
    assert qoc_tpu_torch.LBFGS.needs_loss


# ---------------------------------------------------------------------------
# Lindblad, ensembles and multistarts
# ---------------------------------------------------------------------------


def _example1(package):
    """examples/1_transmon_pi_decoherence.py's problem in ``package`` (no
    save file): d = 2, T1 = 1000 on a, |0><0| to |1><1|, 11 control points,
    one interval, T = 10, maximum norm 5."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.standard import TargetDensityInfidelity
    from qoc_tpu_torch import convert
    a = np.array([[0, 1], [0, 0]], dtype=complex)
    initial = np.array([[[1, 0], [0, 0]]], dtype=complex)
    target = np.array([[[0, 0], [0, 1]]], dtype=complex)
    hamiltonian = qoc_tpu.LinearHamiltonian(np.diag([0.5, -0.5]) + 0j,
                                            a[None])
    lindblad = qoc_tpu.ConstantLindblad(np.array([1e-3]), a[None])
    cost = TargetDensityInfidelity(target)
    common = dict(complex_controls=True, max_control_norms=np.array([5.0]),
                  log_iteration_step=0)
    if package == "jax":
        return (qoc_tpu.grape_lindblad_discrete, [cost], initial,
                dict(common, hamiltonian=hamiltonian,
                     lindblad_data=lindblad), qoc_tpu)
    return (functools.partial(qoc_tpu_torch.grape_lindblad_discrete,
                              device="cpu"),
            [convert.target_density_infidelity(cost)],
            convert.densities(initial),
            dict(common, hamiltonian=convert.linear_hamiltonian(hamiltonian),
                 lindblad_data=convert.constant_lindblad(lindblad)),
            qoc_tpu_torch)


def _recording(optimizer_class):
    """``optimizer_class`` whose ``run`` keeps, in ``errors``, the error of
    every loss evaluation that the optimizer asks for (qoc_tpu's host loop
    keeps no history of them)."""
    class Recording(optimizer_class):
        def run(self, function, iteration_count, initial_params, jacobian,
                args=()):
            self.errors = []

            def recorded(*a):
                value = function(*a)
                self.errors.append(value[0])
                return value

            return super().run(recorded, iteration_count, initial_params,
                               jacobian, args)

    return Recording


def _lindblad(package, case):
    """(result, the errors of every evaluation the optimizer asked for, or
    None) of example 1's GRAPE in ``package``."""
    grape, costs, initial, kwargs, pkg = _example1(package)
    if case == "RKDP5 LBFGSB":
        optimizer = _recording(pkg.optim.LBFGSB)()
        kwargs.update(iteration_count=1, atol=1e-10, rkdp5_max_steps=512,
                      optimizer=optimizer,
                      impose_control_conditions=lambda c: c)
    else:
        optimizer = pkg.optim.LBFGS()
        kwargs.update(iteration_count=4, optimizer=optimizer,
                      method=pkg.models.LindbladMethod.MAGNUS_EXPM)
    result = grape(1, 11, costs, 10, initial, 2, **kwargs)
    return result, getattr(optimizer, "errors", None)


@functools.cache
def _jax_lindblad(case):
    return _lindblad("jax", case)


# Example 1 under RKDP5 with LBFGSB, 1 iteration at atol 1e-10 (at most 512
# attempts an interval; about 396 taken): the first evaluation, at the
# initial controls, agrees within 1e-9 (6.7e-16 measured). scipy's first
# step then carries the integrator's rounding-level differences into the
# next controls: a 1 + 1e-15 scaling of the drift moves the port's own
# later errors by 1.668e-9, best controls by 3.169e-10 and final densities
# by 1.862e-8 (profiling/rkdp5_sensitivity.py, this test's settings), and
# the two packages part by 2.685e-9, 1.558e-9 and 2.638e-8 (best error
# 2.611e-9). So these take limits of their own, at least 3.7 times those
# readings.
_LBFGSB_RKDP5_TOLS = {"first": 1e-9, "error": 1e-8, "controls": 1e-8,
                      "densities": 1e-7}


@pytest.mark.parametrize("case", ("RKDP5 LBFGSB", "MAGNUS_EXPM LBFGS"))
def test_grape_lindblad_matches_jax(case):
    """Example 1's problem: under RKDP5 (the default) with LBFGSB() and an
    identity hook for 1 iteration (the errors of every evaluation scipy
    asks for), and under MAGNUS_EXPM with the device LBFGS() for 4 (every
    iteration's error), each against qoc_tpu's same call, the error
    falling towards the Frobenius floor 0.5 (tests/test_lbfgs.py:273).
    MAGNUS_EXPM within 1e-9; RKDP5 within _LBFGSB_RKDP5_TOLS."""
    got, got_errors = _lindblad("torch", case)
    want, want_errors = _jax_lindblad(case)
    if case == "RKDP5 LBFGSB":
        tols = _LBFGSB_RKDP5_TOLS
        np.testing.assert_allclose(got.errors, got_errors, rtol=0, atol=0)
        assert len(got_errors) == len(want_errors) >= 2
        assert got_errors[0] == pytest.approx(want_errors[0],
                                              abs=tols["first"])
    else:
        tols = dict.fromkeys(_LBFGSB_RKDP5_TOLS, 1e-9)
        want_errors = want.errors
    np.testing.assert_allclose(got.errors, np.asarray(want_errors), rtol=0,
                               atol=tols["error"])
    assert got.best_error < got.errors[0]
    assert 0.5 < got.best_error < 1.0
    assert got.best_error == pytest.approx(float(want.best_error),
                                           abs=tols["error"])
    np.testing.assert_allclose(got.best_controls,
                               np.asarray(want.best_controls), rtol=0,
                               atol=tols["controls"])
    np.testing.assert_allclose(got.best_final_densities,
                               np.asarray(want.best_final_densities), rtol=0,
                               atol=tols["densities"])


def _parallel(package, entry):
    """A 3-member ensemble GRAPE of _grape_problem (members: the drift
    scaled by 1 + δ, δ in [-0.05, 0.05]) or a 2-candidate multistart of
    it, LBFGS(), 4 iterations; qoc_tpu on a one-device mesh."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.standard import SIGMA_Z, get_annihilation_operator
    from qoc_tpu_torch import convert
    costs, hamiltonian, initial = _grape_problem()[package]
    pkg = qoc_tpu if package == "jax" else qoc_tpu_torch
    kwargs = dict(complex_controls=True, iteration_count=4,
                  log_iteration_step=0, optimizer=pkg.optim.LBFGS())
    if package == "jax":
        kwargs["mesh"] = qoc_tpu.parallel.make_mesh(
            1, axis_name="ensemble" if entry == "ensemble" else "candidate")
    else:
        kwargs["device"] = "cpu"
    if entry == "ensemble":
        a = get_annihilation_operator(2)
        members = qoc_tpu.EnsembleLinearHamiltonian(
            np.asarray(SIGMA_Z) / 2, a[None], np.asarray(SIGMA_Z)[None] / 2)
        if package == "torch":
            members = convert.linear_hamiltonian(members)
        return pkg.parallel.grape_schroedinger_ensemble(
            1, 11, costs, 10, members, np.linspace(-0.05, 0.05, 3)[:, None],
            initial, 11, **kwargs)
    return pkg.parallel.grape_schroedinger_multistart(
        1, 11, costs, 10, hamiltonian, initial, 11, n_starts=2, seed=2,
        **kwargs)


@pytest.mark.parametrize("entry", ("ensemble", "multistart"))
def test_parallel_lbfgs_matches_jax(entry):
    """grape_schroedinger_ensemble (the shared controls' L-BFGS over the
    members' mean) and grape_schroedinger_multistart (every candidate's own
    ring and ladder, one batched forward a rung) with LBFGS(), against
    qoc_tpu's, 1e-9."""
    got, want = _parallel("torch", entry), _parallel("jax", entry)
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=1e-9)
    assert got.best_iteration == want.best_iteration
    assert got.best_error == pytest.approx(float(want.best_error), abs=1e-9)
    np.testing.assert_allclose(got.best_controls,
                               np.asarray(want.best_controls), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.best_final_states,
                               np.asarray(want.best_final_states), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("case", ("multistart LBFGSB", "save file"))
def test_refusals(case, tmp_path):
    """A multistart refuses a host-loop-only optimizer with qoc_tpu's
    ValueError; the host loop writes a save file: a row for each
    evaluation up to iteration_count and the checkpoint, params and
    iteration (LBFGSB has no state of its own to save, as in qoc_tpu)."""
    import qoc_tpu_torch
    costs, hamiltonian, initial = _grape_problem()["torch"]
    common = dict(complex_controls=True, iteration_count=1,
                  log_iteration_step=0, optimizer=qoc_tpu_torch.LBFGSB(),
                  device="cpu")
    if case == "save file":
        import h5py
        path = str(tmp_path / "run.h5")
        result = qoc_tpu_torch.grape_schroedinger_discrete(
            1, 11, costs, 10, hamiltonian, initial, 11,
            save_file_path=path, save_iteration_step=1,
            impose_control_conditions=lambda c: c, **common)
        with h5py.File(path, "r") as f:
            assert f["error"][0] == result.errors[0]
            assert sorted(f["optimizer_state"]) == [
                "__iteration__", "__params__", "checkpoint_kind"]
    else:
        with pytest.raises(ValueError, match="host-loop only.*"
                           "grape_lindblad_discrete"):
            qoc_tpu_torch.grape_lindblad_multistart(
                1, 11, [], 10, np.eye(2)[None], 11, n_starts=2,
                hamiltonian=hamiltonian, **common)


# ---------------------------------------------------------------------------
# ans_jacobian
# ---------------------------------------------------------------------------


def _functions(case):
    """(jax function, torch function, input) of each case."""
    rng = np.random.default_rng(len(case))
    m = rng.normal(size=(3, 3)) + 1j * rng.normal(size=(3, 3))
    if case == "scalar":
        x = rng.normal(size=4)
        return (lambda v, s: s * jnp.sum(jnp.sin(v) * v[::-1]),
                lambda v, s: s * torch.sum(torch.sin(v) * v.flip(0)), x)
    if case == "array":
        x = rng.normal(size=3)
        return (lambda v, s: s * jnp.exp(1j * v) @ jnp.asarray(m),
                lambda v, s: s * torch.exp(1j * v) @ torch.as_tensor(m), x)
    x = rng.normal(size=3) + 1j * rng.normal(size=3)
    return (lambda z, s: s * jnp.abs(jnp.asarray(m) @ z) ** 2
            + jnp.real(z[0] * z[1]),
            lambda z, s: s * torch.abs(torch.as_tensor(m) @ z) ** 2
            + torch.real(z[0] * z[1]), x)


@pytest.mark.parametrize("case", ("scalar", "array", "complex input"))
def test_ans_jacobian_matches_jax(case):
    """A real scalar of a real vector (the gradient), a complex array of a
    real vector (the full Jacobian) and a real array of a complex vector
    (qoc_tpu's convention: du/dx - i du/dy), each with a keyword and a
    second positional argument."""
    from qoc_tpu.gradutil import ans_jacobian as jax_ans_jacobian
    from qoc_tpu_torch import ans_jacobian
    jax_fn, torch_fn, x = _functions(case)
    want_value, want = jax.jit(lambda v: jax_ans_jacobian(jax_fn, 0)(
        v, s=1.5))(jnp.asarray(x))
    value, got = ans_jacobian(torch_fn, 0)(torch.as_tensor(x), s=1.5)
    assert got.shape == want.shape
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
