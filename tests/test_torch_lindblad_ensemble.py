"""The port's Lindblad ensembles and multistart against qoc_tpu's (float64,
CPU), and the plane chain op's member axis that carries them on the card.

- The plane op's member axis against each member run alone through the
  single-chain op: on K6's segment plan at d = 260 (3 members x 2 steps,
  S_m = 2; 17 chains x 1 step, S_m = 1 in two waves) and K5's at d = 3 (3 members,
  S_m = 5; 130 chains, S_m = 1), totals, prefixes and the plane gradient in
  both seed modes, within 1e-12.
- build_lindblad_ensemble_loss against qoc_tpu's: example 6 (d = 2, 8
  members; the fused route, K1/K2's member axis on the card) with and
  without step costs, a torch callable at d = 3 (the blocked route), and
  d = 17 with 2 members x 2 steps (the streamed route, K6's member axis on
  the card).
- grape_lindblad_ensemble (5 iterations at d = 2) and
  grape_lindblad_multistart (4 candidates; 2 candidates x 2 members; 4
  candidates with step costs) against qoc_tpu's.
- Under RKDP5 (the default method; the members and candidates are the
  adaptive integrator's lanes): grape_lindblad_ensemble of 3 members and
  grape_lindblad_multistart of 2 candidates x 2 members, 2 iterations at
  d = 2, against qoc_tpu's generic route, at atol 1e-10 within 1e-7
  (errors, controls, densities; measured up to 9e-9). On this problem a
  1e-15 change of the controls moves either package's densities by up to
  1e-8: a mesh decision flips on a rounding, so two roundings part by up
  to the integrator's own error; qoc_tpu's vmapped members equal its single
  runs, and the port's lanes its single lanes, exactly.
- The refusals, each naming its ROADMAP item.

On the CPU qoc_tpu takes its generic route (no Pallas), which keeps the
step costs its fused multistart drops. Tolerances of
tests/test_torch_ensemble.py: errors 1e-6, controls 1e-5, densities 1e-6
(gradients 1e-6 absolute).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import (LindbladEnsembleProblem, not_a_grape_file,
                          saved_errors)

torch.set_num_threads(1)

_ITERATIONS = 5


# ---------------------------------------------------------------------------
# The plane chain op's member axis
# ---------------------------------------------------------------------------


def _planes(rng, n_chains, n_steps, d, norm):
    """Complex planes (M, B, d, d), every chain different, at batch-max
    1-norm ``norm``: on one ladder level for the batch and each chain."""
    a = (rng.normal(size=(n_chains, n_steps, d, d))
         + 1j * rng.normal(size=(n_chains, n_steps, d, d)))
    return torch.as_tensor(a * (norm / np.abs(a).sum(-2).max()))


def _op_outputs(a, g_total, g_pref):
    """(total, prefixes, plane gradient in the last-step mode, in the
    per-step mode) of the trajectory op, from one forward."""
    from qoc_tpu_torch.ops.chain import plane_chain_propagate_prefixes
    x = a.clone().requires_grad_(True)
    total, prefixes = plane_chain_propagate_prefixes(x)
    grad_last, = torch.autograd.grad(total, x, g_total, retain_graph=True)
    grad_step, = torch.autograd.grad((total, prefixes), x, (g_total, g_pref))
    return total.detach(), prefixes.detach(), grad_last, grad_step


@pytest.mark.parametrize("d,n_chains,n_steps,segments", (
    (260, 3, 2, 2), (260, 17, 1, 1), (3, 3, 40, 5), (3, 130, 9, 1)))
def test_plane_member_axis_matches_single_chains(d, n_chains, n_steps,
                                                 segments):
    """Totals, prefixes and the plane gradient of M chains in one call
    equal each chain run alone, on K6's plan (d = 260) and K5's (d = 3),
    with S_m > 1 segments a chain (merge and seeds under a member axis) and
    S_m = 1, in the last-step and the per-step seed mode."""
    from qoc_tpu_torch.ops import chain
    plan = chain.stream_segment_plan if d > 64 else chain.segment_plan
    assert chain._plane_route(d, torch.device("cpu"), False)[1] is plan
    assert plan(n_steps, n_chains)[0] == segments
    rng = np.random.default_rng(d + n_chains)
    a = _planes(rng, n_chains, n_steps, d, 0.04 if d > 64 else 0.4)
    g_total = torch.as_tensor(rng.normal(size=(n_chains, d, d))
                              + 1j * rng.normal(size=(n_chains, d, d)))
    g_pref = torch.as_tensor(
        rng.normal(size=(n_chains, n_steps, d, d))
        + 1j * rng.normal(size=(n_chains, n_steps, d, d)))
    batched = _op_outputs(a, g_total, g_pref)
    assert batched[0].shape == (n_chains, d, d)
    assert batched[1].shape == (n_chains, n_steps, d, d)
    for m in sorted({0, n_chains // 2, n_chains - 1}):
        alone = _op_outputs(a[m], g_total[m], g_pref[m])
        for got, want in zip(batched, alone):
            np.testing.assert_allclose(got[m].numpy(), want.numpy(),
                                       rtol=0, atol=1e-12)


@pytest.mark.parametrize("n_chains,segments", ((1, 15), (3, 5), (16, 10),
                                               (17, 6)))
def test_stream_segment_plan_counts_chains(n_chains, segments):
    """K6's plan at 100 steps: the n_chains * S rows walk the card's 15
    resident clusters in waves, and S makes the busiest cluster's walk
    (waves x L) no longer than one segment a chain would; every step in one
    segment, less than a segment of padding."""
    from qoc_tpu_torch.ops.chain import stream_segment_plan
    s_count, length = stream_segment_plan(100, n_chains)
    assert s_count == segments
    assert s_count * length >= 100 > (s_count - 1) * length
    assert -(-n_chains * s_count // 15) * length <= -(-n_chains // 15) * 100


# ---------------------------------------------------------------------------
# build_lindblad_ensemble_loss
# ---------------------------------------------------------------------------


# (d, members, system_eval_count, step costs, callable) -> the port's route.
_LOSS_CASES = {
    (2, 8, 21, False, False): "fused",
    (2, 8, 21, True, False): "fused",
    (3, 3, 9, True, True): "blocked",
    (17, 2, 3, False, False): "stream",
}


def _problem(d, n_members, system_eval_count, step_costs, callables):
    problem = LindbladEnsembleProblem(
        d=d, n_members=n_members, control_eval_count=min(
            11, system_eval_count), system_eval_count=system_eval_count,
        evolution_time=10.0 if d == 2 else 1.0)
    if step_costs:
        problem.add_step_costs()
    if callables:
        problem.use_callables()
    return problem


@functools.cache
def _jax_loss(case):
    """qoc_tpu's Lindblad ensemble loss, value, gradient (w.r.t. the flat
    real controls) and member final densities at the problem's
    controls."""
    from qoc_tpu.core.common import slap_controls_jax, strip_controls
    from qoc_tpu.parallel import build_lindblad_ensemble_loss, make_mesh
    problem = _problem(*case)
    pstate = problem.pstate("jax")
    loss = build_lindblad_ensemble_loss(pstate, problem.jax_hamiltonian,
                                        problem.params, make_mesh(1))
    shape = pstate.controls_shape
    (error, densities), grad = jax.jit(jax.value_and_grad(
        lambda x: loss(slap_controls_jax(True, x, shape)), has_aux=True))(
            jnp.asarray(strip_controls(True, problem.controls)))
    return float(error), np.asarray(grad), np.asarray(densities)


@pytest.mark.parametrize("case", sorted(_LOSS_CASES, key=str))
def test_build_lindblad_ensemble_loss_matches_jax(case, capsys):
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.parallel import build_lindblad_ensemble_loss
    problem = _problem(*case)
    pstate = problem.pstate("torch")
    loss = build_lindblad_ensemble_loss(pstate, problem.torch_hamiltonian,
                                        problem.params, log_path=True,
                                        device="cpu")
    assert loss.route == _LOSS_CASES[case]
    assert loss.uses_fused_chain == (loss.route != "blocked")
    assert "Lindblad ensemble propagation path" in capsys.readouterr().out
    flat = torch.as_tensor(strip_controls(True, problem.controls))
    flat.requires_grad_(True)
    error, densities = loss(slap_controls_torch(True, flat,
                                                pstate.controls_shape))
    grad, = torch.autograd.grad(error, flat)
    want_error, want_grad, want_densities = _jax_loss(case)
    d, n_members = case[:2]
    assert densities.shape == (n_members, 1, d, d)
    assert float(error.detach()) == pytest.approx(want_error, abs=1e-6)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0, atol=1e-6)
    np.testing.assert_allclose(densities.detach().numpy(), want_densities,
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# grape_lindblad_ensemble and grape_lindblad_multistart
# ---------------------------------------------------------------------------


def _common(problem, models):
    """The keyword arguments both packages' entry points take, with
    ``models`` the package's models module (its LindbladMethod)."""
    return dict(complex_controls=True, initial_controls=problem.controls,
                max_control_norms=problem.max_control_norms,
                iteration_count=_ITERATIONS, log_iteration_step=0,
                method=models.LindbladMethod.MAGNUS_EXPM)


def _assert_same_run(want, got):
    assert got.iteration_count_ran == _ITERATIONS
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=1e-6)
    assert got.best_iteration == want.best_iteration
    assert got.best_error == pytest.approx(want.best_error, abs=1e-6)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.best_final_densities,
                               np.asarray(want.best_final_densities),
                               rtol=0, atol=1e-6)


def test_grape_lindblad_ensemble_matches_jax():
    """5 Adam iterations of robust open-system GRAPE on example 6: the
    per-iteration errors, the best controls, error and iteration, and the
    members' final densities."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.parallel import make_mesh
    problem = LindbladEnsembleProblem()
    args = (1, problem.control_eval_count)
    want = qoc_tpu.parallel.grape_lindblad_ensemble(
        *args, problem.jax_costs, problem.evolution_time,
        problem.jax_hamiltonian, problem.params, problem.initial,
        problem.system_eval_count, lindblad_data=problem.jax_lindblad,
        mesh=make_mesh(1), optimizer=qoc_tpu.optim.Adam(learning_rate=0.05),
        **_common(problem, qoc_tpu.models))
    got = qoc_tpu_torch.grape_lindblad_ensemble(
        *args, problem.torch_costs, problem.evolution_time,
        problem.torch_hamiltonian, problem.params, problem.torch_initial,
        problem.system_eval_count, lindblad_data=problem.torch_lindblad,
        optimizer=qoc_tpu_torch.Adam(learning_rate=0.05), device="cpu",
        **_common(problem, qoc_tpu_torch.models))
    assert got.best_final_densities.shape == (8, 1, 2, 2)
    _assert_same_run(want, got)


# (candidates, members, step costs)
_MULTISTART_CASES = ((4, None, False), (2, 2, False), (4, None, True))


@pytest.mark.parametrize("case", _MULTISTART_CASES)
def test_grape_lindblad_multistart_matches_jax(case):
    """4 candidates of example 6's problem without members (the plain
    LinearHamiltonian), 2 candidates x 2 members, and 4 candidates with
    step costs (qoc_tpu's generic route keeps them; its fused multistart
    would drop them): every candidate's best error, the winner, its
    controls, best iteration and final densities."""
    import qoc_tpu
    import qoc_tpu_torch
    from jax.sharding import Mesh
    from qoc_tpu import LinearHamiltonian
    from qoc_tpu_torch import convert
    n_starts, n_members, step_costs = case
    problem = LindbladEnsembleProblem(n_members=n_members or 1)
    if step_costs:
        problem.add_step_costs()
    params = problem.params if n_members else None
    jax_ham = problem.jax_hamiltonian
    if not n_members:
        jax_ham = LinearHamiltonian(problem.h0, problem.a[None])
    axes = ("candidate", "ensemble") if n_members else ("candidate",)
    one_device = Mesh(np.asarray(jax.devices()[:1]).reshape(
        (1,) * len(axes)), axes)
    common = dict(n_starts=n_starts, seed=3, hamiltonian_params=params)
    args = (1, problem.control_eval_count)
    want = qoc_tpu.parallel.grape_lindblad_multistart(
        *args, problem.jax_costs, problem.evolution_time, problem.initial,
        problem.system_eval_count, hamiltonian=jax_ham,
        lindblad_data=problem.jax_lindblad, mesh=one_device,
        optimizer=qoc_tpu.optim.Adam(learning_rate=0.05),
        **common, **_common(problem, qoc_tpu.models))
    got = qoc_tpu_torch.grape_lindblad_multistart(
        *args, problem.torch_costs, problem.evolution_time,
        problem.torch_initial, problem.system_eval_count,
        hamiltonian=convert.linear_hamiltonian(jax_ham),
        lindblad_data=problem.torch_lindblad,
        optimizer=qoc_tpu_torch.Adam(learning_rate=0.05), device="cpu",
        **common, **_common(problem, qoc_tpu_torch.models))
    assert got.errors.shape == (n_starts,)
    assert got.best_final_densities.shape == (
        ((n_members,) if n_members else ()) + (1, 2, 2))
    _assert_same_run(want, got)


@pytest.mark.parametrize("entry", ("ensemble", "multistart"))
def test_rkdp5_ensemble_and_multistart_match_jax(entry):
    """The default method, RKDP5, on example 6's problem (3 members, 2
    intervals of T = 2, atol 1e-10, at most 128 attempts an interval, where
    the slowest lane takes about 110): a 2-iteration ensemble GRAPE, and a
    robust multistart of 2 candidates x 2 members (4 lanes), each against
    qoc_tpu's generic route."""
    import qoc_tpu
    import qoc_tpu_torch
    from jax.sharding import Mesh
    n_members = 3 if entry == "ensemble" else 2
    problem = LindbladEnsembleProblem(n_members=n_members,
                                      control_eval_count=6,
                                      system_eval_count=3,
                                      evolution_time=2.0)
    common = dict(complex_controls=True, initial_controls=problem.controls,
                  max_control_norms=problem.max_control_norms,
                  iteration_count=2, log_iteration_step=0, atol=1e-10,
                  rkdp5_max_steps=128)
    args = (1, problem.control_eval_count)
    if entry == "ensemble":
        want = qoc_tpu.parallel.grape_lindblad_ensemble(
            *args, problem.jax_costs, problem.evolution_time,
            problem.jax_hamiltonian, problem.params, problem.initial,
            problem.system_eval_count, lindblad_data=problem.jax_lindblad,
            mesh=qoc_tpu.parallel.make_mesh(1),
            optimizer=qoc_tpu.optim.Adam(learning_rate=0.05), **common)
        got = qoc_tpu_torch.grape_lindblad_ensemble(
            *args, problem.torch_costs, problem.evolution_time,
            problem.torch_hamiltonian, problem.params, problem.torch_initial,
            problem.system_eval_count, lindblad_data=problem.torch_lindblad,
            optimizer=qoc_tpu_torch.Adam(learning_rate=0.05), device="cpu",
            **common)
    else:
        one_device = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                          ("candidate", "ensemble"))
        common.update(n_starts=2, seed=3,
                      hamiltonian_params=problem.params)
        want = qoc_tpu.parallel.grape_lindblad_multistart(
            *args, problem.jax_costs, problem.evolution_time,
            problem.initial, problem.system_eval_count,
            hamiltonian=problem.jax_hamiltonian,
            lindblad_data=problem.jax_lindblad, mesh=one_device,
            optimizer=qoc_tpu.optim.Adam(learning_rate=0.05), **common)
        got = qoc_tpu_torch.grape_lindblad_multistart(
            *args, problem.torch_costs, problem.evolution_time,
            problem.torch_initial, problem.system_eval_count,
            hamiltonian=problem.torch_hamiltonian,
            lindblad_data=problem.torch_lindblad,
            optimizer=qoc_tpu_torch.Adam(learning_rate=0.05), device="cpu",
            **common)
        np.testing.assert_allclose(got.errors, np.asarray(want.errors),
                                   rtol=0, atol=1e-7)
    assert got.iteration_count_ran == 2
    assert got.best_final_densities.shape == (n_members, 1, 2, 2)
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=1e-7)
    assert got.best_iteration == want.best_iteration
    assert got.best_error == pytest.approx(want.best_error, abs=1e-7)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.best_final_densities,
                               np.asarray(want.best_final_densities),
                               rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def _refusals(directory):
    """case: (exception, match, kwargs), or (None, None, kwargs) for a run
    whose save rows are checked."""
    from qoc_tpu_torch.models import LindbladMethod
    magnus = dict(method=LindbladMethod.MAGNUS_EXPM)
    return {
        "mesh": (NotImplementedError, "Queue 1 item 8",
                 dict(mesh=object(), **magnus)),
        "save_file_path": (None, None, dict(
            save_file_path=str(directory / "run.h5"), save_iteration_step=1,
            **magnus)),
        "resume_from": (ValueError, "not a GRAPE save file", dict(
            resume_from=not_a_grape_file(directory), **magnus)),
    }


@pytest.mark.parametrize("entry", ("ensemble", "multistart"))
@pytest.mark.parametrize("case", ("mesh", "resume_from", "save_file_path"))
def test_lindblad_parallel_refusals(entry, case, tmp_path):
    """``mesh`` raises, naming ROADMAP Queue 1 item 8; a save file gets its
    rows; a resume_from without GRAPE rows is refused as in qoc_tpu."""
    import qoc_tpu_torch
    error, match, kwargs = _refusals(tmp_path)[case]
    problem = LindbladEnsembleProblem(n_members=2)
    args = (1, problem.control_eval_count, problem.torch_costs,
            problem.evolution_time)
    common = dict(complex_controls=True, iteration_count=1,
                  log_iteration_step=0, lindblad_data=problem.torch_lindblad,
                  device="cpu", **kwargs)

    def run():
        if entry == "ensemble":
            return qoc_tpu_torch.grape_lindblad_ensemble(
                *args, problem.torch_hamiltonian, problem.params,
                problem.torch_initial, problem.system_eval_count, **common)
        return qoc_tpu_torch.grape_lindblad_multistart(
            *args, problem.torch_initial, problem.system_eval_count,
            n_starts=2, hamiltonian=problem.torch_hamiltonian,
            hamiltonian_params=problem.params, **common)

    if error is None:
        result = run()
        want = (result.errors if entry == "ensemble"
                else [min(result.errors)])
        np.testing.assert_array_equal(
            saved_errors(kwargs["save_file_path"]), want)
        return
    with pytest.raises(error, match=match):
        run()
