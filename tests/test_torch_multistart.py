"""The port's multistart against qoc_tpu's (float64, CPU): candidate_seeds,
the per-candidate Adam, grape_schroedinger_multistart with 8 candidates,
with 4 candidates x 2 ensemble members, and stopped early at min_error,
and the refusals. On the CPU qoc_tpu takes its generic route, the port its
fused route (K1/K2's member axis on the card). Tolerances of
tests/test_torch_schroedinger.py: errors 1e-6, controls 1e-5, states
1e-6."""

import numpy as np
import pytest
import torch

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import (EnsembleProblem, Problem, not_a_grape_file,
                          saved_errors)

torch.set_num_threads(1)

_N_STARTS = 8
_ITERATIONS = 5


def test_candidate_seeds_match_jax():
    from qoc_tpu.parallel._msrunner import candidate_seeds as jax_seeds
    from qoc_tpu_torch.parallel._msrunner import candidate_seeds
    problem = Problem()
    want = jax_seeds(problem.jax_pstate(), _N_STARTS, 7)
    got = candidate_seeds(problem.torch_pstate(), _N_STARTS, 7)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(want))


def test_adam_update_batch_matches_per_candidate_updates():
    """Each candidate keeps its own step count, moments and learning-rate
    decay; a frozen candidate keeps its parameters and its state."""
    from qoc_tpu_torch.optim import Adam
    rng = np.random.default_rng(2)
    adam = Adam(learning_rate=0.1, learning_rate_decay=4.0, scale_grads=2.0)
    params = torch.as_tensor(rng.normal(size=(3, 5)))
    state = adam.init_state_batch(params)
    state["t"] = torch.tensor([0, 3, 7], dtype=torch.int32)
    grads = torch.as_tensor(rng.normal(size=(3, 5)))
    frozen = torch.tensor([False, True, False])
    new_state, new_params = adam.update_batch(state, grads, params, frozen)
    for c in range(3):
        one = {key: value[c] for key, value in state.items()}
        want_state, want = adam.update(one, grads[c], params[c])
        if frozen[c]:
            want_state, want = one, params[c]
        np.testing.assert_allclose(new_params[c].numpy(), want.numpy(),
                                   rtol=0, atol=1e-15)
        for key in state:
            np.testing.assert_allclose(new_state[key][c].numpy(),
                                       want_state[key].numpy(), rtol=0,
                                       atol=1e-15)


def _multistart_both(problem, n_starts, params=None, jax_mesh=None,
                     **kwargs):
    """qoc_tpu's and the port's multistart on the same problem; qoc_tpu on
    ``jax_mesh`` (default: its own, over the 8 virtual CPU devices)."""
    import qoc_tpu
    import qoc_tpu_torch
    common = dict(n_starts=n_starts, complex_controls=True,
                  initial_controls=problem.controls,
                  max_control_norms=problem.max_control_norms,
                  log_iteration_step=0, seed=3, hamiltonian_params=params,
                  **kwargs)
    want = qoc_tpu.parallel.grape_schroedinger_multistart(
        problem.n_c, problem.n_steps, problem.jax_costs,
        problem.evolution_time, problem.jax_hamiltonian, problem.initial,
        problem.n_steps, optimizer=qoc_tpu.optim.Adam(learning_rate=0.05),
        mesh=jax_mesh, **common)
    got = qoc_tpu_torch.grape_schroedinger_multistart(
        problem.n_c, problem.n_steps, problem.torch_costs,
        problem.evolution_time, problem.torch_hamiltonian,
        problem.torch_initial, problem.n_steps,
        optimizer=qoc_tpu_torch.Adam(learning_rate=0.05), device="cpu",
        **common)
    return want, got


def _assert_same_run(want, got):
    assert got.iteration_count_ran == want.iteration_count_ran
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=1e-6)
    assert int(np.argmin(got.errors)) == int(np.argmin(want.errors))
    assert got.best_iteration == want.best_iteration
    assert got.best_error == pytest.approx(want.best_error, abs=1e-6)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.best_final_states,
                               np.asarray(want.best_final_states), rtol=0,
                               atol=1e-6)


def test_multistart_matches_jax():
    """8 candidates, 5 iterations: every candidate's best error, the
    winner, its controls, its best iteration and final states."""
    problem = Problem(n_steps=20)
    want, got = _multistart_both(problem, _N_STARTS,
                                 iteration_count=_ITERATIONS)
    assert got.iteration_count_ran == _ITERATIONS
    assert got.errors.shape == (_N_STARTS,)
    assert got.best_final_states.shape == (1, problem.d, 1)
    assert got.iterations_per_s > 0
    _assert_same_run(want, got)


def test_robust_multistart_matches_jax():
    """4 candidates x 2 members of an EnsembleLinearHamiltonian: each
    candidate optimizes the members' mean error; the winner's final
    states keep the member axis."""
    import jax
    from jax.sharding import Mesh
    problem = EnsembleProblem(n_members=2, n_steps=20)
    one_device = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                      ("candidate", "ensemble"))
    want, got = _multistart_both(problem, 4, params=problem.params,
                                 jax_mesh=one_device,
                                 iteration_count=_ITERATIONS)
    assert got.best_final_states.shape == (2, 1, problem.d, 1)
    _assert_same_run(want, got)


def test_multistart_stops_at_min_error():
    """A candidate that reaches min_error is frozen and the run stops at
    the end of that chunk (fused_chunk 2: 4 of 5 iterations run), in both
    packages."""
    import qoc_tpu_torch
    problem = Problem(n_steps=20)
    bests = []
    for iterations in (2, 3):
        result = qoc_tpu_torch.grape_schroedinger_multistart(
            problem.n_c, problem.n_steps, problem.torch_costs,
            problem.evolution_time, problem.torch_hamiltonian,
            problem.torch_initial, problem.n_steps, n_starts=_N_STARTS,
            complex_controls=True, initial_controls=problem.controls,
            max_control_norms=problem.max_control_norms,
            iteration_count=iterations, log_iteration_step=0, seed=3,
            optimizer=qoc_tpu_torch.Adam(learning_rate=0.05), device="cpu")
        bests.append(result.best_error)
    assert bests[1] < bests[0]
    min_error = 0.5 * (bests[0] + bests[1])
    want, got = _multistart_both(problem, _N_STARTS,
                                 iteration_count=_ITERATIONS,
                                 min_error=min_error, fused_chunk=2)
    assert got.iteration_count_ran == 4
    assert got.best_error <= min_error
    _assert_same_run(want, got)


def _multistart_refusals(directory):
    """case: (exception, match, kwargs), or (None, None, kwargs) for a run
    whose save rows are checked."""
    import qoc_tpu_torch
    problem = EnsembleProblem()
    return problem, {
        "mesh": (NotImplementedError, "Queue 1 item 8",
                 dict(mesh=object())),
        "save_file_path": (None, None,
                           dict(save_file_path=str(directory / "run.h5"),
                                save_iteration_step=1)),
        "resume_from": (ValueError, "not a GRAPE save file",
                        dict(resume_from=not_a_grape_file(directory))),
        "optimizer": (ValueError, "LBFGSB is host-loop only",
                      dict(optimizer=qoc_tpu_torch.LBFGSB())),
        "ensemble without params": (
            ValueError, "needs hamiltonian_params",
            dict(hamiltonian=problem.torch_hamiltonian)),
    }


@pytest.mark.parametrize("case", ("ensemble without params", "mesh",
                                  "optimizer", "resume_from",
                                  "save_file_path"))
def test_multistart_refusals(case, tmp_path):
    """The refusals that stand (mesh, a host-loop-only optimizer, an
    ensemble Hamiltonian without member rows, a resume_from without GRAPE
    rows); a save file gets its winner rows."""
    import qoc_tpu_torch
    problem, refusals = _multistart_refusals(tmp_path)
    error, match, kwargs = refusals[case]
    kwargs.setdefault("hamiltonian", problem.torch_hamiltonian)
    kwargs.setdefault("hamiltonian_params",
                      None if case == "ensemble without params"
                      else problem.params)
    hamiltonian = kwargs.pop("hamiltonian")

    def run():
        return qoc_tpu_torch.grape_schroedinger_multistart(
            problem.n_c, problem.n_steps, problem.torch_costs,
            problem.evolution_time, hamiltonian, problem.torch_initial,
            problem.n_steps, n_starts=2, complex_controls=True,
            iteration_count=1, log_iteration_step=0, device="cpu", **kwargs)

    if error is None:
        # The winner's row: the best candidate's error at iteration 0.
        best = min(run().errors)
        np.testing.assert_array_equal(
            saved_errors(kwargs["save_file_path"]), [best])
        return
    with pytest.raises(error, match=match):
        run()
