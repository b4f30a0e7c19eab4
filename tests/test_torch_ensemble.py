"""The port's ensembles against qoc_tpu's (float64, CPU): the chain op's
member axis against per-member single-chain calls, EnsembleLinearHamiltonian,
build_ensemble_loss on the fused route (K1/K2's member axis on the card) and
the blocked route (M4 and a torch callable; K3/K4 on the card), and
grape_schroedinger_ensemble. On the CPU qoc_tpu takes its generic route
(no Pallas), so every comparison is with qoc_tpu's vmapped Magnus + expm
loss. Tolerances of tests/test_torch_schroedinger.py: errors 1e-6,
controls 1e-5, states 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import (EnsembleProblem, anti_hermitian_basis,
                          not_a_grape_file, saved_errors)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The chain op's member axis
# ---------------------------------------------------------------------------


def _member_weights(rng, n_members, n_steps, n_b):
    """Weight rows of chains that differ, every member's batch-max 1-norm
    on the same ladder level as the batch's (degree 8 here), so a member
    run alone takes the ladder the batch takes."""
    base = rng.normal(size=(n_steps, n_b))
    return np.stack([base * (1 + 0.1 * m)
                     + 0.2 * rng.normal(size=(n_steps, n_b))
                     for m in range(n_members)])


def _basis_at(rng, w, norm, d=3):
    """An anti-Hermitian basis scaled so the weights' batch-max generator
    1-norm is ``norm``."""
    basis = anti_hermitian_basis(rng, w.shape[-1], d)
    a = np.einsum("...k,kab->...ab", w.numpy(), basis)
    return basis * (norm / np.abs(a).sum(-2).max())


@pytest.mark.parametrize("trajectory", (False, True))
@pytest.mark.parametrize("n_members,n_steps,segments", (
    (3, 40, 5), (2, 21, 3), (5, 8, 1), (70, 9, 1)))
def test_chain_member_axis_matches_single_chains(n_members, n_steps,
                                                 segments, trajectory):
    """Totals, prefixes and the weight gradient of M chains in one call equal
    each member run alone, with S_m > 1 segments a chain (merge and seeds
    with a member axis) and S_m = 1 (qoc_tpu's grouped packing), in the
    last-step and the per-step seed mode."""
    from qoc_tpu_torch.ops import chain
    assert chain.segment_plan(n_steps, n_members)[0] == segments
    rng = np.random.default_rng(n_members + n_steps)
    d, n_b = 3, 4
    w = torch.as_tensor(_member_weights(rng, n_members, n_steps, n_b))
    basis = _basis_at(rng, w, 0.4)
    op = chain.ChainExpmPropagate(basis, "cpu", torch.float64,
                                  return_prefixes=trajectory)
    levels = {chain.ladder_level(chain._norm_max(x, op.basis_ri, 3)[0])
              for x in (w, *w)}
    assert levels == {1}
    g_total = torch.as_tensor(rng.normal(size=(n_members, d, d))
                              + 1j * rng.normal(size=(n_members, d, d)))
    g_pref = torch.as_tensor(rng.normal(size=(n_members, n_steps, d, d))
                             + 1j * rng.normal(size=(n_members, n_steps, d,
                                                     d)))

    def run(x, g_t, g_p):
        x = x.clone().requires_grad_(True)
        out = op(x)
        grads = (g_t, g_p) if trajectory else g_t
        grad, = torch.autograd.grad(out, x, grads)
        outs = out if trajectory else (out,)
        return [o.detach() for o in outs] + [grad]

    batched = run(w, g_total, g_pref)
    for m in range(n_members):
        alone = run(w[m], g_total[m], g_pref[m])
        for got, want in zip(batched, alone):
            np.testing.assert_allclose(got[m].numpy(), want.numpy(),
                                       rtol=0, atol=1e-12)


def test_chain_member_axis_keeps_chains_apart():
    """Members whose chains differ give different totals (no scan mixes
    two chains), and a 2-D weight array is the one-member case."""
    from qoc_tpu_torch.ops import chain
    rng = np.random.default_rng(3)
    w = torch.as_tensor(_member_weights(rng, 4, 30, 4))
    basis = _basis_at(rng, w, 0.4)
    op = chain.ChainExpmPropagate(basis, "cpu", torch.float64)
    totals = op(w)
    assert totals.shape == (4, 3, 3)
    assert float((totals[0] - totals[1]).abs().max()) > 1e-3
    np.testing.assert_array_equal(op(w[2:3])[0].numpy(), op(w[2]).numpy())


def test_chain_block_plan_counts_chains():
    from qoc_tpu_torch.ops.chain import chain_block_plan
    one = chain_block_plan(64, 200)
    assert one == 200
    assert chain_block_plan(64, 200, n_chains=512) == 64
    assert chain_block_plan(64, 200, n_chains=2048) == 16


# ---------------------------------------------------------------------------
# EnsembleLinearHamiltonian
# ---------------------------------------------------------------------------


def test_ensemble_hamiltonian_matches_jax():
    """hermitian_basis (δ columns after h0), generator_basis, the member
    Hamiltonians and superoperator_basis equal qoc_tpu's."""
    import qoc_tpu_torch
    problem = EnsembleProblem(n_members=3)
    jax_ham, ham = problem.jax_hamiltonian, problem.torch_hamiltonian
    assert isinstance(ham, qoc_tpu_torch.EnsembleLinearHamiltonian)
    assert ham.param_count == 2
    np.testing.assert_allclose(ham.hermitian_basis(),
                               jax_ham.hermitian_basis(), rtol=0, atol=0)
    np.testing.assert_allclose(ham.generator_basis(0.1),
                               jax_ham.generator_basis(0.1), rtol=0,
                               atol=0)
    rates, lops = np.array([0.05]), np.ones((1, 3, 3)) + 0j
    np.testing.assert_allclose(ham.superoperator_basis(0.1, rates, lops),
                               jax_ham.superoperator_basis(0.1, rates, lops),
                               rtol=0, atol=1e-15)
    controls = problem.controls[0]
    for row in problem.params:
        want = np.asarray(jax_ham.member(jnp.asarray(row))(
            jnp.asarray(controls), 0.3))
        got = ham.member(torch.as_tensor(row))(torch.as_tensor(controls),
                                                torch.tensor(0.3))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match="Hermitian"):
        qoc_tpu_torch.EnsembleLinearHamiltonian(
            problem.h0, problem.ops, np.ones((1, 3, 3)) * 1j)


# ---------------------------------------------------------------------------
# build_ensemble_loss
# ---------------------------------------------------------------------------


# (members, magnus, step costs, callable) -> the route the port takes;
# "alone": the step costs without the final cost.
_LOSS_CASES = {
    (2, "M2", False, False): "fused",
    (9, "M2", True, False): "fused",
    (3, "M2", "alone", False): "fused",
    (2, "M4", True, False): "blocked",
    (9, "M4", False, False): "blocked",
    (2, "M2", True, True): "blocked",
    (9, "M2", False, True): "blocked",
}


def _problem(n_members, step_costs, callables, **sizes):
    problem = EnsembleProblem(n_members=n_members, **sizes)
    if step_costs:
        problem.add_step_costs()
    if step_costs == "alone":
        problem.jax_costs = problem.jax_costs[1:]
        problem.torch_costs = problem.torch_costs[1:]
    if callables:
        problem.use_callables()
    return problem


def _jax_loss(n_members, magnus, step_costs, callables, **sizes):
    """qoc_tpu's ensemble loss, value, gradient (w.r.t. the flat real
    controls) and member final states, at the problem's controls
    (``sizes``: EnsembleProblem's d, n_c, n_steps, evolution_time)."""
    from qoc_tpu.core.common import slap_controls_jax, strip_controls
    from qoc_tpu.parallel import build_ensemble_loss, make_mesh
    problem = _problem(n_members, step_costs, callables, **sizes)
    pstate = problem.jax_pstate(magnus=magnus)
    loss = build_ensemble_loss(pstate, problem.jax_hamiltonian,
                               problem.params, make_mesh(1))
    shape = pstate.controls_shape
    (error, states), grad = jax.jit(jax.value_and_grad(
        lambda x: loss(slap_controls_jax(True, x, shape)), has_aux=True))(
            jnp.asarray(strip_controls(True, problem.controls)))
    return float(error), np.asarray(grad), np.asarray(states)


@pytest.mark.parametrize("case", sorted(_LOSS_CASES, key=str))
def test_build_ensemble_loss_matches_jax(case):
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.parallel import build_ensemble_loss
    n_members, magnus, step_costs, callables = case
    problem = _problem(n_members, step_costs, callables)
    pstate = problem.torch_pstate(magnus=magnus)
    loss = build_ensemble_loss(pstate, problem.torch_hamiltonian,
                               problem.params, device="cpu")
    assert loss.uses_fused_chain == (_LOSS_CASES[case] == "fused")
    flat = torch.as_tensor(strip_controls(True, problem.controls))
    flat.requires_grad_(True)
    error, states = loss(slap_controls_torch(True, flat,
                                             pstate.controls_shape))
    grad, = torch.autograd.grad(error, flat)
    want_error, want_grad, want_states = _jax_loss(*case)
    assert states.shape == (n_members, 1, problem.d, 1)
    assert float(error.detach()) == pytest.approx(want_error, abs=1e-6)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0, atol=1e-6)
    np.testing.assert_allclose(states.detach().numpy(), want_states,
                               rtol=0, atol=1e-6)


def test_ensemble_path_log_names_route_and_packing(capsys):
    from qoc_tpu_torch.parallel import build_ensemble_loss
    problem = EnsembleProblem(n_members=9)
    build_ensemble_loss(problem.torch_pstate(), problem.torch_hamiltonian,
                        problem.params, device="cpu", log_path=True)
    out = capsys.readouterr().out
    assert "ensemble propagation path = fused chain" in out
    assert "9 chains, segmented, 3 segments a chain" in out


# ---------------------------------------------------------------------------
# grape_schroedinger_ensemble
# ---------------------------------------------------------------------------


def test_grape_ensemble_matches_jax():
    """5 Adam iterations of robust GRAPE: per-iteration errors, the best
    controls, error and iteration, and the members' final states."""
    import qoc_tpu
    import qoc_tpu_torch
    from qoc_tpu.parallel import make_mesh
    problem = EnsembleProblem(n_members=3)
    kwargs = dict(complex_controls=True, iteration_count=5,
                  log_iteration_step=0, initial_controls=problem.controls,
                  max_control_norms=problem.max_control_norms)
    want = qoc_tpu.parallel.grape_schroedinger_ensemble(
        problem.n_c, problem.n_steps, problem.jax_costs,
        problem.evolution_time, problem.jax_hamiltonian, problem.params,
        problem.initial, problem.n_steps, mesh=make_mesh(1),
        optimizer=qoc_tpu.optim.Adam(learning_rate=0.05), **kwargs)
    got = qoc_tpu_torch.grape_schroedinger_ensemble(
        problem.n_c, problem.n_steps, problem.torch_costs,
        problem.evolution_time, problem.torch_hamiltonian, problem.params,
        problem.torch_initial, problem.n_steps,
        optimizer=qoc_tpu_torch.Adam(learning_rate=0.05), device="cpu",
        **kwargs)
    assert got.iteration_count_ran == 5
    np.testing.assert_allclose(got.errors, np.asarray(want.errors), rtol=0,
                               atol=1e-6)
    assert got.best_iteration == want.best_iteration
    assert got.best_error == pytest.approx(want.best_error, abs=1e-6)
    np.testing.assert_allclose(got.best_controls, want.best_controls,
                               rtol=0, atol=1e-5)
    assert got.best_final_states.shape == (3, 1, problem.d, 1)
    np.testing.assert_allclose(got.best_final_states,
                               np.asarray(want.best_final_states), rtol=0,
                               atol=1e-6)


def _ensemble_refusals(directory):
    """case: (exception, match, kwargs), or (None, None, kwargs) for a run
    whose save rows are checked."""
    return {
        "mesh": (NotImplementedError, "Queue 1 item 8", dict(mesh=object())),
        "save_file_path": (None, None,
                           dict(save_file_path=str(directory / "run.h5"),
                                save_iteration_step=1)),
        "resume_from": (ValueError, "not a GRAPE save file",
                        dict(resume_from=not_a_grape_file(directory))),
    }


@pytest.mark.parametrize("case", ("mesh", "resume_from", "save_file_path"))
def test_grape_ensemble_refusals(case, tmp_path):
    """``mesh`` raises, naming ROADMAP Queue 1 item 8; a save file gets its
    rows; a resume_from without GRAPE rows is refused as in qoc_tpu."""
    import qoc_tpu_torch
    error, match, kwargs = _ensemble_refusals(tmp_path)[case]
    problem = EnsembleProblem()

    def run():
        return qoc_tpu_torch.grape_schroedinger_ensemble(
            problem.n_c, problem.n_steps, problem.torch_costs,
            problem.evolution_time, problem.torch_hamiltonian,
            problem.params, problem.torch_initial, problem.n_steps,
            complex_controls=True, iteration_count=1, log_iteration_step=0,
            device="cpu", **kwargs)

    if error is None:
        errors = run().errors
        np.testing.assert_array_equal(
            saved_errors(kwargs["save_file_path"]), errors)
        return
    with pytest.raises(error, match=match):
        run()


def test_ensemble_stream_range_matches_jax(capsys):
    """At 256 < padded d <= 512 the fused ensemble takes the streamed
    route, both members' chains on the plane op's member axis (K6's on the
    card): d = 260, 2 members x 2 steps, loss, control gradient and member
    final states against qoc_tpu's. Folding the members into one chain of
    4 steps would fail here."""
    from qoc_tpu_torch.core.common import slap_controls_torch, strip_controls
    from qoc_tpu_torch.parallel import build_ensemble_loss
    problem = EnsembleProblem(n_members=2, d=260, n_c=1, n_steps=3,
                              evolution_time=0.01)
    pstate = problem.torch_pstate()
    loss = build_ensemble_loss(pstate, problem.torch_hamiltonian,
                               problem.params, log_path=True, device="cpu")
    assert loss.route == "stream" and loss.uses_fused_chain
    assert ("streamed chain, plain torch on cpu (member-batched: 2 chains, "
            "segmented, 2 segments a chain" in capsys.readouterr().out)
    flat = torch.as_tensor(strip_controls(True, problem.controls))
    flat.requires_grad_(True)
    error, states = loss(slap_controls_torch(True, flat,
                                             pstate.controls_shape))
    grad, = torch.autograd.grad(error, flat)
    want_error, want_grad, want_states = _jax_loss(2, "M2", False, False,
                                                   d=260, n_c=1, n_steps=3,
                                                   evolution_time=0.01)
    assert states.shape == (2, 1, 260, 1)
    assert float(error.detach()) == pytest.approx(want_error, abs=1e-6)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0, atol=1e-6)
    np.testing.assert_allclose(states.detach().numpy(), want_states,
                               rtol=0, atol=1e-6)
