"""The port's save files, resume and plots (qoc_tpu_torch/io/, the runners'
save and resume branches, plot.py, standard.py) against qoc_tpu's, on the
CPU in float64, both packages in one process.

- GRAPE and evolve files, Schrödinger and Lindblad, with intermediate rows:
  the same datasets (the optimizer_state group included), shapes and
  dtypes as qoc_tpu's file of the same call, every number within 1e-10.
- Each package's load_controls / load_best_controls reads the other's
  file; each resumes the other's Adam checkpoint at iteration 2 and then
  equals the other's uninterrupted run within 1e-10; the port killed and
  resumed into its own file (grown rows) equals its uninterrupted run.
- The host loop's checkpoint (``host_`` keys; LBFGSB's, as qoc_tpu writes
  it, without), the multistart's checkpoint and winner rows, the kind
  refusals, and plots of port-written files by both packages (Agg).

Each qoc_tpu reference is computed once (``functools.cache``); the files
live in one temporary directory of the test process.
"""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from torch_parity import one_blas_thread  # noqa: F401 (autouse)
from torch_parity import EnsembleProblem, LindbladProblem, Problem

torch.set_num_threads(1)

ITERATIONS = 4
RESUME_AT = 2
CHUNK = 2
MS_ITERATIONS = 4
ROW_TOL = 1e-10


@functools.cache
def _dir():
    return tempfile.mkdtemp(prefix="qoc_tpu_torch_io_")


def _path(name):
    return os.path.join(_dir(), name)


def _datasets(path):
    """{name: array} of every dataset in the file, groups walked."""
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_file(got_path, want_path, tol=ROW_TOL):
    got, want = _datasets(got_path), _datasets(want_path)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g, w = np.asarray(got[name]), np.asarray(w)
        assert (g.shape, g.dtype) == (w.shape, w.dtype), name
        if w.dtype.kind in "fc":
            scale = max(1.0, float(np.max(np.abs(w)))) if w.size else 1.0
            assert float(np.max(np.abs(g - w), initial=0.0)) <= tol * scale, \
                name
        else:
            assert np.array_equal(g, w), name


@functools.cache
def _schroedinger():
    return Problem(n_steps=20)


def _grape(package, path, iteration_count=ITERATIONS, **kwargs):
    """The Schrödinger GRAPE of the tests: Adam, a save row every
    iteration, chunks of 2 (snapshots at 2 and 4; one chunk length, one
    compile of qoc_tpu's loop)."""
    pr = _schroedinger()
    kwargs = dict(dict(complex_controls=True, log_iteration_step=0,
                       save_iteration_step=1, fused_chunk=CHUNK,
                       save_file_path=path, iteration_count=iteration_count,
                       initial_controls=pr.controls,
                       max_control_norms=pr.max_control_norms), **kwargs)
    if package == "jax":
        import qoc_tpu
        return qoc_tpu.grape_schroedinger_discrete(
            pr.n_c, pr.n_steps, pr.jax_costs, pr.evolution_time,
            pr.jax_hamiltonian, pr.initial, pr.n_steps, **kwargs)
    import qoc_tpu_torch
    return qoc_tpu_torch.grape_schroedinger_discrete(
        pr.n_c, pr.n_steps, pr.torch_costs, pr.evolution_time,
        pr.torch_hamiltonian, pr.torch_initial, pr.n_steps, device="cpu",
        **kwargs)


@functools.cache
def _full(package):
    """(file, result) of the uninterrupted run, intermediate states saved."""
    path = _path(package + "_full.h5")
    return path, _grape(package, path, save_intermediate_states=True)


@functools.cache
def _stopped(package):
    """The file of a run stopped after RESUME_AT iterations (its checkpoint
    at iteration 2)."""
    path = _path(package + "_stopped.h5")
    _grape(package, path, iteration_count=RESUME_AT)
    return path


@functools.cache
def _lindblad():
    return LindbladProblem(n_steps=8)


def _lindblad_grape(package, path):
    """The Lindblad GRAPE of the tests: LBFGSB() on the host loop under
    MAGNUS_EXPM, intermediate densities saved, 3 iterations."""
    pr = _lindblad()
    kwargs = dict(complex_controls=True, iteration_count=3,
                  log_iteration_step=0, save_iteration_step=1,
                  save_file_path=path, save_intermediate_densities=True,
                  initial_controls=pr.controls,
                  max_control_norms=pr.max_control_norms)
    if package == "jax":
        import qoc_tpu
        from qoc_tpu.models import LindbladMethod
        return qoc_tpu.grape_lindblad_discrete(
            pr.n_c, pr.n_steps, pr.jax_costs, pr.evolution_time, pr.initial,
            pr.n_steps, hamiltonian=pr.jax_hamiltonian,
            lindblad_data=pr.jax_lindblad, optimizer=qoc_tpu.optim.LBFGSB(),
            method=LindbladMethod.MAGNUS_EXPM, **kwargs)
    import qoc_tpu_torch
    from qoc_tpu_torch.models import LindbladMethod
    return qoc_tpu_torch.grape_lindblad_discrete(
        pr.n_c, pr.n_steps, pr.torch_costs, pr.evolution_time,
        pr.torch_initial, pr.n_steps, hamiltonian=pr.torch_hamiltonian,
        lindblad_data=pr.torch_lindblad, optimizer=qoc_tpu_torch.LBFGSB(),
        method=LindbladMethod.MAGNUS_EXPM, device="cpu", **kwargs)


def _evolve(package, kind, path):
    """evolve_schroedinger_discrete / evolve_lindblad_discrete (MAGNUS_EXPM)
    of the test problems with their controls, intermediates saved."""
    import qoc_tpu
    import qoc_tpu_torch
    if kind == "schroedinger":
        pr = _schroedinger()
        if package == "jax":
            return qoc_tpu.evolve_schroedinger_discrete(
                pr.evolution_time, pr.jax_hamiltonian, pr.initial,
                pr.n_steps, controls=pr.controls, costs=pr.jax_costs,
                save_file_path=path, save_intermediate_states=True)
        return qoc_tpu_torch.evolve_schroedinger_discrete(
            pr.evolution_time, pr.torch_hamiltonian, pr.torch_initial,
            pr.n_steps, controls=pr.controls, costs=pr.torch_costs,
            save_file_path=path, save_intermediate_states=True,
            device="cpu")
    pr = _lindblad()
    if package == "jax":
        from qoc_tpu.models import LindbladMethod
        return qoc_tpu.evolve_lindblad_discrete(
            pr.evolution_time, pr.initial, pr.n_steps, controls=pr.controls,
            costs=pr.jax_costs, hamiltonian=pr.jax_hamiltonian,
            lindblad_data=pr.jax_lindblad, save_file_path=path,
            save_intermediate_densities=True,
            method=LindbladMethod.MAGNUS_EXPM)
    from qoc_tpu_torch.models import LindbladMethod
    return qoc_tpu_torch.evolve_lindblad_discrete(
        pr.evolution_time, pr.torch_initial, pr.n_steps,
        controls=pr.controls, costs=pr.torch_costs,
        hamiltonian=pr.torch_hamiltonian, lindblad_data=pr.torch_lindblad,
        save_file_path=path, save_intermediate_densities=True,
        method=LindbladMethod.MAGNUS_EXPM, device="cpu")


@pytest.mark.parametrize("kind", ("schroedinger adam", "lindblad lbfgsb"))
def test_grape_file_matches_qoc_tpu(kind):
    """The same call writes the same file: datasets, shapes, dtypes and
    every number (rows, intermediate rows, the optimizer snapshot; the
    host loop's LBFGSB checkpoint holds params and iteration only)."""
    if kind == "schroedinger adam":
        got, want = _full("torch")[0], _full("jax")[0]
    else:
        got, want = _path("torch_lindblad.h5"), _path("jax_lindblad.h5")
        _lindblad_grape("torch", got)
        _lindblad_grape("jax", want)
        assert {key for key in _datasets(got)
                if key.startswith("optimizer_state/")} == {
            "optimizer_state/__params__", "optimizer_state/__iteration__",
            "optimizer_state/checkpoint_kind"}
    _assert_same_file(got, want)


@pytest.mark.parametrize("kind", ("schroedinger", "lindblad"))
def test_evolve_file_matches_qoc_tpu(kind):
    got, want = _path("torch_evolve.h5"), _path("jax_evolve.h5")
    result = _evolve("torch", kind, got)
    _evolve("jax", kind, want)
    _assert_same_file(got, want)
    key = ("intermediate_states" if kind == "schroedinger"
           else "intermediate_densities")
    np.testing.assert_array_equal(_datasets(got)[key],
                                  getattr(result, key))


@pytest.mark.parametrize("reader", ("torch", "jax"))
def test_load_controls_reads_the_other_package(reader):
    """Each package's load_controls and load_best_controls on the other's
    file: the rows of that file."""
    writer = "jax" if reader == "torch" else "torch"
    if reader == "torch":
        from qoc_tpu_torch.io import load_best_controls, load_controls
    else:
        from qoc_tpu.io import load_best_controls, load_controls
    path, result = _full(writer)
    data = _datasets(path)
    controls, error = load_controls(path, save_index=3)
    np.testing.assert_array_equal(controls, data["controls"][3])
    assert error == data["error"][3]
    controls, error, index = load_best_controls(path)
    assert index == int(np.argmin(data["error"])) == result.best_iteration
    assert error == pytest.approx(result.best_error, abs=1e-12)
    np.testing.assert_allclose(controls, result.best_controls, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("direction", ("torch resumes jax",
                                       "jax resumes torch"))
def test_resume_the_other_package_checkpoint(direction):
    """Each package resumes the other's Adam checkpoint at iteration 2
    (params, m, v, t) and then runs the other's uninterrupted trajectory:
    errors and rows within 1e-10."""
    writer, runner = (("jax", "torch") if direction == "torch resumes jax"
                      else ("torch", "jax"))
    path = _path("{}_resumed.h5".format(runner))
    result = _grape(runner, path, resume_from=_stopped(writer))
    full_path, full = _full(writer)
    assert result.iteration_count_ran == ITERATIONS - RESUME_AT
    np.testing.assert_allclose(result.errors, np.asarray(full.errors)[
        RESUME_AT:], rtol=0, atol=ROW_TOL)
    got, want = _datasets(path), _datasets(full_path)
    for key in ("controls", "error", "grads", "final_states"):
        np.testing.assert_allclose(got[key][RESUME_AT:],
                                   want[key][RESUME_AT:], rtol=0,
                                   atol=ROW_TOL)
    assert got["optimizer_state/opt['t']"] == ITERATIONS


def test_kill_and_resume_into_the_same_file():
    """The port stopped at iteration 2 and resumed into its own file with
    iteration_count 5: the rows grow from 2 to 5, and the file equals the
    uninterrupted run's (intermediate rows aside, which that run saved)."""
    path = _path("torch_killed.h5")
    _grape("torch", path, iteration_count=RESUME_AT)
    assert _datasets(path)["error"].shape == (RESUME_AT,)
    result = _grape("torch", path, resume_from=path)
    full_path, full = _full("torch")
    np.testing.assert_array_equal(result.errors,
                                  np.asarray(full.errors)[RESUME_AT:])
    got, want = _datasets(path), _datasets(full_path)
    for key in set(want) - {"intermediate_states"}:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("dtypes", ("float64 into float32",
                                    "float32 into float64"))
def test_resume_across_dtypes(dtypes):
    """A checkpoint written in one float dtype resumes in the other (the
    CPU's float64 and the card's float32): the params and Adam's state are
    cast, and the resumed errors follow the uninterrupted float64 run to
    float32's accuracy."""
    written, resumed = ((torch.float64, torch.float32)
                        if dtypes.startswith("float64")
                        else (torch.float32, torch.float64))
    path = _path("torch_{}.h5".format(written).replace("torch.", ""))
    _grape("torch", path, iteration_count=RESUME_AT, dtype=written)
    result = _grape("torch", None, save_iteration_step=0, resume_from=path,
                    dtype=resumed)
    full = _full("torch")[1]
    assert result.iteration_count_ran == ITERATIONS - RESUME_AT
    np.testing.assert_allclose(result.errors,
                               np.asarray(full.errors)[RESUME_AT:],
                               rtol=1e-5, atol=0)


def test_host_loop_checkpoint_resumes():
    """Adam through an identity impose_control_conditions hook (the host
    loop): its snapshot carries the numpy twin's state under ``host_``,
    and a run stopped at iteration 2 and resumed equals the uninterrupted
    one."""
    hook = dict(impose_control_conditions=lambda c: c)
    full_path = _path("torch_host_full.h5")
    full = _grape("torch", full_path, **hook)
    keys = {key for key in _datasets(full_path)
            if key.startswith("optimizer_state/")}
    assert {"optimizer_state/host_gradient_moment",
            "optimizer_state/host_gradient_square_moment",
            "optimizer_state/host_iteration_count"} <= keys
    stopped = _path("torch_host_stopped.h5")
    _grape("torch", stopped, iteration_count=RESUME_AT + 1, **hook)
    resumed = _grape("torch", _path("torch_host_resumed.h5"),
                     resume_from=stopped, **hook)
    # The host loop snapshots at each save iteration before its update:
    # the resumed run starts by evaluating iteration 2 again.
    np.testing.assert_allclose(resumed.errors,
                               np.asarray(full.errors)[RESUME_AT:], rtol=0,
                               atol=1e-13)


@functools.cache
def _multistart(package, path, iteration_count=CHUNK, resume_from=None):
    pr = _schroedinger()
    kwargs = dict(n_starts=8, complex_controls=True,
                  iteration_count=iteration_count, log_iteration_step=0,
                  save_file_path=path, save_iteration_step=1,
                  fused_chunk=CHUNK, initial_controls=pr.controls,
                  max_control_norms=pr.max_control_norms,
                  resume_from=resume_from)
    if package == "jax":
        from qoc_tpu.parallel import grape_schroedinger_multistart
        return grape_schroedinger_multistart(
            pr.n_c, pr.n_steps, pr.jax_costs, pr.evolution_time,
            pr.jax_hamiltonian, pr.initial, pr.n_steps, **kwargs)
    from qoc_tpu_torch import grape_schroedinger_multistart
    return grape_schroedinger_multistart(
        pr.n_c, pr.n_steps, pr.torch_costs, pr.evolution_time,
        pr.torch_hamiltonian, pr.torch_initial, pr.n_steps, device="cpu",
        **kwargs)


def test_multistart_file_matches_qoc_tpu():
    """The multistart's winner rows and candidate checkpoint (ms_* and the
    per-candidate Adam state) as qoc_tpu writes them."""
    got, want = _path("torch_ms.h5"), _path("jax_ms.h5")
    _multistart("torch", got)
    _multistart("jax", want)
    _assert_same_file(got, want)


def test_multistart_resumes_its_checkpoint():
    """A multistart stopped after one chunk and resumed into its own file
    equals the uninterrupted run: the winner, its error and iteration, every
    candidate's best error and the file."""
    full_path, path = _path("torch_ms_full.h5"), _path("torch_ms_killed.h5")
    full = _multistart("torch", full_path, iteration_count=MS_ITERATIONS)
    _multistart("torch", path)
    result = _multistart("torch", path, iteration_count=MS_ITERATIONS,
                         resume_from=path)
    assert result.iteration_count_ran == MS_ITERATIONS - CHUNK
    np.testing.assert_array_equal(result.errors, full.errors)
    assert result.best_iteration == full.best_iteration
    np.testing.assert_array_equal(result.best_controls, full.best_controls)
    got, want = _datasets(path), _datasets(full_path)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("case", ("multistart file into a single run",
                                  "single-run file into a multistart",
                                  "another candidate count"))
def test_resume_refuses_the_wrong_checkpoint(case):
    from qoc_tpu_torch import grape_schroedinger_multistart
    if case == "multistart file into a single run":
        _multistart("torch", _path("torch_ms.h5"))
        with pytest.raises(ValueError, match="multistart checkpoint"):
            _grape("torch", None, save_iteration_step=0,
                   resume_from=_path("torch_ms.h5"))
        return
    pr = _schroedinger()
    source = (_full("torch")[0] if case.startswith("single")
              else _path("torch_ms.h5"))
    _multistart("torch", _path("torch_ms.h5"))
    with pytest.raises(ValueError, match="single-run checkpoint"
                       if case.startswith("single") else "n_starts=2"):
        grape_schroedinger_multistart(
            pr.n_c, pr.n_steps, pr.torch_costs, pr.evolution_time,
            pr.torch_hamiltonian, pr.torch_initial, pr.n_steps, n_starts=2,
            complex_controls=True, iteration_count=1, log_iteration_step=0,
            resume_from=source, device="cpu")


@pytest.mark.parametrize("package", ("torch", "jax"))
def test_load_controls_refuses_an_evolve_file(package):
    """_require's ValueError for a file without GRAPE rows."""
    path = _path("torch_evolve_only.h5")
    _evolve("torch", "schroedinger", path)
    if package == "torch":
        from qoc_tpu_torch.io import load_controls
    else:
        from qoc_tpu.io import load_controls
    with pytest.raises(ValueError, match="not a GRAPE save file"):
        load_controls(path)


@functools.cache
def _ensemble_file():
    """(problem, file) of a port ensemble GRAPE of 3 members, a save row
    every 2 iterations with the intermediate states."""
    from qoc_tpu_torch import grape_schroedinger_ensemble
    pr = EnsembleProblem(n_members=3, n_steps=12)
    path = _path("torch_ensemble.h5")
    grape_schroedinger_ensemble(
        pr.n_c, pr.n_steps, pr.torch_costs, pr.evolution_time,
        pr.torch_hamiltonian, pr.params, pr.torch_initial, pr.n_steps,
        complex_controls=True, iteration_count=3, log_iteration_step=0,
        save_file_path=path, save_iteration_step=2,
        save_intermediate_states=True, device="cpu")
    return pr, path


def test_ensemble_file_carries_the_member_axis():
    """An ensemble's file (port-written): the member axis on the final and
    intermediate states and hamiltonian_params; each row's trajectory ends
    at its final states and is every member's evolve at that row's
    controls (to 1e-8: the evolve takes the plane route, the ensemble the
    weight chain, each with the kernels' float32-calibrated ladder)."""
    from qoc_tpu_torch import evolve_schroedinger_discrete
    pr, path = _ensemble_file()
    data = _datasets(path)
    assert data["final_states"].shape == (2, 3, 1, pr.d, 1)
    assert data["intermediate_states"].shape == (2, pr.n_steps, 3, 1, pr.d,
                                                 1)
    np.testing.assert_array_equal(data["hamiltonian_params"], pr.params)
    np.testing.assert_allclose(data["intermediate_states"][:, -1],
                               data["final_states"], rtol=0, atol=1e-12)
    for m, row in enumerate(torch.as_tensor(pr.params)):
        member = evolve_schroedinger_discrete(
            pr.evolution_time,
            lambda c, t, row=row: pr.torch_hamiltonian(row, c, t),
            pr.torch_initial, pr.n_steps, controls=data["controls"][1],
            save_intermediate_states=True, device="cpu")
        np.testing.assert_allclose(data["intermediate_states"][1, :, m],
                                   member.intermediate_states, rtol=0,
                                   atol=1e-8)


@pytest.mark.parametrize("package", ("torch", "jax"))
def test_plots_of_port_files(package):
    """plot_controls, plot_state_population and plot_density_population of
    either package on port-written files (Agg), the ensemble member axis
    included."""
    if package == "torch":
        from qoc_tpu_torch import plot
    else:
        from qoc_tpu import plot
    _evolve("torch", "lindblad", _path("torch_evolve_lindblad.h5"))
    for figure in (
            plot.plot_controls(_full("torch")[0],
                               save_file_path=_path(package + "_c.png")),
            plot.plot_state_population(_full("torch")[0], save_index=1),
            plot.plot_state_population(_ensemble_file()[1], member=1),
            plot.plot_density_population(
                _path("torch_evolve_lindblad.h5"), density_index=1)):
        assert figure.axes
    assert os.path.getsize(_path(package + "_c.png")) > 0


def test_standard_names_and_linalg_helpers():
    """Every name of qoc_tpu.standard.__all__ is in qoc_tpu_torch.standard;
    the linalg helpers equal qoc_tpu's."""
    import qoc_tpu.standard as jax_standard

    import qoc_tpu_torch.standard as standard
    assert [name for name in jax_standard.__all__
            if not hasattr(standard, name)] == []
    rng = np.random.default_rng(4)
    a, b, c = (rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
               for _ in range(3))
    columns = rng.normal(size=(3, 4, 1)) + 1j * rng.normal(size=(3, 4, 1))
    for name, args in (("krons", (a, b, c)), ("matmuls", (a, b, c)),
                       ("column_vector_list_to_matrix", (columns,)),
                       ("matrix_to_column_vector_list", (columns[:, :, 0].T,
                                                         ))):
        got = getattr(standard, name)(*map(torch.as_tensor, args))
        want = getattr(jax_standard, name)(*args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-14, err_msg=name)
