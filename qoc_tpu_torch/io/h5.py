"""H5 checkpoint files.

Counterpart of ``qoc_tpu/io/h5.py`` (reference qoc/models/
schroedingermodels.py:209-344, where the model classes write the file):
a standalone writer the entry points call, with ``qoc_tpu``'s schema both
ways. The dataset names, shapes, dtypes and preallocation are
``qoc_tpu``'s (``error`` filled with float64's max, states and densities
complex128, the controls and gradients in the initial controls' dtype),
so each package reads, plots and resumes the other's files. Values may
be tensors on any device or numpy arrays: they are pulled to the host and
cast to the dataset's dtype here, at the writer, never in the
optimization loop.

Every open is guarded by a ``filelock.FileLock`` on ``save_file_path +
".lock"``, so that a live plotting process can read concurrently; a lock
timeout drops the write with a message and the optimization continues
(reference schroedingermodels.py:93-95, 253-255). ``h5py`` and
``filelock`` are imported at the first checkpointer, not with the package.
"""

import numpy as np

__all__ = ["H5Checkpointer"]

_LOCK_TIMEOUT_S = 10


def _host(value):
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _modules():
    """(h5py, filelock), imported on first use."""
    import filelock
    import h5py
    return h5py, filelock


class H5Checkpointer:
    """Lock-guarded writer for one optimization or evolution save file.

    Writes are owned by the I/O process (``config.is_io_process``): on
    every other process of a ``torch.distributed`` run the write methods
    do nothing. Reads (``load_optimizer_state``) work on every process.
    """

    def __init__(self, save_file_path):
        from qoc_tpu_torch.config import is_io_process
        self._h5py, self._filelock = _modules()
        self.save_file_path = save_file_path
        self.lock_path = save_file_path + ".lock"
        self._writes_enabled = is_io_process()

    def _locked_write(self, fn, mode="a", what="save"):
        if not self._writes_enabled:
            return
        try:
            with self._filelock.FileLock(self.lock_path,
                                         timeout=_LOCK_TIMEOUT_S):
                with self._h5py.File(self.save_file_path, mode) as save_file:
                    fn(save_file)
        except self._filelock.Timeout:
            print("Timeout while locking {} during {}."
                  "".format(self.lock_path, what))

    # -- GRAPE schema ------------------------------------------------------

    def create_grape_file(self, pstate, save_count):
        """Preallocate the full GRAPE schema at iteration 0 (``qoc_tpu``
        h5.py create_grape_file; reference schroedingermodels.py:276-307,
        lindbladmodels.py:269-300). An ensemble's state carries the member
        axis on the evolved datasets (``evolved_shape``) and its member
        rows as ``hamiltonian_params``."""
        is_schroedinger = hasattr(pstate, "initial_states")
        initial = _host(pstate.initial_states if is_schroedinger
                       else pstate.initial_densities)
        evolved_shape = tuple(getattr(pstate, "evolved_shape", initial.shape))
        ensemble_params = getattr(pstate, "ensemble_params", None)
        evolved_key = "final_states" if is_schroedinger else "final_densities"
        intermediate_key = ("intermediate_states" if is_schroedinger
                            else "intermediate_densities")
        initial_key = ("initial_states" if is_schroedinger
                       else "initial_densities")
        save_intermediate = (pstate.save_intermediate_states_
                             if is_schroedinger
                             else pstate.save_intermediate_densities_)
        initial_controls = _host(pstate.initial_controls)

        def fill(f):
            f["complex_controls"] = pstate.complex_controls
            f["control_count"] = pstate.control_count
            f["control_eval_count"] = pstate.control_eval_count
            f["controls"] = np.zeros(
                (save_count, pstate.control_eval_count, pstate.control_count),
                dtype=initial_controls.dtype)
            f["cost_eval_step"] = pstate.cost_eval_step
            f["cost_names"] = np.array(
                [np.bytes_("{}".format(cost)) for cost in pstate.costs])
            f["error"] = np.repeat(np.finfo(np.float64).max, save_count)
            f["evolution_time"] = pstate.evolution_time
            f[evolved_key] = np.zeros((save_count,) + evolved_shape,
                                      dtype=np.complex128)
            f["grads"] = np.zeros(
                (save_count, pstate.control_eval_count, pstate.control_count),
                dtype=initial_controls.dtype)
            if ensemble_params is not None:
                f["hamiltonian_params"] = _host(ensemble_params)
            f["initial_controls"] = initial_controls
            f[initial_key] = initial
            if save_intermediate:
                f[intermediate_key] = np.zeros(
                    (save_count, pstate.system_eval_count) + evolved_shape,
                    dtype=np.complex128)
            f["interpolation_policy"] = "{}".format(
                pstate.interpolation_policy)
            f["iteration_count"] = pstate.iteration_count
            if is_schroedinger:
                f["magnus_policy"] = "{}".format(pstate.magnus_policy)
            f["max_control_norms"] = _host(pstate.max_control_norms)
            f["method"] = pstate.method
            f["optimizer"] = "{}".format(pstate.optimizer)
            f["program_type"] = pstate.program_type.value
            f["system_eval_count"] = pstate.system_eval_count

        self._locked_write(fill, mode="w", what="initial save")

    def ensure_grape_capacity(self, save_count, iteration_count=None):
        """Grow the preallocated per-save-step datasets to ``save_count``
        rows, the old rows kept (no-op when already large enough): a run
        resuming into its own save file with a larger ``iteration_count``
        than the original call."""
        row_keys = ("controls", "error", "grads", "final_states",
                    "final_densities", "intermediate_states",
                    "intermediate_densities")

        def fill(f):
            for key in row_keys:
                if key not in f:
                    continue
                data = np.asarray(f[key])
                if data.shape[0] >= save_count:
                    continue
                grown = np.zeros((save_count,) + data.shape[1:],
                                 dtype=data.dtype)
                if key == "error":
                    grown[:] = np.finfo(np.float64).max
                grown[:data.shape[0]] = data
                del f[key]
                f[key] = grown
            if iteration_count is not None and "iteration_count" in f:
                del f["iteration_count"]
                f["iteration_count"] = iteration_count

        self._locked_write(fill, what="capacity grow")

    def save_grape_iteration(self, save_step, controls, error, final_evolved,
                             grads, evolved_key):
        """Fill one preallocated row (reference
        schroedingermodels.py:240-251)."""
        self.save_grape_rows([(save_step, controls, error, final_evolved,
                               grads)], evolved_key)

    def save_grape_rows(self, rows, evolved_key):
        """Fill several preallocated rows, (save_step, controls, error,
        final evolved, grads) each, in one locked open."""
        rows = [(int(step), _host(controls), float(error), _host(evolved),
                 _host(grads)) for step, controls, error, evolved, grads
                in rows]

        def fill(f):
            for step, controls, error, evolved, grads in rows:
                f["controls"][step] = controls.astype(f["controls"].dtype)
                f["error"][step] = error
                f[evolved_key][step] = evolved.astype(np.complex128)
                f["grads"][step] = grads.astype(f["grads"].dtype)

        self._locked_write(fill, what="iteration save")

    def save_intermediate(self, key, index, states):
        """Write intermediate states or densities: ``index`` is
        ``(save_step, system_eval_step)``, a save step, or ``slice(None)``
        for an evolve file."""
        states = _host(states).astype(np.complex128)

        def fill(f):
            f[key][index] = states

        self._locked_write(fill, what="intermediate save")

    def save_optimizer_state(self, state_dict):
        """Checkpoint the optimizer's state (``qoc_tpu``'s extension,
        SURVEY.md section 5) into the ``optimizer_state`` group."""
        state_dict = {key: _host(value) for key, value in state_dict.items()}

        def fill(f):
            grp = f.require_group("optimizer_state")
            for key, value in state_dict.items():
                if key in grp:
                    del grp[key]
                grp[key] = value

        self._locked_write(fill, what="optimizer-state save")

    def load_optimizer_state(self):
        """Read back a checkpointed optimizer state, or None."""
        try:
            with self._filelock.FileLock(self.lock_path,
                                         timeout=_LOCK_TIMEOUT_S):
                with self._h5py.File(self.save_file_path, "r") as f:
                    if "optimizer_state" not in f:
                        return None
                    return {key: np.asarray(val)
                            for key, val in f["optimizer_state"].items()}
        except (self._filelock.Timeout, OSError):
            return None

    # -- Evolve schema -----------------------------------------------------

    def create_evolve_file(self, pstate, controls):
        """``qoc_tpu`` h5.py create_evolve_file (reference
        schroedingermodels.py:66-95, lindbladmodels.py:60-90)."""
        is_schroedinger = hasattr(pstate, "initial_states")
        initial = _host(pstate.initial_states if is_schroedinger
                       else pstate.initial_densities)
        intermediate_key = ("intermediate_states" if is_schroedinger
                            else "intermediate_densities")
        initial_key = ("initial_states" if is_schroedinger
                       else "initial_densities")
        save_intermediate = (pstate.save_intermediate_states_
                             if is_schroedinger
                             else pstate.save_intermediate_densities_)

        def fill(f):
            if controls is not None:
                f["controls"] = _host(controls)
            f["cost_eval_step"] = pstate.cost_eval_step
            f["costs"] = np.array(
                [np.bytes_("{}".format(cost)) for cost in pstate.costs])
            f["evolution_time"] = pstate.evolution_time
            f[initial_key] = initial
            f["interpolation_policy"] = "{}".format(
                pstate.interpolation_policy)
            if save_intermediate:
                f[intermediate_key] = np.zeros(
                    (pstate.system_eval_count,) + initial.shape,
                    dtype=np.complex128)
            if is_schroedinger:
                f["magnus_policy"] = "{}".format(pstate.magnus_policy)
            f["method"] = pstate.method
            f["program_type"] = pstate.program_type.value
            f["system_eval_count"] = pstate.system_eval_count

        self._locked_write(fill, mode="w", what="initial save")
