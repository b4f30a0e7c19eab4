"""Resume helpers: read optimization state back from a save file.

Counterpart of ``qoc_tpu/io/resume.py``. The reference's resume is manual
(re-open the H5, pick a row, feed it back as ``initial_controls``,
schroedingerdiscrete.py:164-168) and loses Adam's moments. These helpers
package that workflow and pair with ``H5Checkpointer.save_optimizer_state``;
the ``resume_from=`` argument of the ``grape_*`` entry points routes
through :func:`apply_resume`. They read files of either package.
"""

import os

import numpy as np

__all__ = ["apply_resume", "load_controls", "load_best_controls"]

_LOCK_TIMEOUT_S = 10


def _read(file_path, keys):
    import filelock
    import h5py
    lock_path = file_path + ".lock"
    try:
        with filelock.FileLock(lock_path, timeout=_LOCK_TIMEOUT_S):
            with h5py.File(file_path, "r") as f:
                data = {key: np.asarray(f[key]) for key in keys if key in f}
                if "program_type" in f:
                    raw = np.asarray(f["program_type"]).reshape(()).item()
                    data["__program_type__"] = (raw.decode()
                                                if isinstance(raw, bytes)
                                                else str(raw))
                return data
    except filelock.Timeout:
        raise RuntimeError("Timeout locking {} for reading."
                           "".format(lock_path))


def _require(data, keys, file_path):
    """A clear error for a file without GRAPE row datasets (an evolve
    save, or a foreign H5), rather than a KeyError in the caller."""
    missing = [key for key in keys if key not in data]
    if missing:
        ptype = data.get("__program_type__")
        raise ValueError(
            "{} has no {} dataset{} — it is not a GRAPE save file{}; "
            "resume needs a file written by a grape_* run with "
            "save_iteration_step > 0.".format(
                file_path, "/".join(missing),
                "s" if len(missing) > 1 else "",
                " (program_type={!r})".format(ptype) if ptype else ""))


def load_controls(save_file_path, save_index=-1):
    """Controls from row ``save_index`` of a GRAPE save file (negative
    indices count from the end as usual). Returns (controls, error)."""
    data = _read(save_file_path, ("controls", "error"))
    _require(data, ("controls", "error"), save_file_path)
    return data["controls"][save_index], float(data["error"][save_index])


def apply_resume(pstate, resume_from):
    """Configure ``pstate`` to continue a previous run.

    Loads the optimizer-state checkpoint (params, the optimizer's state and
    the next iteration, written by ``core/graperunner.py`` and
    ``parallel/_msrunner.py``) into ``pstate.resume_state``; a file without
    one (written with ``save_iteration_step`` 0, or before checkpoints
    existed) resumes as the reference does: the lowest-error saved
    controls become the initial controls and the optimizer starts fresh.

    Resuming into the *same* file keeps its preallocated schema and fills
    its remaining rows in place (``pstate.resuming_same_file``), grown for
    a larger ``iteration_count``.
    """
    from qoc_tpu_torch.io.h5 import H5Checkpointer

    resume_state = H5Checkpointer(resume_from).load_optimizer_state()
    if resume_state is not None:
        pstate.resume_state = resume_state
    else:
        controls, _, _ = load_best_controls(resume_from)
        pstate.initial_controls = controls
    if (pstate.save_file_path is not None
            and os.path.abspath(resume_from)
            == os.path.abspath(pstate.save_file_path)):
        pstate.resuming_same_file = True
        if pstate.should_save:
            pstate.checkpointer.ensure_grape_capacity(
                pstate._save_count(), pstate.iteration_count)


def load_best_controls(save_file_path):
    """Controls of the lowest-error saved row: (controls, error,
    save_index). Feed the controls back into a ``grape_*`` call as
    ``initial_controls`` to resume."""
    data = _read(save_file_path, ("controls", "error"))
    _require(data, ("controls", "error"), save_file_path)
    index = int(np.argmin(data["error"]))
    return data["controls"][index], float(data["error"][index]), index
