"""Gate (unitary) synthesis convenience wrapper.

Counterpart of ``qoc_tpu/core/unitary.py``. The reference poses gate
synthesis as multi-state transfer through the unitary <-> state-batch
isomorphism; this wrapper packages it: pass a target unitary, get GRAPE
over its full column basis with a coherent (phase-sensitive) infidelity.
"""

import numpy as np

from qoc_tpu_torch.core.schroedinger import grape_schroedinger_discrete
from qoc_tpu_torch.costs import TargetStateInfidelity

__all__ = ["grape_unitary"]


def grape_unitary(control_count, control_eval_count, evolution_time,
                  hamiltonian, target_unitary, system_eval_count,
                  extra_costs=(), **grape_kwargs):
    """GRAPE a pulse realizing ``target_unitary`` (up to global phase).

    ``target_unitary`` :: (d, d). The d computational basis columns are
    propagated as a state batch and matched against the target's columns
    with the coherent ``TargetStateInfidelity`` (phase-sensitive across
    columns, i.e. a true gate fidelity ``1 - |Tr(V^dag U)|^2 / d^2``).
    ``extra_costs`` are appended (regularizers, step costs). All other
    keyword arguments, ``device`` and ``dtype`` among them, pass through to
    :func:`grape_schroedinger_discrete`.
    """
    target_unitary = np.asarray(target_unitary)
    d = target_unitary.shape[0]
    initial_states = np.eye(d, dtype=complex).T.reshape(d, d, 1)
    target_states = target_unitary.T.reshape(d, d, 1)
    costs = [TargetStateInfidelity(target_states)] + list(extra_costs)
    return grape_schroedinger_discrete(
        control_count, control_eval_count, costs, evolution_time,
        hamiltonian, initial_states, system_eval_count, **grape_kwargs)
