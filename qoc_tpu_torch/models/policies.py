"""Policy enums.

Counterpart of ``qoc_tpu/models/policies.py`` (reference
qoc/models/{interpolationpolicy,magnuspolicy,operationpolicy,
performancepolicy,programtype}.py). ``OperationPolicy`` and
``PerformancePolicy`` are vestigial in the reference and kept only for API
compatibility; device placement in qoc_tpu_torch is the ``device``
argument of each entry point.
"""

from enum import Enum

__all__ = [
    "InterpolationPolicy",
    "MagnusPolicy",
    "OperationPolicy",
    "PerformancePolicy",
    "ProgramType",
    "LindbladMethod",
]


class InterpolationPolicy(Enum):
    """How control values are interpolated between control_eval_times."""
    LINEAR = 1

    def __str__(self):
        return self.name.lower()


class MagnusPolicy(Enum):
    """Order of the Magnus expansion used by the Schrödinger propagator."""
    M2 = 2
    M4 = 4
    M6 = 6

    def __str__(self):
        return self.name.lower()


class OperationPolicy(Enum):
    """Vestigial (reference parity only); pass ``device`` instead."""
    CPU = 1
    GPU = 2
    CPU_SPARSE = 3
    GPU_SPARSE = 4
    TPU = 5

    def __str__(self):
        return self.name.lower()


class PerformancePolicy(Enum):
    """Vestigial (reference parity only)."""
    TIME = 1
    MEMORY = 2

    def __str__(self):
        return self.name.lower()


class ProgramType(Enum):
    EVOLVE = "evolve"
    GRAPE = "grape"

    def __str__(self):
        return self.value


class LindbladMethod(Enum):
    """Integration strategy for the Lindblad path (a ``qoc_tpu`` extension).

    RKDP5: adaptive Dormand-Prince, reference-parity semantics (restarted per
    system_eval interval, accuracy set by atol); not ported yet.
    MAGNUS_EXPM: vectorize the density, build the Lindblad superoperator, and
    propagate with Magnus + expm on the d^2-dimensional space through the
    Schrödinger path's kernels.
    """
    RKDP5 = 1
    MAGNUS_EXPM = 2

    def __str__(self):
        return self.name.lower()
