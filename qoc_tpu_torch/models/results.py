"""Result objects of the Schrödinger and Lindblad entry points.

Counterpart of ``qoc_tpu/models/results.py`` (reference
qoc/models/schroedingermodels.py:113-131,347-370 and
lindbladmodels.py:342-365). ``best_*`` fields track
the lowest-error iterate seen. Arrays in results are host numpy.
"""

import numpy as np

__all__ = ["EvolveLindbladResult", "EvolveSchroedingerResult",
           "GrapeLindbladResult", "GrapeSchroedingerResult"]

_MAX = np.finfo(np.float64).max


class EvolveSchroedingerResult:
    def __init__(self, error=None, final_states=None, intermediate_states=None):
        self.error = error
        self.final_states = final_states
        self.intermediate_states = intermediate_states


class GrapeSchroedingerResult:
    def __init__(self, best_controls=None, best_error=_MAX,
                 best_final_states=None, best_iteration=None):
        self.best_controls = best_controls
        self.best_error = best_error
        self.best_final_states = best_final_states
        self.best_iteration = best_iteration
        # Extensions beyond the reference: the iteration history and the
        # measured optimization rate. ``iterations_per_s`` is the steady
        # rate (first chunk excluded: it carries the kernel build and
        # warm-up); ``iterations_per_s_mean`` includes it.
        self.iteration_count_ran = 0
        self.errors = None  # ndarray (iterations,) of per-iteration error
        self.iterations_per_s = 0.0
        self.iterations_per_s_mean = 0.0


class EvolveLindbladResult:
    def __init__(self, error=None, final_densities=None,
                 intermediate_densities=None):
        self.error = error
        self.final_densities = final_densities
        self.intermediate_densities = intermediate_densities


class GrapeLindbladResult:
    def __init__(self, best_controls=None, best_error=_MAX,
                 best_final_densities=None, best_iteration=None):
        self.best_controls = best_controls
        self.best_error = best_error
        self.best_final_densities = best_final_densities
        self.best_iteration = best_iteration
        # The extensions of GrapeSchroedingerResult.
        self.iteration_count_ran = 0
        self.errors = None
        self.iterations_per_s = 0.0
        self.iterations_per_s_mean = 0.0
