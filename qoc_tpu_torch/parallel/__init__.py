"""qoc_tpu_torch.parallel - ensemble-robust GRAPE and multistart on one
card, for the Schrödinger and the Lindblad (``MAGNUS_EXPM``) paths
(counterpart of ``qoc_tpu.parallel``; the mesh and sharding are a later
slice of the port)."""

from qoc_tpu_torch.parallel.ensemble import (build_ensemble_loss,
                                             grape_schroedinger_ensemble)
from qoc_tpu_torch.parallel.lindblad import (build_lindblad_ensemble_loss,
                                             grape_lindblad_ensemble,
                                             grape_lindblad_multistart)
from qoc_tpu_torch.parallel.multistart import grape_schroedinger_multistart

__all__ = ["build_ensemble_loss", "build_lindblad_ensemble_loss",
           "grape_lindblad_ensemble", "grape_lindblad_multistart",
           "grape_schroedinger_ensemble", "grape_schroedinger_multistart"]
