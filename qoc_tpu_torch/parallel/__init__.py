"""qoc_tpu_torch.parallel - ensemble-robust GRAPE and multistart on one
card (counterpart of ``qoc_tpu.parallel``; the mesh, sharding and the
Lindblad ensembles are later slices of the port)."""

from qoc_tpu_torch.parallel.ensemble import (build_ensemble_loss,
                                             grape_schroedinger_ensemble)
from qoc_tpu_torch.parallel.multistart import grape_schroedinger_multistart

__all__ = ["build_ensemble_loss", "grape_schroedinger_ensemble",
           "grape_schroedinger_multistart"]
