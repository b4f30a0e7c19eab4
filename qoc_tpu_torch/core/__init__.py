"""qoc_tpu_torch.core - the Schrödinger and Lindblad entry points, gate
synthesis and the GRAPE loop."""

from qoc_tpu_torch.core.lindblad import (evolve_lindblad_discrete,
                                         grape_lindblad_discrete)
from qoc_tpu_torch.core.schroedinger import (evolve_schroedinger_discrete,
                                             grape_schroedinger_discrete)
from qoc_tpu_torch.core.unitary import grape_unitary

__all__ = ["evolve_lindblad_discrete", "evolve_schroedinger_discrete",
           "grape_lindblad_discrete", "grape_schroedinger_discrete",
           "grape_unitary"]
