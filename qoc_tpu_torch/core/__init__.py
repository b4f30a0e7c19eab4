"""qoc_tpu_torch.core - the Schrödinger entry points and the GRAPE loop."""

from qoc_tpu_torch.core.schroedinger import (evolve_schroedinger_discrete,
                                             grape_schroedinger_discrete)

__all__ = ["evolve_schroedinger_discrete", "grape_schroedinger_discrete"]
