"""qoc_tpu_torch - GRAPE quantum optimal control on PyTorch and CUDA.

The port of ``qoc_tpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for the NVIDIA H100. It imports ``torch`` and never ``jax``; each
module mirrors its ``qoc_tpu`` counterpart by path. Ported so far: the
Schrödinger path with a ``LinearHamiltonian`` or any torch Hamiltonian
callable, Magnus M2/M4/M6, the state costs (``TargetStateInfidelity`` and
the step costs ``TargetStateInfidelityTime``, ``ForbidStates``), intermediate
states, ``grape_unitary`` and Adam, and the Lindblad path under
``LindbladMethod.MAGNUS_EXPM`` (``ConstantLindblad``, the density costs
``TargetDensityInfidelity``, ``TargetDensityInfidelityTime``,
``ForbidDensities``, intermediate densities), whose propagation runs through
the fused expm-product chain kernels (``ops/chain.py``: d <= 64, and the
streamed chain at 256 < padded d <= 512) or the batched expm kernels and a
tree product (``ops/expm.py``; up to padded d = 256 on the card,
``torch.matmul`` above 512), all in ``csrc/``; the Lindblad path takes
them at the superoperator's dimension d². Every entry point takes ``device`` and
``dtype``: by default the current CUDA device in float32 (the kernels'
type), raising ``RuntimeError`` where there is none; ``device="cpu"`` runs
float64 (parity with ``qoc_tpu``).
"""

from qoc_tpu_torch import config  # noqa: F401  (TF32 off for the glue)
from qoc_tpu_torch.core import (evolve_lindblad_discrete,
                                evolve_schroedinger_discrete,
                                grape_lindblad_discrete,
                                grape_schroedinger_discrete, grape_unitary)
from qoc_tpu_torch.costs import (ForbidDensities, ForbidStates,
                                 TargetDensityInfidelity,
                                 TargetDensityInfidelityTime,
                                 TargetStateInfidelity,
                                 TargetStateInfidelityTime)
from qoc_tpu_torch.models import (ConstantLindblad, LindbladMethod,
                                  LinearHamiltonian)
from qoc_tpu_torch.ops.expm import (expm, expm_eigh, expm_frechet, expm_pade,
                                    expm_taylor)
from qoc_tpu_torch.optim import Adam

__version__ = "0.1.0"

__all__ = [
    "Adam",
    "ConstantLindblad",
    "ForbidDensities",
    "ForbidStates",
    "LindbladMethod",
    "LinearHamiltonian",
    "TargetDensityInfidelity",
    "TargetDensityInfidelityTime",
    "TargetStateInfidelity",
    "TargetStateInfidelityTime",
    "evolve_lindblad_discrete",
    "evolve_schroedinger_discrete",
    "expm",
    "expm_eigh",
    "expm_frechet",
    "expm_pade",
    "expm_taylor",
    "grape_lindblad_discrete",
    "grape_schroedinger_discrete",
    "grape_unitary",
]
