"""qoc_tpu_torch - GRAPE quantum optimal control on PyTorch and CUDA.

The port of ``qoc_tpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for the NVIDIA H100. It imports ``torch`` and never ``jax``; each
module mirrors its ``qoc_tpu`` counterpart by path. Ported so far: the
Schrödinger path with a ``LinearHamiltonian`` or any torch Hamiltonian
callable, Magnus M2/M4/M6, the state costs (``TargetStateInfidelity`` and
the step costs ``TargetStateInfidelityTime``, ``ForbidStates``), the
control costs (``ControlNorm``, ``ControlArea``, ``ControlVariation``,
``ControlBandwidthMax``), intermediate states, ``grape_unitary``, the
optimizers (Adam, SGD and the L-BFGS ladder on the device or the host
loop, scipy's L-BFGS-B and ``impose_control_conditions`` hooks on the host
loop), ``ans_jacobian``, and the Lindblad path under both methods, the adaptive
``LindbladMethod.RKDP5`` (the default; ``ops/rkdp5.py``, plain torch) and
``LindbladMethod.MAGNUS_EXPM`` (``ConstantLindblad``, the density costs
``TargetDensityInfidelity``, ``TargetDensityInfidelityTime``,
``ForbidDensities``, intermediate densities), H5 save files and resume on
every entry point (``io/``, ``qoc_tpu``'s schema; ``plot``, and
``standard`` with ``qoc_tpu.standard``'s names), and on one card the
ensemble-robust GRAPE and the multistart, Schrödinger and Lindblad
(``parallel/``, ``EnsembleLinearHamiltonian``), whose propagation runs
through the fused expm-product chain kernels (``ops/chain.py``: d <= 64, and the
streamed chain at 256 < padded d <= 512) or the batched expm kernels and a
tree product (``ops/expm.py``; up to padded d = 256 on the card,
``torch.matmul`` above 512, ``set_expm_forward`` as in ``qoc_tpu``), all
in ``csrc/``; the Lindblad path takes
them at the superoperator's dimension d². Every entry point takes ``device`` and
``dtype``: by default the current CUDA device in float32 (the kernels'
type), raising ``RuntimeError`` where there is none; ``device="cpu"`` runs
float64 (parity with ``qoc_tpu``). The Lindblad entry points under RKDP5,
which launch no kernel, take float64 on CUDA too.
"""

from qoc_tpu_torch import config  # noqa: F401  (TF32 off for the glue)
from qoc_tpu_torch.core import (evolve_lindblad_discrete,
                                evolve_schroedinger_discrete,
                                grape_lindblad_discrete,
                                grape_schroedinger_discrete, grape_unitary)
from qoc_tpu_torch.costs import (ControlArea, ControlBandwidthMax,
                                 ControlNorm, ControlVariation,
                                 ForbidDensities, ForbidStates,
                                 TargetDensityInfidelity,
                                 TargetDensityInfidelityTime,
                                 TargetStateInfidelity,
                                 TargetStateInfidelityTime)
from qoc_tpu_torch.models import (ConstantLindblad,
                                  EnsembleLinearHamiltonian, LindbladMethod,
                                  LinearHamiltonian)
from qoc_tpu_torch.ops.expm import (expm, expm_eigh, expm_frechet, expm_pade,
                                    expm_taylor)
from qoc_tpu_torch.gradutil import ans_jacobian
from qoc_tpu_torch.optim import LBFGS, LBFGSB, SGD, Adam
from qoc_tpu_torch.parallel import (build_ensemble_loss,
                                    build_lindblad_ensemble_loss,
                                    grape_lindblad_ensemble,
                                    grape_lindblad_multistart,
                                    grape_schroedinger_ensemble,
                                    grape_schroedinger_multistart)

__version__ = "0.1.0"

__all__ = [
    "Adam",
    "ConstantLindblad",
    "ControlArea",
    "ControlBandwidthMax",
    "ControlNorm",
    "ControlVariation",
    "EnsembleLinearHamiltonian",
    "ForbidDensities",
    "ForbidStates",
    "LBFGS",
    "LBFGSB",
    "LindbladMethod",
    "LinearHamiltonian",
    "SGD",
    "TargetDensityInfidelity",
    "TargetDensityInfidelityTime",
    "TargetStateInfidelity",
    "TargetStateInfidelityTime",
    "ans_jacobian",
    "build_ensemble_loss",
    "build_lindblad_ensemble_loss",
    "evolve_lindblad_discrete",
    "evolve_schroedinger_discrete",
    "expm",
    "expm_eigh",
    "expm_frechet",
    "expm_pade",
    "expm_taylor",
    "grape_lindblad_discrete",
    "grape_lindblad_ensemble",
    "grape_lindblad_multistart",
    "grape_schroedinger_discrete",
    "grape_schroedinger_ensemble",
    "grape_schroedinger_multistart",
    "grape_unitary",
]
