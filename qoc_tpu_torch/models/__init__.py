"""qoc_tpu_torch.models - data models, policies, results."""

from qoc_tpu_torch.models.cost import Cost, validate_cost_dimensions
from qoc_tpu_torch.models.hamiltonian import LinearHamiltonian
from qoc_tpu_torch.models.policies import (
    InterpolationPolicy,
    MagnusPolicy,
    OperationPolicy,
    PerformancePolicy,
    ProgramType,
)
from qoc_tpu_torch.models.programstate import (
    EvolveSchroedingerDiscreteState,
    GrapeSchroedingerDiscreteState,
    GrapeState,
    ProgramState,
)
from qoc_tpu_torch.models.results import (
    EvolveSchroedingerResult,
    GrapeSchroedingerResult,
)

__all__ = [
    "Cost",
    "validate_cost_dimensions",
    "LinearHamiltonian",
    "InterpolationPolicy",
    "MagnusPolicy",
    "OperationPolicy",
    "PerformancePolicy",
    "ProgramType",
    "ProgramState",
    "GrapeState",
    "EvolveSchroedingerDiscreteState",
    "GrapeSchroedingerDiscreteState",
    "EvolveSchroedingerResult",
    "GrapeSchroedingerResult",
]
