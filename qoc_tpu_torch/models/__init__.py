"""qoc_tpu_torch.models - data models, policies, results."""

from qoc_tpu_torch.models.cost import Cost, validate_cost_dimensions
from qoc_tpu_torch.models.hamiltonian import (ConstantLindblad,
                                              EnsembleLinearHamiltonian,
                                              LinearHamiltonian)
from qoc_tpu_torch.models.policies import (
    InterpolationPolicy,
    LindbladMethod,
    MagnusPolicy,
    OperationPolicy,
    PerformancePolicy,
    ProgramType,
)
from qoc_tpu_torch.models.programstate import (
    EvolveLindbladDiscreteState,
    EvolveSchroedingerDiscreteState,
    GrapeLindbladDiscreteState,
    GrapeSchroedingerDiscreteState,
    GrapeState,
    ProgramState,
)
from qoc_tpu_torch.models.results import (
    EvolveLindbladResult,
    EvolveSchroedingerResult,
    GrapeLindbladResult,
    GrapeSchroedingerResult,
)

__all__ = [
    "Cost",
    "validate_cost_dimensions",
    "ConstantLindblad",
    "EnsembleLinearHamiltonian",
    "LinearHamiltonian",
    "InterpolationPolicy",
    "LindbladMethod",
    "MagnusPolicy",
    "OperationPolicy",
    "PerformancePolicy",
    "ProgramType",
    "ProgramState",
    "GrapeState",
    "EvolveSchroedingerDiscreteState",
    "GrapeSchroedingerDiscreteState",
    "EvolveLindbladDiscreteState",
    "GrapeLindbladDiscreteState",
    "EvolveSchroedingerResult",
    "GrapeSchroedingerResult",
    "EvolveLindbladResult",
    "GrapeLindbladResult",
]
