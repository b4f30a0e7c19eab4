"""qoc_tpu_torch.costs - cost functions: the target infidelities at the
final step and the step costs (infidelity at every cost step, forbidden
states and densities)."""

from qoc_tpu_torch.costs.density_costs import (ForbidDensities,
                                               TargetDensityInfidelity,
                                               TargetDensityInfidelityTime)
from qoc_tpu_torch.costs.state_costs import (ForbidStates,
                                             TargetStateInfidelity,
                                             TargetStateInfidelityTime)

__all__ = ["ForbidDensities", "ForbidStates", "TargetDensityInfidelity",
           "TargetDensityInfidelityTime", "TargetStateInfidelity",
           "TargetStateInfidelityTime"]
