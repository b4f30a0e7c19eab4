"""qoc_tpu_torch.costs - cost functions: the target infidelities at the
final step, the step costs (infidelity at every cost step, forbidden
states and densities) and the control regularizers (norm, area, variation,
bandwidth)."""

from qoc_tpu_torch.costs.control_costs import (ControlArea,
                                               ControlBandwidthMax,
                                               ControlNorm, ControlVariation)
from qoc_tpu_torch.costs.density_costs import (ForbidDensities,
                                               TargetDensityInfidelity,
                                               TargetDensityInfidelityTime)
from qoc_tpu_torch.costs.state_costs import (ForbidStates,
                                             TargetStateInfidelity,
                                             TargetStateInfidelityTime)

__all__ = ["ControlArea", "ControlBandwidthMax", "ControlNorm",
           "ControlVariation", "ForbidDensities", "ForbidStates",
           "TargetDensityInfidelity", "TargetDensityInfidelityTime",
           "TargetStateInfidelity", "TargetStateInfidelityTime"]
