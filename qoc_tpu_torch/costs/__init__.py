"""qoc_tpu_torch.costs - cost functions (TargetStateInfidelity and
TargetDensityInfidelity so far)."""

from qoc_tpu_torch.costs.density_costs import TargetDensityInfidelity
from qoc_tpu_torch.costs.state_costs import TargetStateInfidelity

__all__ = ["TargetDensityInfidelity", "TargetStateInfidelity"]
