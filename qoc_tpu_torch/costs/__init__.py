"""qoc_tpu_torch.costs - cost functions (TargetStateInfidelity so far)."""

from qoc_tpu_torch.costs.state_costs import TargetStateInfidelity

__all__ = ["TargetStateInfidelity"]
