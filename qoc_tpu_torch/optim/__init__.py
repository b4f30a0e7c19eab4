"""qoc_tpu_torch.optim - optimizers (Adam; SGD and L-BFGS are slice 3)."""

from qoc_tpu_torch.optim.adam import Adam

__all__ = ["Adam"]
