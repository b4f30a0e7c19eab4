"""qoc_tpu_torch.optim - optimizers (Adam and SGD; L-BFGS and L-BFGS-B are
slice 3)."""

from qoc_tpu_torch.optim.adam import Adam
from qoc_tpu_torch.optim.sgd import SGD

__all__ = ["Adam", "SGD"]
