"""qoc_tpu_torch.optim - optimizers: Adam, SGD and the L-BFGS ladder on
the device and on the host loop, scipy's L-BFGS-B on the host loop."""

from qoc_tpu_torch.optim.adam import Adam
from qoc_tpu_torch.optim.lbfgs import LBFGS
from qoc_tpu_torch.optim.lbfgsb import LBFGSB
from qoc_tpu_torch.optim.sgd import SGD

__all__ = ["Adam", "LBFGS", "LBFGSB", "SGD"]
