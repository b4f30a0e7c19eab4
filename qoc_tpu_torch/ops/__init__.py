"""qoc_tpu_torch.ops - interpolation, Magnus, linear algebra and the fused
expm-product chain op with its CUDA kernels."""

from qoc_tpu_torch.ops.chain import ChainExpmPropagate, chain_bwd, chain_fwd
from qoc_tpu_torch.ops.interpolate import (interpolate_linear_points,
                                           interpolate_linear_set)
from qoc_tpu_torch.ops.linalg import conjugate_transpose, mul
from qoc_tpu_torch.ops.magnus import magnus_m2

__all__ = [
    "ChainExpmPropagate",
    "chain_bwd",
    "chain_fwd",
    "conjugate_transpose",
    "interpolate_linear_points",
    "interpolate_linear_set",
    "magnus_m2",
    "mul",
]
