"""qoc_tpu_torch.ops - interpolation, Magnus, linear algebra, the Lindblad
superoperator, the matrix exponential and the fused expm-product chain ops,
with their CUDA kernels."""

from qoc_tpu_torch.ops.chain import (ChainExpmPropagate, PlaneChainPropagate,
                                     chain_bwd, chain_fwd,
                                     plane_chain_propagate, plane_bwd,
                                     plane_fwd, stream_bwd, stream_fwd)
from qoc_tpu_torch.ops.expm import (expm, expm_eigh, expm_frechet, expm_pade,
                                    expm_taylor, set_expm_forward)
from qoc_tpu_torch.ops.expm_cuda import expm_frechet_fwd, expm_fwd
from qoc_tpu_torch.ops.interpolate import (interpolate_linear_points,
                                           interpolate_linear_set)
from qoc_tpu_torch.ops.lindblad import (get_lindbladian,
                                        lindblad_superoperator)
from qoc_tpu_torch.ops.linalg import (column_vector_list_to_matrix,
                                      commutator, conjugate_transpose, krons,
                                      matmuls, matrix_to_column_vector_list,
                                      mul, one_norm, rms_norm)
from qoc_tpu_torch.ops.magnus import magnus_m2, magnus_m4, magnus_m6

__all__ = [
    "ChainExpmPropagate",
    "PlaneChainPropagate",
    "chain_bwd",
    "chain_fwd",
    "column_vector_list_to_matrix",
    "commutator",
    "conjugate_transpose",
    "expm",
    "expm_eigh",
    "expm_frechet",
    "expm_frechet_fwd",
    "expm_fwd",
    "expm_pade",
    "expm_taylor",
    "get_lindbladian",
    "interpolate_linear_points",
    "interpolate_linear_set",
    "krons",
    "lindblad_superoperator",
    "magnus_m2",
    "magnus_m4",
    "magnus_m6",
    "matmuls",
    "matrix_to_column_vector_list",
    "mul",
    "one_norm",
    "plane_bwd",
    "plane_chain_propagate",
    "plane_fwd",
    "rms_norm",
    "set_expm_forward",
    "stream_bwd",
    "stream_fwd",
]
