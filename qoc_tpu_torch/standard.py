"""qoc_tpu_torch.standard - the batteries namespace, mirroring
``qoc_tpu.standard`` (reference qoc/standard/__init__.py): costs,
optimizers, functions, operator constants, plotting and utilities
importable from one place, with ``qoc_tpu.standard``'s names, so that a
script ports by swapping the package name. The functions take tensors.
"""

from qoc_tpu_torch.constants import (
    SIGMA_MINUS,
    SIGMA_PLUS,
    SIGMA_X,
    SIGMA_Y,
    SIGMA_Z,
    get_annihilation_operator,
    get_creation_operator,
    get_eij,
)
from qoc_tpu_torch.costs import (
    ControlArea,
    ControlBandwidthMax,
    ControlNorm,
    ControlVariation,
    ForbidDensities,
    ForbidStates,
    TargetDensityInfidelity,
    TargetDensityInfidelityTime,
    TargetStateInfidelity,
    TargetStateInfidelityTime,
)
from qoc_tpu_torch.gradutil import ans_jacobian
from qoc_tpu_torch.io import CustomJSONEncoder, generate_save_file_path
from qoc_tpu_torch.ops import (
    column_vector_list_to_matrix,
    commutator,
    conjugate_transpose,
    expm,
    expm_eigh,
    expm_pade,
    krons,
    matmuls,
    matrix_to_column_vector_list,
    rms_norm,
)
from qoc_tpu_torch.optim import LBFGS, LBFGSB, SGD, Adam
from qoc_tpu_torch.plot import (
    plot_controls,
    plot_density_population,
    plot_state_population,
)

__all__ = [
    # costs
    "ControlArea", "ControlBandwidthMax", "ControlNorm", "ControlVariation",
    "ForbidDensities", "ForbidStates", "TargetDensityInfidelity",
    "TargetDensityInfidelityTime", "TargetStateInfidelity",
    "TargetStateInfidelityTime",
    # optimizers
    "Adam", "LBFGS", "LBFGSB", "SGD",
    # functions
    "expm", "expm_eigh", "expm_pade", "commutator", "conjugate_transpose",
    "krons", "matmuls", "rms_norm", "column_vector_list_to_matrix",
    "matrix_to_column_vector_list",
    # constants
    "SIGMA_X", "SIGMA_Y", "SIGMA_Z", "SIGMA_PLUS", "SIGMA_MINUS",
    "get_creation_operator", "get_annihilation_operator", "get_eij",
    # plot
    "plot_controls", "plot_density_population", "plot_state_population",
    # utils
    "ans_jacobian", "generate_save_file_path", "CustomJSONEncoder",
]
