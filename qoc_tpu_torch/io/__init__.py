"""qoc_tpu_torch.io - save files, resume and serialization (observer
layer), the counterpart of ``qoc_tpu.io``. ``h5py`` is imported at the
first checkpointer or read, not with the package."""

from qoc_tpu_torch.io.fileutil import generate_save_file_path
from qoc_tpu_torch.io.h5 import H5Checkpointer
from qoc_tpu_torch.io.jsonutil import CustomJSONEncoder
from qoc_tpu_torch.io.resume import load_best_controls, load_controls

__all__ = ["generate_save_file_path", "H5Checkpointer", "CustomJSONEncoder",
           "load_controls", "load_best_controls"]
