"""Save-file path utilities.

The port's copy of ``qoc_tpu/io/fileutil.py`` (reference
qoc/standard/utils/fileutil.py:7-38).
"""

import os

__all__ = ["generate_save_file_path"]


def generate_save_file_path(save_file_name, save_path):
    """Full path ``{save_path}/{NNNNN}_{save_file_name}.h5`` with an
    auto-incrementing numeric prefix that avoids collisions with existing
    files following the same convention. Creates ``save_path`` if needed.
    """
    os.makedirs(save_path, exist_ok=True)
    max_numeric_prefix = -1
    for file_name in os.listdir(save_path):
        if "_{}.h5".format(save_file_name) in file_name:
            max_numeric_prefix = max(int(file_name.split("_")[0]),
                                     max_numeric_prefix)
    save_file_name_augmented = "{:05d}_{}.h5".format(max_numeric_prefix + 1,
                                                     save_file_name)
    return os.path.join(save_path, save_file_name_augmented)
