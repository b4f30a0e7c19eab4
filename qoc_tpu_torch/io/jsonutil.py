"""numpy-aware JSON encoding.

The port's copy of ``qoc_tpu/io/jsonutil.py`` (reference
qoc/standard/utils/jsonutil.py:9-24).
"""

import json

import numpy as np

__all__ = ["CustomJSONEncoder"]


class CustomJSONEncoder(json.JSONEncoder):
    """JSON encoder that understands numpy scalars, arrays, and complex."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, (np.complexfloating, complex)):
            return {"re": float(np.real(obj)), "im": float(np.imag(obj))}
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return json.JSONEncoder.default(self, obj)
