"""Control interpolation.

Counterpart of ``qoc_tpu/ops/interpolate.py`` (reference
qoc/core/mathmethods.py:14-67): the bracket is a ``torch.searchsorted``
(side="left") clamped to [1, N-1], which reproduces the reference exactly,
including linear extrapolation from the two lowest (highest) samples below
(above) the sample range. Queries may be batched.
"""

import torch

__all__ = ["interpolate_linear_points", "interpolate_linear_set"]


def interpolate_linear_points(x1, x2, x3, y1, y2):
    """Linearly inter/extrapolate the point at x3 from (x1, y1), (x2, y2).

    Parity: reference mathmethods.py:14-33.
    """
    return y1 + (((y2 - y1) / (x2 - x1)) * (x3 - x1))


def interpolate_linear_set(x, xs, ys):
    """Value at ``x`` of the piecewise-linear function through (xs, ys).

    Arguments:
    x :: tensor - query points, any shape (0-dim for one point).
    xs :: tensor (N) - sorted sample locations.
    ys :: tensor (N, ...) - sample values; leading axis indexes samples.

    Returns a tensor of shape ``x.shape + ys.shape[1:]``. Queries outside
    [xs[0], xs[-1]] extrapolate linearly from the two boundary samples.
    """
    x = torch.as_tensor(x, dtype=xs.dtype, device=xs.device)
    # First index i with x <= xs[i], clamped so (i-1, i) is a valid bracket;
    # the clamping realizes both extrapolation branches of the reference.
    index = torch.searchsorted(xs, x, side="left")
    index = torch.clamp(index, 1, xs.shape[0] - 1)
    x1 = xs[index - 1]
    x2 = xs[index]
    y1 = ys[index - 1]
    y2 = ys[index]
    tail = (1,) * (ys.dim() - 1)
    return interpolate_linear_points(x1.reshape(x1.shape + tail),
                                     x2.reshape(x2.shape + tail),
                                     x.reshape(x.shape + tail), y1, y2)
