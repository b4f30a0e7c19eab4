"""Control interpolation.

Counterpart of ``qoc_tpu/ops/interpolate.py`` (reference
qoc/core/mathmethods.py:14-67): the bracket is a ``torch.searchsorted``
(side="left") clamped to [1, N-1], which reproduces the reference exactly,
including linear extrapolation from the two lowest (highest) samples below
(above) the sample range. Queries may be batched, and with
:func:`lane_interpolator` each lane has its own samples (the adaptive
integrator's lanes, each at its own time).
"""

import torch

__all__ = ["interpolate_linear_points", "interpolate_linear_set",
           "lane_interpolator"]


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


def lane_interpolator(xs, ys):
    """x -> each lane's value at its own query: lane l's samples ``ys[l]``
    ((L, N, ...)) at the shared locations ``xs`` (N), queried at ``x[l]``
    for ``x`` (L,), giving (L, ...). Lane l's value is
    ``interpolate_linear_set(x[l], xs, ys[l])``, by the same arithmetic;
    the segments' slopes are formed once, for many queries."""
    tail = (1,) * (ys.dim() - 2)
    slopes = ((ys[:, 1:] - ys[:, :-1])
              / (xs[1:] - xs[:-1]).reshape((-1,) + tail))
    lane = torch.arange(ys.shape[0], device=ys.device)

    def at(x):
        index = torch.clamp(torch.searchsorted(xs, x, side="left"), 1,
                            xs.shape[0] - 1) - 1
        return ys[lane, index] + slopes[lane, index] * (
            x - xs[index]).reshape(x.shape + tail)

    return at
