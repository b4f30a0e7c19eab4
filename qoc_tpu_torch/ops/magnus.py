"""Magnus expansion, second order.

Counterpart of ``qoc_tpu/ops/magnus.py`` (``magnus_m2``; M4 and M6 are
ROADMAP slice 2 of the port). Takes a generator callable ``a(t) -> matrix``
(typically ``-1j * H(t)``) and samples it at the interval midpoint.
"""

__all__ = ["magnus_m2"]

_M2_C1 = 0.5


def magnus_m2(a, dt, time):
    """Second-order Magnus term: dt * a(midpoint).

    Parity: reference mathmethods.py:74-93.
    """
    return dt * a(time + dt * _M2_C1)
