"""Observability: iteration-rate counters and profiler spans.

Counterpart of ``qoc_tpu/profiler.py``: :class:`RateMeter` counts events
and reports rates, and :func:`trace_annotation` names a span that
``torch.profiler`` records (the GRAPE loop wraps each chunk in one).
"""

import contextlib
import time

import torch

__all__ = ["RateMeter", "trace_annotation"]


class RateMeter:
    """Counts events (iterations, propagation steps) and reports rates."""

    def __init__(self, smoothing=0.9):
        self.smoothing = smoothing
        self.count = 0
        self._start = None
        self._last = None
        self._ewma_rate = None
        self._first_tick = None
        self._first_count = 0

    def start(self):
        self._start = self._last = time.perf_counter()
        return self

    def tick(self, n=1):
        """Record ``n`` events; returns the instantaneous rate (events/s)."""
        if self._start is None:
            self.start()
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.count += n
        if self._first_tick is None:
            self._first_tick = now
            self._first_count = n
        rate = n / dt if dt > 0 else float("inf")
        if self._ewma_rate is None:
            self._ewma_rate = rate
        else:
            self._ewma_rate = (self.smoothing * self._ewma_rate
                               + (1 - self.smoothing) * rate)
        return rate

    @property
    def rate(self):
        """EWMA-smoothed events/s."""
        return self._ewma_rate or 0.0

    @property
    def mean_rate(self):
        """Mean events/s since start()."""
        if self._start is None or self.count == 0:
            return 0.0
        elapsed = self._last - self._start
        return self.count / elapsed if elapsed > 0 else float("inf")

    @property
    def steady_rate(self):
        """Mean events/s excluding the interval up to the FIRST tick — the
        first chunk carries the kernel build and warm-up, so this is the
        rate of a warm run. Falls back to ``mean_rate`` when only one tick
        was recorded."""
        if self._first_tick is None or self.count <= self._first_count:
            return self.mean_rate
        elapsed = self._last - self._first_tick
        steady_count = self.count - self._first_count
        return steady_count / elapsed if elapsed > 0 else float("inf")


@contextlib.contextmanager
def trace_annotation(name):
    """Named span recorded in ``torch.profiler`` traces."""
    with torch.profiler.record_function(name):
        yield
