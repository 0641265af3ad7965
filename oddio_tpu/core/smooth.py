"""Smoothed parameter ramps.

Reference: /root/reference/src/smooth.rs — ``Smoothed`` linearly ramps toward
a target over a proportional progress, re-settable mid-ramp without
discontinuity (smooth.rs:26-78).  In the batch build the same (prev, next,
progress) triple is host state whose per-frame evaluation happens in closed
form inside kernels (see ops/gain.py); this standalone class is provided for
API parity and host-side use.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Smoothed", "interpolate"]


def interpolate(a, b, t):
    """``Interpolate`` for amplitudes and frame arrays (smooth.rs:81-91):
    ``a + t*(b - a)`` elementwise — the reference's trait collapses to
    this one lerp for every frame type it implements.

    >>> float(interpolate(2.0, 4.0, 0.25))
    2.5
    """
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return (a + np.float32(t) * (b - a)).astype(np.float32)


class Smoothed:
    """
    >>> v = Smoothed(0.0)
    >>> float(v.get())
    0.0
    >>> v.set(1.0); float(v.get())
    0.0
    >>> v.advance(0.5); float(v.get())
    0.5
    >>> v.set(1.5); v.advance(0.5); float(v.get())
    1.0
    >>> v.advance(0.5); float(v.get())
    1.5
    >>> v.advance(0.5); float(v.get())
    1.5
    """

    def __init__(self, x):
        self.prev = np.float32(x)
        self.next = np.float32(x)
        self._progress = np.float32(1.0)

    def advance(self, proportion):
        """smooth.rs:47-49."""
        self._progress = np.minimum(
            np.float32(self._progress + np.float32(proportion)), np.float32(1.0)
        )

    def progress(self):
        return float(self._progress)

    def set(self, value):
        """smooth.rs:57-64."""
        self.prev = self.get()
        self.next = np.float32(value)
        self._progress = np.float32(0.0)

    def get(self):
        """smooth.rs:67-72 — prev.interpolate(next, progress)."""
        return np.float32(self.prev + self._progress * (self.next - self.prev))

    def target(self):
        return self.next
