"""Rendering observability: xRT counters and JAX profiler hooks.

The reference has zero instrumentation (SURVEY.md §5 — "you hear glitches");
this is the additive device-side equivalent: wrap a Renderer to track how many
times faster than real time it runs, and optionally capture a device trace.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["XrtMeter", "device_trace"]


class XrtMeter:
    """Tracks audio-seconds rendered vs wall-clock seconds spent.

    >>> meter = XrtMeter(rate=48000)
    >>> with meter.block(512):
    ...     out = renderer.render_block(512)   # doctest: +SKIP
    >>> meter.xrt()                            # doctest: +SKIP
    """

    def __init__(self, rate):
        self.rate = float(rate)
        self.frames = 0
        self.wall = 0.0

    @contextlib.contextmanager
    def block(self, n):
        t0 = time.perf_counter()
        yield
        self.wall += time.perf_counter() - t0
        self.frames += n

    def audio_seconds(self):
        return self.frames / self.rate

    def xrt(self):
        """Times-real-time achieved so far (> 1 means keeping up)."""
        return self.audio_seconds() / self.wall if self.wall else float("inf")

    def reset(self):
        self.frames = 0
        self.wall = 0.0


@contextlib.contextmanager
def device_trace(logdir):
    """Capture a jax.profiler device trace around a rendering region."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
