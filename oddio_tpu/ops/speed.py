"""Playback-rate scaling.

Reference: /root/reference/src/speed.rs — multiplies the ``interval`` passed
to the inner signal by a dynamically adjustable factor (speed.rs:32-36),
un-smoothed.  In the batch build, interval is a per-voice host array, so this
is a pure host-side transform on the parameter flow.
"""

from __future__ import annotations

import numpy as np

from ..core.hostmath import f32, full
from ..core.signal import ControlBlock, Signal

__all__ = ["Speed", "SpeedControl"]


class Speed(Signal):
    _host_fields = ("speed",)

    def __init__(self, signal):
        super().__init__()
        self.inner = signal
        self.channels = signal.channels
        self._alloc_host(())
        self.speed[()] = 1.0
        self._cb = ControlBlock(self)
        self.control = SpeedControl(self._cb)

    @classmethod
    def new(cls, signal):
        sig = cls(signal)
        return sig.control, sig

    def children(self):
        return {"inner": self.inner}

    def _alloc_host(self, batch):
        self.speed = full(batch, 1.0)

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        # speed.rs:32-36: inner.sample(interval * speed, out)
        return {"inner": self.inner.host_prepare((interval * self.speed).astype(np.float32), n, count)}

    def host_is_finished(self):
        return self.inner.host_is_finished()

    def render(self, dstate, ddata, params, n):
        d2, block = self.inner.render(
            dstate.get("inner", {}), ddata.get("inner", {}), params["inner"], n
        )
        out = dict(dstate)
        out["inner"] = d2
        return out, block

    # -- device-resident mode ------------------------------------------------
    # The factor lives on device; set_speed ships as a sparse delta.  The
    # inner chain re-derives its per-frame step from the (now per-voice)
    # warped interval in-graph every block (speed.rs:32-36).

    _dr_ctrl_fields = ("speed",)
    _dr_interval_fields = ("speed",)

    def host_ema_bound(self, interval):
        # the factor warps the inner timebase (speed.rs:32-36), so inner
        # Adapt alphas see the scaled interval
        return self.inner.host_ema_bound(
            interval * abs(float(np.float32(self.speed[()])))
        )

    def dr_supported(self):
        return self.inner.dr_supported()

    def dr_state_init(self, V):
        return {
            "speed": np.ones(V, np.float32),
            "inner": self.inner.dr_state_init(V),
        }

    def dr_slot_row(self, interval):
        return {
            "speed": np.float32(self.speed[()]),
            # row encodes position state at the *unwarped* interval; the
            # warped step is re-derived in-graph (dynamic-interval path)
            "inner": self.inner.dr_slot_row(interval),
        }

    def dr_render(self, state, ddata, interval, n, count):
        import jax.numpy as jnp

        warped = jnp.asarray(interval, jnp.float32) * state["speed"]
        d2, samples = self.inner.dr_render(
            state["inner"], ddata.get("inner", {}), warped, n, count
        )
        return {"speed": state["speed"], "inner": d2}, samples

    def dr_is_finished(self, state):
        return self.inner.dr_is_finished(state["inner"])


class SpeedControl:
    """speed.rs:44-55."""

    def __init__(self, cb):
        self._cb = cb

    def speed(self):
        return self._cb.get("speed", np.float32(1.0))

    def set_speed(self, factor):
        self._cb.set("speed", f32(factor))
