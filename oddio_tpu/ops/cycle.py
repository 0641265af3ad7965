"""Looping playback of static frames.

Reference: /root/reference/src/cycle.rs — loops ``Frames`` end-to-end with
linear interpolation across the seam (cycle.rs:26-53); ``Seek`` wraps the f64
cursor with ``rem_euclid`` (cycle.rs:56-60).

Device form: like FramesSignal, the f64 sample cursor is host state; the device
computes positions ``(base + trunc(offset0 + i*ds)) mod len`` and gathers the
seam pair ``(data[x], data[(x+1) mod len])`` from the arena.  The reference
rebases its f32 offset in-loop when it walks past the end (cycle.rs:40-47);
the modulo form is the same arithmetic without the sequential rebase.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.frames import _arena
from ..core.hostmath import f32, f64, full, rem_euclid
from ..core.signal import Signal
from ._dev import exact_positions, lerp, split_ds, top12 as _top12_np

__all__ = ["Cycle"]


class Cycle(Signal):
    seekable = True
    _host_fields = ("cursor", "off", "length", "rate")

    def __init__(self, frames):
        super().__init__()
        self.channels = frames.channels
        self._alloc_host(())
        self.off[()] = frames.offset
        self.length[()] = len(frames)
        self.rate[()] = frames._rate

    def _alloc_host(self, batch):
        self.cursor = full(batch, 0.0, np.float64)
        self.off = full(batch, 0, np.int32)
        self.length = full(batch, 1, np.int32)
        self.rate = full(batch, 1.0, np.float64)

    def _arch_extra(self):
        return (self.channels,)

    def _params_from_cursor(self, cursor, interval):
        # cycle.rs:27-30: ds = interval * rate() as f32; base = cursor as usize
        ds = (f32(interval) * self.rate.astype(np.float32)).astype(np.float32)
        base = np.trunc(cursor)
        offset0 = (cursor - base).astype(np.float32)
        ds_int, f_hi, f_lo = split_ds(ds)
        return {
            "base": np.clip(base, 0, 2**30).astype(np.int32),
            "offset0": offset0,
            "ds_int": ds_int,
            "f_hi": f_hi,
            "f_lo": f_lo,
            "off": self.off.copy(),
            "length": self.length.copy(),
        }

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        params = self._params_from_cursor(self.cursor, interval)
        cnt = np.broadcast_to(f64(n if count is None else count), self.batch)
        ds64 = (
            params["ds_int"].astype(np.float64)
            + params["f_hi"].astype(np.float64)
            + params["f_lo"].astype(np.float64)
        )
        length = self.length.astype(np.float64)
        # Final cursor matches the reference's end-of-loop state: the last
        # accessed position reduced mod len (cycle.rs:40-47), plus one step.
        pos_last = params["base"].astype(np.float64) + params["offset0"].astype(np.float64) + (cnt - 1.0) * ds64
        adv = rem_euclid(pos_last, length) + ds64
        self.cursor = np.where(cnt > 0, adv, np.broadcast_to(np.asarray(self.cursor, np.float64), cnt.shape))
        return params

    def host_params_at(self, tshift, interval, n):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        cursor = rem_euclid(
            self.cursor + f32(tshift).astype(np.float64) * self.rate,
            self.length.astype(np.float64),
        )
        return self._params_from_cursor(np.broadcast_to(cursor, self.batch), interval)

    def host_seek(self, seconds):
        """cycle.rs:56-60."""
        self.cursor = rem_euclid(
            self.cursor + f32(seconds).astype(np.float64) * self.rate,
            self.length.astype(np.float64),
        )

    def _own_device_data(self):
        return {"arena": _arena(self.channels).device()}

    # -- device-resident mode ------------------------------------------------

    def dr_supported(self):
        return self.channels == 1

    def dr_state_init(self, V):
        return {
            "base": np.zeros(V, np.int32),
            "frac": np.zeros(V, np.float32),
            "off": np.zeros(V, np.int32),
            "length": np.ones(V, np.int32),
            "rate": np.ones(V, np.float32),
            "r_hi": np.ones(V, np.float32),
            "ds_int": np.ones(V, np.int32),
            "f_hi": np.zeros(V, np.float32),
            "f_lo": np.zeros(V, np.float32),
        }

    def dr_slot_row(self, interval):
        ds = np.float32(np.float32(interval) * self.rate.astype(np.float32))
        ds_int, f_hi, f_lo = split_ds(ds)
        base = np.trunc(self.cursor)
        return {
            "base": np.int32(np.clip(base, 0, 2**30)),
            "frac": np.float32(self.cursor - base),
            "off": np.int32(self.off[()]),
            "length": np.int32(self.length[()]),
            "rate": np.float32(self.rate[()]),
            "r_hi": _top12_np(self.rate[()]),
            "ds_int": np.int32(ds_int),
            "f_hi": np.float32(f_hi),
            "f_lo": np.float32(f_lo),
        }

    def _dr_step(self, state, interval):
        """Per-frame step split: the slot row's exact host split for the
        pool's static interval, or an in-graph re-derivation when the
        interval is dynamic per voice (Speed chains, speed.rs:32-36)."""
        if isinstance(interval, (int, float, np.floating)):
            return state["ds_int"], state["f_hi"], state["f_lo"]
        from ._dev import device_split_ds

        return device_split_ds(state["rate"] * interval)

    def dr_render(self, state, ddata, interval, n, count):
        from ._dev import chunked_frames, device_advance

        ds_int, f_hi, f_lo = self._dr_step(state, interval)
        arena = ddata["arena"]
        off = state["off"][:, None]
        length = state["length"][:, None]

        def ev(cur, n_c):
            # exact mod-length arena gather with the seam lerp pair
            # (cycle.rs:34-47)
            b, o = cur
            tr, fr = exact_positions(o, ds_int, f_hi, f_lo, n_c)
            x = jnp.mod(b[:, None] + tr, length)
            a = jnp.take(arena, off + x, axis=0, mode="clip")
            bb = jnp.take(arena, off + jnp.mod(x + 1, length), axis=0,
                          mode="clip")
            return lerp(a, bb, fr)

        def adv(cur, n_c):
            b, o = cur
            b2, o2 = device_advance(b, o, jnp.int32(n_c), ds_int, f_hi, f_lo)
            return jnp.mod(b2, state["length"]), o2

        samples = chunked_frames(ev, adv, (state["base"], state["frac"]), n)
        # cursor end state matches the host path: position of the last frame
        # reduced mod len, plus one step (cycle.rs:40-47 rebase semantics)
        cm1 = jnp.maximum(count - 1, 0)
        b1, f1 = device_advance(
            state["base"], state["frac"], cm1, ds_int, f_hi, f_lo,
        )
        b1 = jnp.mod(b1, state["length"])
        b2, f2 = device_advance(
            b1, f1, jnp.ones_like(count), ds_int, f_hi, f_lo,
        )
        keep = count <= 0
        out = dict(state)
        out["base"] = jnp.where(keep, state["base"], b2)
        out["frac"] = jnp.where(keep, state["frac"], f2)
        return out, samples

    def dr_is_finished(self, state):
        return jnp.zeros(state["base"].shape, dtype=bool)

    # -- device-resident Seek mode (cycle.rs:56-60) -----------------------------
    # Cursor shifts wrap rem_euclid; positions wrap mod length.  Shares the
    # cursor-shift machinery with FramesSignal (core/frames.py::_FramesDR).

    _dr_wrap = True

    def dr_seek_supported(self):
        from ..core.signal import Signal

        return (
            self.channels == 1
            and type(self).host_is_finished is Signal.host_is_finished
        )

    def _dr_warp_cursor(self, state, t0, wrap):
        from ..core.frames import _FramesDR

        return _FramesDR._dr_warp_cursor(self, state, t0, wrap)

    def dr_advance(self, state, seconds):
        from ..core.frames import _FramesDR

        return _FramesDR.dr_advance(self, state, seconds)

    def dr_warp_render(self, state, ddata, t0, dt, n):
        from ._dev import chunked_frames, device_advance, device_split_ds

        V, E = t0.shape
        base2, o0 = self._dr_warp_cursor(state, t0, wrap=True)
        ds = dt * state["rate"][:, None]
        dsf = tuple(x.reshape(-1) for x in device_split_ds(ds))
        arena = ddata["arena"]
        off = jnp.repeat(state["off"], E)[:, None]
        length = jnp.repeat(state["length"], E)

        def ev(cur, n_c):
            b, o = cur
            tr, fr = exact_positions(o, *dsf, n_c)
            x = jnp.mod(b[:, None] + tr, length[:, None])
            a = jnp.take(arena, off + x, axis=0, mode="clip")
            bb = jnp.take(arena, off + jnp.mod(x + 1, length[:, None]),
                          axis=0, mode="clip")
            return lerp(a, bb, fr)

        def adv(cur, n_c):
            b, o = cur
            b2, o2 = device_advance(b, o, jnp.int32(n_c), *dsf)
            return jnp.mod(b2, length), o2

        samples = chunked_frames(
            ev, adv, (base2.reshape(-1), o0.reshape(-1)), n
        )
        return samples.reshape(V, E, n)

    def render(self, dstate, ddata, params, n):
        tr, fr = exact_positions(
            params["offset0"], params["ds_int"], params["f_hi"], params["f_lo"], n
        )
        length = params["length"][..., None]
        x = jnp.mod(params["base"][..., None] + tr, length)
        arena = ddata["arena"]
        a = jnp.take(arena, params["off"] + x, axis=0, mode="clip")
        b = jnp.take(arena, params["off"] + jnp.mod(x + 1, length), axis=0, mode="clip")
        if arena.ndim > 1:
            fr = fr[:, None]
        out = lerp(a, b, fr)
        block = out[None, :] if arena.ndim == 1 else out.T
        return dstate, block
