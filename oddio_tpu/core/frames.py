"""Static audio storage and playback.

Reference: /root/reference/src/frames.rs — ``Frames<T>`` is an immutable,
rate-tagged sample array (frames.rs:19-124) and ``FramesSignal`` plays it from
an f64 cursor with linear interpolation and zero-padding outside the range
(frames.rs:141-214), publishing its playback position for the control half
(frames.rs:223-248).

Device form: all ``Frames`` data lives in a per-channel-count **device
arena** — one concatenated f32 array — so that a pool of voices playing
*different* sounds is still a single dense gather: each voice carries an
(offset, length) pair into the arena.  This replaces per-sound ``Arc``
sharing; loading new sounds appends to the arena (a rare re-upload, analogous
to oddio's set-realloc protocol, set.rs:208-212).

Cursor precision: oddio keeps ``t`` in f64 (frames.rs:143-149).  Device f64
is slow or absent, so the cursor stays in **host** f64 and the device receives a
(base:int32, offset0:f32, ds:f32) decomposition per block — bit-faithful to
the reference's ``s0 = t*rate; base = s0 as isize`` split (frames.rs:177-189).
The per-frame offsets use the closed form ``offset0 + i*ds`` rather than the
reference's sequential ``offset += ds`` f32 accumulation; the difference is
pure rounding (≲ n·eps samples within one block; cross-block state is exact).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .hostmath import EPS32, f32, f64, full
from .signal import ControlBlock, Signal
from ..ops._dev import exact_positions, lerp, split_ds, top12 as _top12_np

__all__ = ["Frames", "FramesSignal", "FramesSignalControl"]


class _Arena:
    """Concatenated device storage for all Frames with a given channel count."""

    def __init__(self, channels):
        self.channels = channels
        self._chunks = []  # list of np arrays
        self._total = 0
        self._device = None

    def add(self, data):
        off = self._total
        self._chunks.append(data)
        self._total += data.shape[0]
        self._device = None
        return off

    def device(self):
        if self._device is None:
            if not self._chunks:
                shape = (1,) if self.channels == 1 else (1, self.channels)
                self._device = jnp.zeros(shape, dtype=jnp.float32)
            else:
                self._device = jnp.asarray(np.concatenate(self._chunks, axis=0))
        return self._device


_ARENAS = {}


def _arena(channels):
    if channels not in _ARENAS:
        _ARENAS[channels] = _Arena(channels)
    return _ARENAS[channels]


class Frames:
    """A sequence of static audio frames at a particular sample rate
    (frames.rs:12-124).  ``data`` is float32, shape (len,) mono or (len, C)."""

    def __init__(self, rate, data):
        data = f32(data)
        if data.ndim == 1:
            self.channels = 1
        else:
            self.channels = int(data.shape[1])
        self._rate = np.float64(rate)  # stored as f64 like the header (frames.rs:20)
        self.data = data
        self.arena = _arena(self.channels)
        self.offset = self.arena.add(data)

    @classmethod
    def from_slice(cls, rate, samples):
        """frames.rs:26-47."""
        return cls(rate, samples)

    @classmethod
    def from_iter(cls, rate, it):
        """frames.rs:50-77."""
        return cls(rate, np.fromiter(it, dtype=np.float32))

    def __len__(self):
        return int(self.data.shape[0])

    def rate(self):
        """Samples per second (frames.rs:80-82)."""
        return int(self._rate)

    def runtime(self):
        """Runtime in seconds (frames.rs:85-87)."""
        return len(self) / self._rate

    def interpolate(self, s):
        """Host-side frame interpolation at sample position ``s``
        (frames.rs:94-102): whole numbers hit exact samples, out-of-range
        positions yield 0."""
        x0 = int(np.trunc(s))
        fract = np.float32(np.float64(s) - np.float64(x0))
        a, b = self._get_pair(x0)
        return (a + fract * (b - a)).astype(np.float32)

    def _get_pair(self, s):
        """frames.rs:105-123."""
        zero = np.zeros(self.data.shape[1:], np.float32) if self.data.ndim > 1 else np.float32(0.0)
        n = len(self)
        a = self.data[s] if 0 <= s < n else zero
        b = self.data[s + 1] if 0 <= s + 1 < n else zero
        return a, b


def _arena_get(arena, off, length, s):
    """Zero-padded arena gather implementing get_pair's edge semantics
    (frames.rs:105-123): valid for 0 <= s < length, zero otherwise."""
    valid = (s >= 0) & (s < length)
    idx = off + jnp.clip(s, 0, jnp.maximum(length - 1, 0))
    v = jnp.take(arena, idx, axis=0, mode="clip")
    if arena.ndim > 1:
        valid = valid[..., None]
    return jnp.where(valid, v, 0.0)


class FramesSignal(Signal):
    """An audio signal backed by static samples (frames.rs:141-214)."""

    seekable = True
    _host_fields = ("t", "off", "length", "rate")

    def __init__(self, frames, start_seconds=0.0):
        super().__init__()
        self.channels = frames.channels
        self._alloc_host(())
        self.t[()] = np.float64(start_seconds)
        self.off[()] = frames.offset
        self.length[()] = len(frames)
        self.rate[()] = frames._rate
        self._cb = ControlBlock(self)
        self.control = FramesSignalControl(self._cb)

    @classmethod
    def new(cls, frames, start_seconds=0.0):
        """frames.rs:152-169 — returns (control, signal)."""
        sig = cls(frames, start_seconds)
        return sig.control, sig

    def _alloc_host(self, batch):
        self.t = full(batch, 0.0, np.float64)
        self.off = full(batch, 0, np.int32)
        self.length = full(batch, 1, np.int32)
        self.rate = full(batch, 1.0, np.float64)

    def _copy_static_from(self, other):
        pass

    def _arch_extra(self):
        return (self.channels,)

    def _params_from_t(self, t, interval):
        s0 = t * self.rate  # f64 (frames.rs:177)
        base = np.trunc(s0)  # `s0 as isize` truncates toward zero
        ds = (f32(interval) * self.rate.astype(np.float32)).astype(np.float32)
        # the reference's fast path (frames.rs:180-187) renders |ds-1| <= eps
        # as an exact unit step; snapping reproduces that exactly
        ds = np.where(np.abs(ds - np.float32(1.0)) <= EPS32, np.float32(1.0), ds)
        offset0 = (s0 - base).astype(np.float32)
        base_i = np.clip(base, -(2**30), 2**30).astype(np.int32)
        ds_int, f_hi, f_lo = split_ds(ds)
        return {
            "base": base_i,
            "offset0": offset0,
            "ds_int": ds_int,
            "f_hi": f_hi,
            "f_lo": f_lo,
            "off": self.off.copy(),
            "length": self.length.copy(),
        }

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        params = self._params_from_t(self.t, interval)
        cnt = np.broadcast_to(f64(n if count is None else count), self.batch)
        # frames.rs:198: t += f64::from(interval) * out.len()
        self.t = self.t + interval.astype(np.float64) * cnt
        return params

    def host_params_at(self, tshift, interval, n):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        t = self.t + f32(tshift).astype(np.float64)  # seek(): t += f64::from(seconds)
        return self._params_from_t(np.broadcast_to(t, self.batch), interval)

    def host_seek(self, seconds):
        """frames.rs:209-214."""
        self.t = self.t + f32(seconds).astype(np.float64)

    def host_is_finished(self):
        """frames.rs:204-206: t >= (len - 1) / rate."""
        return self.t >= (self.length.astype(np.float64) - 1.0) / self.rate

    # control-side views (frames.rs:229-248)
    def _playback_position(self):
        return np.trunc(self.t * self.rate) / self.rate

    def _control_finished(self):
        pos = np.trunc(self.t * self.rate)
        return (pos >= 0) & (pos >= self.length.astype(np.float64))

    def _own_device_data(self):
        return {"arena": _arena(self.channels).device()}

    def render(self, dstate, ddata, params, n):
        tr, fr = exact_positions(
            params["offset0"],
            params["ds_int"],
            params["f_hi"],
            params["f_lo"],
            n,
            signed=True,
        )
        s = params["base"][..., None] + tr
        arena = ddata["arena"]
        a = _arena_get(arena, params["off"], params["length"], s)
        b = _arena_get(arena, params["off"], params["length"], s + 1)
        if arena.ndim > 1:
            fr = fr[:, None]
        out = lerp(a, b, fr)
        block = out[None, :] if arena.ndim == 1 else out.T
        return dstate, block


class _FramesDR:
    """Device-resident FramesSignal support, mixed into FramesSignal."""

    def dr_supported(self):
        return True

    def dr_state_init(self, V):
        import numpy as np

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
        # the f32-quantized step is the semantic step (frames.rs:178); its
        # split decomposition is exact, so the device cursor never drifts
        ds = np.float32(np.float32(interval) * self.rate.astype(np.float32))
        if abs(ds - np.float32(1.0)) <= EPS32:
            ds = np.float32(1.0)
        ds_int, f_hi, f_lo = split_ds(ds)
        s0 = self.t * self.rate
        base = np.trunc(s0)
        return {
            "base": np.int32(np.clip(base, -(2**30), 2**30)),
            "frac": np.float32(s0 - base),
            "off": np.int32(self.off[()]),
            "length": np.int32(self.length[()]),
            "rate": np.float32(self.rate[()]),
            "r_hi": _top12_np(self.rate[()]),
            "ds_int": np.int32(ds_int),
            "f_hi": np.float32(f_hi),
            "f_lo": np.float32(f_lo),
        }

    def dr_render(self, state, ddata, interval, n, count):
        import numpy as np

        from ..ops._dev import chunked_frames, device_advance, to_trunc_form

        if isinstance(interval, (int, float, np.floating)):
            # the slot row's exact host split of the static pool interval
            ds_int, f_hi, f_lo = state["ds_int"], state["f_hi"], state["f_lo"]
        else:
            # dynamic per-voice interval (Speed chains, speed.rs:32-36),
            # with the reference's unit-step snap (frames.rs:180-187)
            from ..ops._dev import device_split_ds

            ds = state["rate"] * jnp.asarray(interval, jnp.float32)
            ds = jnp.where(jnp.abs(ds - 1.0) <= EPS32, 1.0, ds)
            ds_int, f_hi, f_lo = device_split_ds(ds)

        arena = ddata["arena"]
        off = state["off"][:, None]
        length = state["length"][:, None]

        def ev(cur, n_c):
            # exact whole-arena gather (frames.rs:176-201 resamples at any
            # ratio; get_pair's zero edges, frames.rs:105-123)
            b, o = cur
            tr, fr = exact_positions(o, ds_int, f_hi, f_lo, n_c, signed=True)
            s = b[:, None] + tr
            a = _arena_get(arena, off, length, s)
            bb = _arena_get(arena, off, length, s + 1)
            if arena.ndim > 1:
                return jnp.moveaxis(lerp(a, bb, fr[..., None]), -1, 1)
            return lerp(a, bb, fr)

        def adv(cur, n_c):
            b, o = cur
            neg = o < 0  # trunc-form -> floor-form before advancing
            return device_advance(
                b - neg.astype(jnp.int32), jnp.where(neg, o + 1.0, o),
                jnp.int32(n_c), ds_int, f_hi, f_lo,
            )  # floor-form o in [0,1) is valid trunc-form

        samples = chunked_frames(ev, adv, (state["base"], state["frac"]), n)
        base2, frac2 = device_advance(
            state["base"], state["frac"], count, ds_int, f_hi, f_lo,
        )
        base2, frac2 = to_trunc_form(base2, frac2)
        out = dict(state)
        out["base"], out["frac"] = base2, frac2
        return out, samples

    def dr_is_finished(self, state):
        """frames.rs:204-206: s >= len - 1 (s = base + frac, frac in (-1,1))."""
        return (state["base"] >= state["length"] - 1) & ~(
            (state["base"] == state["length"] - 1) & (state["frac"] < 0)
        )

    # -- device-resident Seek mode (frames.rs:209-214) -------------------------
    # The spatial seek path samples at cursor + t0 + j*dt per ear, with the
    # same exact arena gather as dr_render.  The sample
    # shift t0*rate uses the split-product (ops/_dev.py::warp_shift) so f32
    # stays within ~1e-5 samples of the host path's f64 cursor shifts.

    def dr_seek_supported(self):
        return (
            self.channels == 1
            and type(self).host_is_finished is FramesSignal.host_is_finished
        )

    def _dr_warp_cursor(self, state, t0, wrap):
        """Shifted trunc-form cursors (base2, o0) for (V, E) second-offsets."""
        from ..ops._dev import warp_shift

        si, sf = warp_shift(state["rate"], state["r_hi"], t0)
        u = state["frac"][:, None] + sf
        uf = jnp.floor(u)
        base2 = state["base"][:, None] + si + uf.astype(jnp.int32)
        o0 = u - uf
        if wrap:  # cycle.rs:56-60 rem_euclid
            return jnp.mod(base2, state["length"][:, None]), o0
        neg = (base2 < 0) & (o0 > 0)  # trunc-toward-zero form
        return jnp.where(neg, base2 + 1, base2), jnp.where(neg, o0 - 1.0, o0)

    def dr_warp_render(self, state, ddata, t0, dt, n):
        from ..ops._dev import chunked_frames, device_advance, device_split_ds

        V, E = t0.shape
        base2, o0 = self._dr_warp_cursor(state, t0, wrap=False)
        ds = dt * state["rate"][:, None]
        ds = jnp.where(jnp.abs(ds - 1.0) <= EPS32, 1.0, ds)
        ds_int, f_hi, f_lo = device_split_ds(ds)
        dsf = (ds_int.reshape(-1), f_hi.reshape(-1), f_lo.reshape(-1))
        arena = ddata["arena"]
        off = jnp.repeat(state["off"], E)[:, None]
        length = jnp.repeat(state["length"], E)[:, None]

        def ev(cur, n_c):
            # exact whole-arena gather (frames.rs:176-201, any ratio)
            b, o = cur
            tr, fr = exact_positions(o, *dsf, n_c, signed=True)
            s = b[:, None] + tr
            a = _arena_get(arena, off, length, s)
            return lerp(a, _arena_get(arena, off, length, s + 1), fr)

        def adv(cur, n_c):
            b, o = cur
            neg = o < 0  # trunc-form -> floor-form before advancing
            return device_advance(
                b - neg.astype(jnp.int32), jnp.where(neg, o + 1.0, o),
                jnp.int32(n_c), *dsf,
            )

        samples = chunked_frames(
            ev, adv, (base2.reshape(-1), o0.reshape(-1)), n
        )
        return samples.reshape(V, E, n)

    def dr_advance(self, state, seconds):
        from ..ops._dev import to_trunc_form, warp_shift

        t = jnp.full(state["base"].shape + (1,), np.float32(seconds), jnp.float32)
        base2, o0 = self._dr_warp_cursor(state, t, wrap=self._dr_wrap)
        out = dict(state)
        if self._dr_wrap:
            out["base"], out["frac"] = base2[:, 0], o0[:, 0]
        else:
            out["base"], out["frac"] = to_trunc_form(base2[:, 0], o0[:, 0])
        return out

    _dr_wrap = False


for _name in (
    "dr_supported",
    "dr_state_init",
    "dr_slot_row",
    "dr_render",
    "dr_is_finished",
    "dr_seek_supported",
    "_dr_warp_cursor",
    "dr_warp_render",
    "dr_advance",
    "_dr_wrap",
):
    setattr(FramesSignal, _name, getattr(_FramesDR, _name))


class FramesSignalControl:
    """Playback-position readout (frames.rs:223-248)."""

    def __init__(self, cb):
        self._cb = cb

    def _dr_cursor(self):
        """(base, length, rate) for a voice living in a device-resident
        pool, read from the pool's state (one small readback per query —
        the analogue of the reference's position atomic)."""
        pool, slot, gen, path = self._cb._dr
        if pool.slot_gen[slot] != gen or pool.state is None:
            return None
        for slot_i, _row in pool.pending_plays:
            if slot_i == slot:  # queued play not yet applied
                return None
        t = pool.state["inner"]
        for k in path:
            t = t[k]
        return (
            float(np.asarray(t["base"][slot])),
            float(np.asarray(t["length"][slot])),
            float(np.asarray(t["rate"][slot])),
        )

    def playback_position(self):
        if not self._cb.live():
            return 0.0
        if self._cb._dr is not None:
            cur = self._dr_cursor()
            if cur is None:  # pre-play: the spec mirror is current
                sig = self._cb.sig
                return float(sig._playback_position()[self._cb.idx])
            base, _, rate = cur
            return base / rate
        sig, idx = self._cb.sig, self._cb.idx
        return float(sig._playback_position()[idx])

    def is_finished(self):
        if not self._cb.live():
            return True
        if self._cb._dr is not None:
            cur = self._dr_cursor()
            if cur is None:
                sig = self._cb.sig
                return bool(sig._control_finished()[self._cb.idx])
            base, length, _ = cur
            return base >= 0 and base >= length
        sig, idx = self._cb.sig, self._cb.idx
        return bool(sig._control_finished()[idx])
