"""Sine oscillator.

Reference: /root/reference/src/sine.rs — emits ``sin(i*interval*freq + phase)``
per frame (sine.rs:34-40) and wraps the phase modulo TAU after each block for
numerical stability no matter how long it plays (sine.rs:25-28).  The phase
wrap uses Rust ``%`` (fmod) semantics.

Device form: the block is a pure function of (interval, freq, phase); the f32
phase is host state advanced per block.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.hostmath import TAU32, f32, full, rust_rem
from ..core.signal import Signal
from ._dev import (
    chunked_frames,
    device_advance,
    exact_positions,
    sin_turns,
    split_ds,
)

__all__ = ["Sine"]


class Sine(Signal):
    seekable = True
    _host_fields = ("phase", "freq")

    def __init__(self, phase=0.0, frequency_hz=440.0):
        super().__init__()
        self._alloc_host(())
        self.phase[()] = f32(phase)
        # sine.rs:19-22: frequency stored in radians per second
        self.freq[()] = f32(frequency_hz) * TAU32

    @classmethod
    def new(cls, phase, frequency_hz):
        return cls(phase, frequency_hz)

    def _alloc_host(self, batch):
        # phase is kept in f64 on the host (the device only ever sees the
        # f32 rounding of the wrapped phase), so the wrap arithmetic never
        # accumulates f32 error across blocks; the modulus stays the
        # reference's f32 TAU (sine.rs:25-28).
        self.phase = full(batch, 0.0, np.float64)
        self.freq = full(batch, 0.0)

    def _seek_to(self, t):
        # sine.rs:25-28
        self.phase = rust_rem(
            self.phase + np.float64(1.0) * np.asarray(t, np.float64) * self.freq,
            np.float64(TAU32),
        )

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        params = self._cycle_params(interval)
        cnt = n if count is None else count
        cnt = np.broadcast_to(f32(cnt), self.batch)
        # sine.rs:38-39: seek_to(interval * out.len() as f32)
        self._seek_to((interval * cnt).astype(np.float32))
        return params

    def _cycle_params(self, interval):
        """Per-frame phase in *cycles* with the exact-split decomposition, so
        the device evaluates sin on an argument already wrapped into
        [0, TAU) — avoiding both f32 argument-magnitude rounding and XLA's
        large-argument range reduction (the reference's f32 ``t*freq+phase``
        carries ~eps*|arg| of its own rounding; this is the exact-math
        version of the same semantics)."""
        tau = np.float64(TAU32)
        dc = interval.astype(np.float64) * (self.freq.astype(np.float64) / tau)
        dc_int, f_hi, f_lo = split_ds(dc)
        c0 = (self.phase / tau).astype(np.float32)
        return {
            "c0": np.broadcast_to(c0, self.batch).astype(np.float32),
            "dc_int": np.broadcast_to(dc_int, self.batch).astype(np.int32),
            "f_hi": np.broadcast_to(f_hi, self.batch).astype(np.float32),
            "f_lo": np.broadcast_to(f_lo, self.batch).astype(np.float32),
        }

    def host_params_at(self, tshift, interval, n):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        saved = self.phase
        self.phase = rust_rem(
            self.phase + np.asarray(f32(tshift), np.float64) * self.freq,
            np.float64(TAU32),
        )
        params = self._cycle_params(interval)
        self.phase = saved
        return params

    def host_seek(self, seconds):
        self._seek_to(f32(seconds))

    def render(self, dstate, ddata, params, n):
        # sine.rs:34-40: out = sin(t*freq + phase), evaluated as
        # sin(TAU * frac(c0 + i*dc)) with near-exact cycle positions
        _, frac = exact_positions(
            params["c0"], params["dc_int"], params["f_hi"], params["f_lo"], n
        )
        block = sin_turns(frac)
        return dstate, block[None, :]

    # -- device-resident mode ------------------------------------------------

    def dr_supported(self):
        # DR reproduces the default never-finishes semantics only
        return type(self).host_is_finished is Signal.host_is_finished

    # The device-resident cycle cursor is a 48-bit fixed-point accumulator
    # held as two 24-bit int32 limbs (acc_a in 2^-24 cycles, acc_b in 2^-48),
    # advanced with exact integer limb arithmetic: unlike an f32 phase walk
    # it NEVER drifts, matching the host path's f64 cursor (sine.rs:25-28
    # semantics) for arbitrarily long renders.  The per-frame step ships as
    # four 12-bit limbs of frac(dc)*2^48 plus the split-ds pieces for
    # in-block positions (ops/_dev.py).

    def dr_state_init(self, V):
        return {
            "freq": np.zeros(V, np.float32),
            "cyc": np.zeros(V, np.float32),  # wrapped phase in cycles [0,1)
            "dc_int": np.zeros(V, np.int32),
            "f_hi": np.zeros(V, np.float32),
            "f_lo": np.zeros(V, np.float32),
            "step_l": np.zeros((V, 4), np.int32),  # 12-bit limbs of frac(dc)
            "acc_a": np.zeros(V, np.int32),
            "acc_b": np.zeros(V, np.int32),
        }

    def dr_slot_row(self, interval):
        tau = np.float64(TAU32)
        c0 = np.float64(np.mod(self.phase[()] / tau, 1.0))
        # mirror _cycle_params: dc in f64, then the exact split
        dc = np.float64(interval) * (np.float64(self.freq[()]) / tau)
        dc_int, f_hi, f_lo = split_ds(dc)
        f48 = np.floor((dc - np.floor(dc)) * np.float64(2**48))
        a48 = np.floor(c0 * np.float64(2**48))
        limbs = np.array(
            [np.mod(np.floor(f48 / 2.0 ** (36 - 12 * i)), 4096) for i in range(4)],
            np.int32,
        )
        return {
            "freq": np.float32(self.freq[()]),
            "cyc": np.float32(c0),
            "dc_int": np.int32(dc_int),
            "f_hi": np.float32(f_hi),
            "f_lo": np.float32(f_lo),
            "step_l": limbs,
            "acc_a": np.int32(np.floor(a48 / 2.0**24)),
            "acc_b": np.int32(np.mod(a48, 2.0**24)),
        }

    @staticmethod
    def _acc_c0(state):
        return (
            state["acc_a"].astype(jnp.float32) * np.float32(2.0**-24)
            + state["acc_b"].astype(jnp.float32) * np.float32(2.0**-48)
        )

    @staticmethod
    def _acc_advance(state, count):
        """Advance the 48-bit cycle accumulator by ``count`` frames (< 4096)
        of frac(dc), exactly: every product is <= 24 bits, integer cycles
        drop, carries propagate between the limbs."""
        c = count.astype(jnp.int32)
        Ah, Al, Bh, Bl = (state["step_l"][:, i] for i in range(4))
        M24 = np.int32(1 << 24)
        cAh, cAl, cBh, cBl = c * Ah, c * Al, c * Bh, c * Bl
        lowB = (cBh % 4096) * 4096 + cBl
        carB = cBh // 4096 + lowB // M24
        lowB = lowB % M24
        lowA = ((cAh % 4096) * 4096 + cAl) % M24  # overflow = whole cycles
        b2 = state["acc_b"] + lowB
        a2 = (state["acc_a"] + lowA + carB + b2 // M24) % M24
        return a2, b2 % M24

    def dr_render(self, state, ddata, interval, n, count):
        import jax.numpy as jnp
        from ._dev import device_split_ds

        out = dict(state)
        if isinstance(interval, (int, float, np.floating)):
            # static pool interval: the slot row's exact f64-derived step
            c0 = self._acc_c0(state)
            _, frac = exact_positions(
                c0, state["dc_int"], state["f_hi"], state["f_lo"], n
            )
            out["acc_a"], out["acc_b"] = self._acc_advance(state, count)
            out["cyc"] = (
                out["acc_a"].astype(jnp.float32) * np.float32(2.0**-24)
                + out["acc_b"].astype(jnp.float32) * np.float32(2.0**-48)
            )
            return out, sin_turns(frac)

        # dynamic per-voice interval (under Speed, speed.rs:32-36): re-derive
        # the step in-graph; f32 quantization of dc costs <= n*eps*dc
        # (~1e-5 rad per block); the advance re-quantizes onto the 48-bit
        # accumulator (no extra drift beyond the f32 step itself)
        dc = state["freq"] * interval * np.float32(1.0 / np.float64(TAU32))
        dc_int, f_hi, f_lo = device_split_ds(dc)
        c0 = self._acc_c0(state)
        _, frac = exact_positions(c0, dc_int, f_hi, f_lo, n)
        samples = sin_turns(frac)
        cf = count.astype(jnp.float32)
        H = cf * f_hi  # exact
        adv = (H - jnp.floor(H)) + cf * f_lo
        adv = adv - jnp.floor(adv)
        a48 = jnp.floor(adv * np.float32(2.0**24))
        lo48 = jnp.floor((adv * np.float32(2.0**24) - a48) * np.float32(2.0**24))
        M24 = np.int32(1 << 24)
        b2 = state["acc_b"] + lo48.astype(jnp.int32)
        a2 = (state["acc_a"] + a48.astype(jnp.int32) + b2 // M24) % M24
        out["acc_a"], out["acc_b"] = a2, b2 % M24
        out["cyc"] = self._acc_c0(out)
        return out, samples

    def dr_is_finished(self, state):
        return jnp.zeros(state["freq"].shape, dtype=bool)

    # -- device-resident Seek mode --------------------------------------------

    def dr_seek_supported(self):
        return self.dr_supported()

    def dr_warp_render(self, state, ddata, t0, dt, n):
        from ._dev import device_split_ds

        inv_tau = np.float32(1.0 / np.float64(TAU32))
        fcyc = state["freq"] * inv_tau  # cycles per second
        # time-shifted start phase in cycles: cyc + t0*fcyc, wrapped.  The
        # f32 product t0*fcyc rounds by ~eps*|t0*fcyc| (<= ~2e-5 cycles at
        # 0.15 s offsets / 2 kHz) — the same order as the reference's own
        # f32 ``phase + t*freq`` seek (sine.rs:25-28).
        oc = t0 * fcyc[:, None]  # (V, E)
        oc = oc - jnp.floor(oc)
        c0 = state["cyc"][:, None] + oc
        c0 = c0 - jnp.floor(c0)
        dc = dt * fcyc[:, None]  # warped cycles per frame (V, E)
        dc_int, f_hi, f_lo = device_split_ds(dc)

        def ev(c0_c, n_c):
            _, frac = exact_positions(c0_c, dc_int, f_hi, f_lo, n_c)
            return sin_turns(frac)

        def adv(c0_c, n_c):
            _, f2 = device_advance(
                jnp.zeros_like(dc_int), c0_c, jnp.int32(n_c), dc_int, f_hi, f_lo
            )
            return f2

        return chunked_frames(ev, adv, c0, n)

    def dr_advance(self, state, seconds):
        inv_tau = np.float32(1.0 / np.float64(TAU32))
        adv = state["freq"] * (np.float32(seconds) * inv_tau)
        cyc2 = state["cyc"] + (adv - jnp.floor(adv))
        out = dict(state)
        out["cyc"] = cyc2 - jnp.floor(cyc2)
        return out
