"""Automatic gain control (AGC).

Reference: /root/reference/src/adapt.rs — per frame, maintains an exponential
moving average of the squared summed-channel level with time constant ``tau``
(``alpha = 1 - exp(-interval/tau)``, adapt.rs:70-75) and applies a gain
pulling the average peak into [low, high], capped at ``max_gain``
(adapt.rs:76-86).

Device form: the per-frame EMA is a LINEAR recurrence (``avg' = avg*(1-a) +
a*s^2`` — an affine map per frame), so instead of a 512-step sequential
``lax.scan`` it runs as a log-depth ``lax.associative_scan`` over the
per-frame affine maps ``(m, b) = (1-a_i, a_i*s_i^2)`` composed as
``(m1*m2, b1*m2 + b2)``.  The gain math is elementwise from the
exclusive-scan carries.  Numerics match the sequential order up to
tree-reassociation rounding (~1e-6 relative; the golden contract is 1e-5 —
reference adapt.rs:69-88 itself rounds per frame).  A ``count`` mask keeps
the carry exact when fewer frames are actually consumed (spatial ring
writers): masked frames compose as the identity map, freezing the carry
exactly like the sequential path.

In DR pools the scan is replaced by a closed form (``ema_gain_closed``)
whenever the pool-tracked tau bound holds: the scan's odd/even lane slicing
expands to ~300 ops per Adapt instance, while the closed form is a handful
of elementwise ops and one cumsum.  The ``_pool_ema_fast`` archetype flag
gates it; this scan path remains the fallback for pathological taus and
blocks longer than EMA_NMAX.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.hostmath import f32, full
from ..core.signal import Signal

__all__ = ["Adapt", "AdaptOptions"]

_SQRT2 = np.sqrt(np.float32(2.0), dtype=np.float32)

#: frame bound the pools' closed-form gate is computed at (blocks are
#: chunked to <= 512 frames everywhere; see ops/_dev.py::chunked_frames)
EMA_NMAX = 512
#: max EMA_NMAX * interval/tau the closed form accepts: exp arguments stay
#: in [-32, 32] (no overflow, <= 6e-7 gain error vs the sequential oracle)
EMA_GATE = 32.0


def _ema_gain(avg0, s, alpha, count, low, high, max_gain, n):
    """Shared EMA + gain pipeline over the frame axis (last axis of ``s``).

    ``avg0`` (...,): the carried average-squared level; ``s`` (..., n):
    summed-channel frame levels; ``alpha/low/high/max_gain`` (...,) or
    scalars; ``count`` (...,) int32 consumed-frame bound.  Returns
    (gains (..., n), new carry (...,)).

    The recurrence ``avg_i = avg_{i-1}*(1-a) + a*s_i^2`` (adapt.rs:69-75)
    runs as an associative scan of affine-map compositions; frames at
    ``i >= count`` compose as the identity (a_eff = 0), so the carry
    freezes exactly like the sequential mask did, while their OUTPUT gain
    still sees a one-step EMA from the frozen carry (same semantics as
    the reference's per-frame loop on a partial block)."""
    s2 = s * s
    i_n = jnp.arange(n, dtype=jnp.int32)
    live = i_n < count[..., None]
    a = alpha[..., None]
    a_eff = jnp.where(live, a, 0.0)
    m = 1.0 - a_eff
    b = a_eff * s2

    def comb(l, r):
        ml, bl = l
        mr, br = r
        return ml * mr, bl * mr + br

    mi, bi = jax.lax.associative_scan(comb, (m, b), axis=-1)
    # exclusive carries: prev_i = composition of frames [0, i) applied to avg0
    m_prev = jnp.concatenate([jnp.ones_like(mi[..., :1]), mi[..., :-1]], -1)
    b_prev = jnp.concatenate([jnp.zeros_like(bi[..., :1]), bi[..., :-1]], -1)
    prev = m_prev * avg0[..., None] + b_prev
    avg2 = s2 * a + prev * (1.0 - a)  # true alpha: outputs past count too
    avg_peak = jnp.sqrt(avg2) * _SQRT2
    lo = low[..., None]
    gain = jnp.where(
        avg_peak < lo,
        jnp.minimum(lo / avg_peak, max_gain[..., None]),
        jnp.where(avg_peak > high[..., None], high[..., None] / avg_peak, 1.0),
    )
    carry = mi[..., -1] * avg0 + bi[..., -1]
    return gain, carry


def ema_gain_closed(avg0, s, alpha, count, low, high, max_gain, n):
    """The EMA + gain pipeline of ``_ema_gain`` in closed form, no scan::

        c_i    = min(i+1, count)          live frames through i (count
                                          freezes the carry, adapt.rs:69-75)
        M_i    = exp(c_i * log1p(-a))     the decay prefix, elementwise
        csum   = cumsum(live * a*s^2/M)
        prev_i = M_{i-1} * (avg0 + csum_{i-1})
        avg_i  = a*s_i^2 + (1-a)*prev_i,  gain_i as adapt.rs:76-86

    Valid while the M factors stay in f32 range: callers gate it on
    ``EMA_NMAX * interval/tau <= EMA_GATE`` and ``n <= EMA_NMAX``."""
    s2 = s * s
    i_n = jnp.arange(n, dtype=jnp.int32)
    live = i_n < count[..., None]
    a = alpha[..., None]
    c = jnp.minimum(i_n + 1, count[..., None]).astype(jnp.float32)
    lg = jnp.log1p(-a)
    M = jnp.exp(c * lg)
    terms = jnp.where(live, (a * s2) / M, 0.0)
    csum = jnp.cumsum(terms, axis=-1)
    carry = M[..., -1] * (avg0 + csum[..., -1])
    prev_c = jnp.minimum(i_n.astype(jnp.float32), count[..., None].astype(jnp.float32))
    prev = jnp.exp(prev_c * lg) * (avg0[..., None] + (csum - terms))
    avg2 = s2 * a + prev * (1.0 - a)
    avg_peak = jnp.sqrt(avg2) * _SQRT2
    lo = low[..., None]
    gain = jnp.where(
        avg_peak < lo,
        jnp.minimum(lo / avg_peak, max_gain[..., None]),
        jnp.where(avg_peak > high[..., None], high[..., None] / avg_peak, 1.0),
    )
    return gain, carry


class AdaptOptions:
    """adapt.rs:36-61."""

    def __init__(self, tau=0.1, max_gain=np.inf, low=None, high=None):
        self.tau = np.float32(tau)
        self.max_gain = np.float32(max_gain)
        self.low = np.float32(0.1) / _SQRT2 if low is None else np.float32(low)
        self.high = np.float32(0.5) / _SQRT2 if high is None else np.float32(high)


class Adapt(Signal):
    _host_fields = ("tau", "max_gain", "low", "high", "avg0")
    _dr_ingest_transparent = True

    def __init__(self, signal, initial_rms, options=None):
        super().__init__()
        options = options or AdaptOptions()
        self.inner = signal
        self.channels = signal.channels
        self._alloc_host(())
        self.tau[()] = options.tau
        self.max_gain[()] = options.max_gain
        self.low[()] = options.low
        self.high[()] = options.high
        # adapt.rs:25-31: avg_squared = initial_rms^2
        self.avg0[()] = np.float32(initial_rms) * np.float32(initial_rms)

    def children(self):
        return {"inner": self.inner}

    def _alloc_host(self, batch):
        self.tau = full(batch, 0.1)
        self.max_gain = full(batch, 1.0)
        self.low = full(batch, 0.1)
        self.high = full(batch, 0.5)
        self.avg0 = full(batch, 1.0)

    def _own_device_init(self):
        return {"avg": jnp.asarray(self.avg0)}

    def _own_slot_init(self, i):
        return {"avg": np.float32(self.avg0[i])}

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        # adapt.rs:70: alpha = 1 - exp(-interval / tau)
        alpha = (np.float32(1.0) - np.exp(-interval / self.tau)).astype(np.float32)
        cnt = np.broadcast_to(
            np.asarray(n if count is None else count, np.int32), self.batch
        )
        return {
            "alpha": alpha,
            "max_gain": self.max_gain.copy(),
            "low": self.low.copy(),
            "high": self.high.copy(),
            "count": cnt.copy(),
            "inner": self.inner.host_prepare(interval, n, count),
        }

    def host_is_finished(self):
        return self.inner.host_is_finished()

    def host_ema_bound(self, interval):
        """Max interval/tau in this chain (DR pools gate the closed-form
        AGC on EMA_NMAX * bound <= EMA_GATE; see ema_gain_closed)."""
        tau = float(np.min(self.tau)) if getattr(self.tau, "ndim", 0) else float(self.tau)
        own = float(np.float32(interval)) / max(tau, 1e-30)
        return max(own, self.inner.host_ema_bound(interval))

    def _arch_extra(self):
        # the pool-stamped closed-form flag is trace-relevant
        return (bool(getattr(self, "_pool_ema_fast", False)),)

    def render(self, dstate, ddata, params, n):
        d2, block = self.inner.render(
            dstate.get("inner", {}), ddata.get("inner", {}), params["inner"], n
        )
        s = jnp.sum(block, axis=0)  # (n,) sum of channels (adapt.rs:73)
        gain, avg = _ema_gain(
            dstate["avg"][None], s[None], params["alpha"][None],
            jnp.asarray(params["count"], jnp.int32)[None],
            params["low"][None], params["high"][None],
            params["max_gain"][None], n,
        )
        return {"avg": avg[0], "inner": d2}, block * gain[0][None, :]

    # -- device-resident mode ------------------------------------------------
    # The EMA carry lives on device already; in DR pools the option columns
    # join it and the associative scan runs batched over the whole pool
    # (the same _ema_gain op order as the vmapped host path — bit-identical).

    def dr_supported(self):
        return self.inner.dr_supported()

    def dr_state_init(self, V):
        return {
            "tau": np.full(V, 0.1, np.float32),
            "max_gain": np.ones(V, np.float32),
            "low": np.full(V, 0.1, np.float32),
            "high": np.full(V, 0.5, np.float32),
            "avg": np.ones(V, np.float32),
            "inner": self.inner.dr_state_init(V),
        }

    def dr_slot_row(self, interval):
        return {
            "tau": np.float32(self.tau[()]),
            "max_gain": np.float32(self.max_gain[()]),
            "low": np.float32(self.low[()]),
            "high": np.float32(self.high[()]),
            "avg": np.float32(self.avg0[()]),
            "inner": self.inner.dr_slot_row(interval),
        }

    def dr_render(self, state, ddata, interval, n, count):
        d2, samples = self.inner.dr_render(
            state["inner"], ddata.get("inner", {}), interval, n, count
        )
        # adapt.rs:70: alpha = 1 - exp(-interval / tau)
        alpha = 1.0 - jnp.exp(-jnp.asarray(interval, jnp.float32) / state["tau"])
        cnt = jnp.broadcast_to(
            jnp.asarray(count, jnp.int32), state["avg"].shape
        )
        # frame-generic: the level is the summed-channel frame (adapt.rs:73),
        # one gain per frame scales every channel (adapt.rs:84-86)
        s = samples if samples.ndim == 2 else jnp.sum(samples, axis=1)
        ema = (
            ema_gain_closed
            if getattr(self, "_pool_ema_fast", False) and n <= EMA_NMAX
            else _ema_gain
        )
        gain, avg = ema(
            state["avg"], s, alpha, cnt,
            state["low"], state["high"], state["max_gain"], n,
        )
        st = dict(state)
        st["avg"], st["inner"] = avg, d2
        g = gain if samples.ndim == 2 else gain[:, None, :]
        return st, samples * g

    def dr_is_finished(self, state):
        return self.inner.dr_is_finished(state["inner"])
