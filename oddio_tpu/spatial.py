"""3D spatial audio scene — the flagship dense-batch engine.

Reference: /root/reference/src/spatial.rs — ``SpatialScene`` spatializes mono
signals into stereo with stereo panning, distance attenuation, doppler (via
time-varying propagation offsets resampling the source) and propagation
delay.  Two voice families exist:

* ``play`` (spatial.rs:289-302): ``Seek``-able sources, re-sampled per ear by
  seeking to the ear's delayed start time and sampling with a warped interval
  (spatial.rs:438-470) — doppler by time-warp.
* ``play_buffered`` (spatial.rs:314-340): arbitrary sources pre-rendered at a
  fixed rate into a per-voice ``Ring`` delay line (ring.rs:4-79), read back at
  fractional, time-varying offsets (spatial.rs:395-433).

Per block the reference, per voice: refreshes motion (swap channel) with 0.5 s
position smoothing and discontinuity handling (spatial.rs:216-239, 501-511),
rotates positions into listener space with the (inverted) listener quaternion,
computes per-ear gains/offsets (EarState, spatial.rs:530-550), linearly
interpolates offset & gain across the block, and accumulates into the ears;
finished voices linger for ``distance/c`` before reclamation
(spatial.rs:241-261).

Batch redesign (SURVEY.md §7): all *geometry* — smoothing, quaternion rotation,
ear gains/offsets, lingering — is per-voice-per-block scalar math and runs on
the **host** in vectorized f32 numpy with the reference's exact op order
(replacing the swap/atomic control plane).  The *audio* path runs on device:
one batched ``(voice, ear, frame)`` computation per pool — delay rings are a
dense ``(V, L)`` tensor written by masked scatter and read by a fractional
``gather + lerp`` at ``offset0 + j*ds mod cap``, with per-frame gain ramps
fused in, reduced over voices into the ``(2, n)`` output block.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from .core.hostmath import (
    f32,
    full,
    quat_invert,
    quat_rotate,
    rem_euclid,
    rust_rem,
    v3_dot,
    v3_norm,
)
from .core.signal import Signal
from .ops._dev import (
    WARP_CHUNK,
    device_advance,
    device_split_ds,
    exact_positions,
    split_ds,
)

__all__ = [
    "SpatialScene",
    "SpatialSceneControl",
    "Spatial",
    "SpatialOptions",
    "SPEED_OF_SOUND",
    "HEAD_RADIUS",
]

from .ops.geometry import (  # noqa: F401  (re-exported API surface)
    EAR_DIR,
    EAR_POS,
    HEAD_RADIUS,
    POSITION_SMOOTHING_PERIOD,
    SPEED_OF_SOUND,
)

DEFAULT_CAPACITY = 16

#: row width of the host buffered pool's ring storage ((V * rows, RING_ROW))
RING_ROW = 128

#: DR ring page size (samples): pool moduli are multiples of it
PAGE = 1024


def _select_window(n, emax2, K, SB=128):
    """Per-voice read-window width (a multiple of 128) an ``n``-frame read
    chunk spans: inter-ear stagger (< emax2) + frames + doppler walk (<= 2K)
    + the lerp's +1, in SB-frame sub-blocks.  The read-tier ladder admits a
    tier only when this fits the ring's mirror width (M_PAD)."""
    nsb = -(-n // SB)
    return (nsb - 1) * SB + -(-(emax2 + SB + 2 * K + 1) // 128) * 128


def _ring_reader():
    """The DR ring read for the platform this trace targets: the fused
    Triton kernel on NVIDIA GPUs (it beat the plain read end to end on
    the 4096-voice buffered scene, PERF.md), the plain XLA read
    elsewhere.  The target is the default device, which
    ``jax.default_device`` overrides."""
    dev = jax.config.jax_default_device
    if dev is None:
        platform = jax.default_backend()
    else:
        platform = dev if isinstance(dev, str) else dev.platform
    if platform in ("gpu", "cuda"):
        from .ops.ring_read_triton import ring_read_triton

        return ring_read_triton
    return _ring_read


def _ring_append(flat, samples, start, cap, chunk, mirror):
    """Write ``samples`` (V, W) into every voice's ring at the shared
    cursor ``start`` (mod ``cap``) — Ring::write, ring.rs:18-41.

    ``flat`` is the (V, rowlen) ring view: ``chunk`` front-pad columns,
    the ``cap``-sample ring, a ``mirror``-wide copy of ring [0, mirror),
    and ``chunk`` dump columns.  Each <= chunk-wide sub-slab lands as TWO
    dynamic_update_slices: the primary leg at the cursor, and a second leg
    that keeps the mirror invariant — into the mirror when the slab
    touches [0, mirror); shifted by -cap when it runs past cap (the
    wrapped tail lands on its home at ring [0, ...), the head in the front
    pad); into the dump slack otherwise."""
    for k in range(0, samples.shape[1], chunk):
        piece = samples[:, k : k + chunk]
        width = piece.shape[1]
        ck = jnp.mod(start + k, cap)
        flat = jax.lax.dynamic_update_slice(flat, piece, (0, chunk + ck))
        c2 = chunk + jnp.where(
            ck + width > cap, ck - cap,
            jnp.where(ck < mirror, ck + cap, cap + mirror),
        )
        flat = jax.lax.dynamic_update_slice(flat, piece, (0, c2))
    return flat


def _ring_read(flat, voff, base_c, frac_c, split_c, g0_c, dg_c, n, cap):
    """Fractional per-ear delay-ring reads with gain ramps, summed over
    voices (ring.rs:51-79, spatial.rs:409-431): ``out[e, j] = sum_v
    (g0 + j*dg) * lerp(ring[x], ring[x+1], fr)`` at the exact split-ds
    positions ``x + fr = base + frac + j*ds`` (mod ``cap``).

    ``flat`` is the whole ring storage flattened; ``voff`` (Vr,) int32 the
    flat index of each rendered voice's ring sample 0.  Per-ear args are
    (Vr,) component lists: ``base_c`` int32 and ``frac_c`` in [0, 1) the
    start cursor, ``split_c`` = [(ds_int, f_hi, f_lo)] the step, ``g0_c`` /
    ``dg_c`` the gain ramp with the voice mask folded in (exact for 0/1
    masks).  A frozen voice (ds = 0, spatial.rs:414-416) reads one constant
    position exactly.  Returns (2, n)."""
    rows = []
    for e in range(2):
        ds_int, f_hi, f_lo = split_c[e]
        whole, fr = exact_positions(frac_c[e], ds_int, f_hi, f_lo, n)
        x = jnp.mod(base_c[e][:, None] + whole, cap)
        a = jnp.take(flat, voff[:, None] + x)
        b = jnp.take(flat, voff[:, None] + jnp.mod(x + 1, cap))
        s = a + fr * (b - a)
        jn = jnp.arange(n, dtype=jnp.float32)
        gains = g0_c[e][:, None] + jn[None, :] * dg_c[e][:, None]
        rows.append(jnp.sum(s * gains, axis=0))
    return jnp.stack(rows)


def _smooth_host(prev, smdt, dt_extra, mpos, mvel):
    """Host twin of ops.geometry.smoothed_position (spatial.rs:501-511):
    same f32 term order, batched (V, 3) numpy.  Drives the per-block read
    walk bound without any device sync."""
    dt = (smdt + np.float32(dt_extra)).astype(np.float32)
    change = (mvel * dt[:, None]).astype(np.float32)
    naive = (prev + change).astype(np.float32)
    intended = (mpos + change).astype(np.float32)
    r = np.minimum(dt / POSITION_SMOOTHING_PERIOD, np.float32(1.0))[:, None]
    return ((np.float32(1.0) - r) * naive + r * intended).astype(np.float32)


class SpatialOptions:
    """Passed to play/play_buffered (spatial.rs:352-371)."""

    def __init__(self, position=(0.0, 0.0, 0.0), velocity=(0.0, 0.0, 0.0), radius=0.1):
        self.position = f32(position)
        self.velocity = f32(velocity)
        self.radius = np.float32(radius)


def _smoothed_position(prev_position, state_dt, dt_extra, motion_pos, motion_vel):
    """State::smoothed_position (spatial.rs:501-511), vectorized over voices.

    dt = state.dt + dt_extra; mix(prev + v*dt, intended + v*dt, min(dt/0.5,1))
    """
    dt = (state_dt + np.float32(dt_extra)).astype(np.float32)
    change = motion_vel * dt[:, None]
    naive = prev_position + change
    intended = motion_pos + change
    r = np.minimum((dt / POSITION_SMOOTHING_PERIOD).astype(np.float32), np.float32(1.0))[
        :, None
    ]
    return ((np.float32(1.0) - r) * naive + r * intended).astype(np.float32)


def _ear_states(position, radius):
    """EarState::new for both ears (spatial.rs:530-550), vectorized.

    position: (V, 3) listener-space position; radius: (V,).
    Returns offset (V, 2) seconds (negative) and gain (V, 2).
    """
    rel = position[:, None, :] - EAR_POS[None, :, :]  # (V, 2, 3)
    distance = v3_norm(rel)  # (V, 2)
    offset = distance * (np.float32(-1.0) / SPEED_OF_SOUND)
    distance_gain = radius[:, None] / np.maximum(distance, radius[:, None])
    # scale(position_wrt_listener, 0.5 / distance) then dot with ear dir
    inv = (np.float32(0.5) / distance).astype(np.float32)
    scaled = position[:, None, :] * inv[:, :, None]
    d = v3_dot(EAR_DIR[None, :, :], scaled)
    stereo_gain = np.float32(0.5) + np.where(
        distance < np.float32(1e-3), np.float32(0.5), d
    )
    return offset.astype(np.float32), (stereo_gain * distance_gain).astype(np.float32)


class _VoicePool:
    """Shared voice bookkeeping for both spatial pool kinds: the motion swap
    channels, smoothing state, lingering reclamation, and slot lifecycle."""

    #: set by ScenePack (see _DRPoolBase._unpack_hook): host pools' device
    #: leaves (rings, inner _dev state) also go stale while packed
    _unpack_hook = None

    def __init__(self, name, spec, capacity):
        self.name = name
        self.proto = spec
        self.sig = spec.clone_batched(capacity)
        self.capacity = capacity
        self._alloc_cols(capacity)
        self._free = list(range(capacity - 1, -1, -1))

    def _alloc_cols(self, V):
        self.mask = np.zeros(V, dtype=bool)
        self.stopped = np.zeros(V, dtype=bool)
        self.slot_gen = np.zeros(V, dtype=np.int64)
        self.radius = full((V,), 0.1)
        self.motion_pos = full((V,), 0.0, extra=(3,))
        self.motion_vel = full((V,), 0.0, extra=(3,))
        self.pend_flag = np.zeros(V, dtype=bool)
        self.pend_pos = full((V,), 0.0, extra=(3,))
        self.pend_vel = full((V,), 0.0, extra=(3,))
        self.pend_disc = np.zeros(V, dtype=bool)
        self.prev_position = full((V,), 0.0, extra=(3,))
        self.dt = full((V,), 0.0)
        self.finished_for = full((V,), np.nan)

    _COL_NAMES = (
        "mask stopped slot_gen radius motion_pos motion_vel pend_flag pend_pos "
        "pend_vel pend_disc prev_position dt finished_for"
    ).split()

    def grow(self):
        if self._unpack_hook is not None:
            self._unpack_hook()
        old = self.capacity
        new = old * 2
        self.sig.grow_batched(new)
        saved = {c: getattr(self, c) for c in self._COL_NAMES}
        self._alloc_cols(new)
        for c, v in saved.items():
            getattr(self, c)[:old] = v
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        self.capacity = new

    def claim(self, spec, options):
        if not self._free:
            self.grow()
        i = self._free.pop()
        gen = int(self.slot_gen[i])
        self.sig.write_slot(i, spec, self, gen)
        spec._moved = True
        self.sig.device_reset_slot(i)
        self.mask[i] = True
        self.stopped[i] = False
        self.radius[i] = options.radius
        self.motion_pos[i] = options.position
        self.motion_vel[i] = options.velocity
        self.pend_flag[i] = False
        self.prev_position[i] = options.position  # State::new (spatial.rs:494-499)
        self.dt[i] = 0.0
        self.finished_for[i] = np.nan
        return i, gen

    def common_walk(self, prev_rot, rot, elapsed):
        """walk_set's per-voice prologue (spatial.rs:204-261), vectorized:
        motion refresh + smoothing, rotation into listener space, lingering
        reclamation.  Returns (prev_position, next_position) in listener
        space, both (V, 3)."""
        inner_finished = self.sig.host_is_finished()
        upd = self.pend_flag.copy()
        # spatial.rs:216-227: on refresh, prev_position snaps to the
        # discontinuity target or to the smoothed estimate under the OLD motion
        sm_orig = _smoothed_position(
            self.prev_position, self.dt, 0.0, self.motion_pos, self.motion_vel
        )
        new_prev = np.where(self.pend_disc[:, None], self.pend_pos, sm_orig)
        self.prev_position = np.where(upd[:, None], new_prev, self.prev_position).astype(
            np.float32
        )
        self.dt = np.where(upd, np.float32(0.0), self.dt).astype(np.float32)
        self.motion_pos = np.where(upd[:, None], self.pend_pos, self.motion_pos).astype(
            np.float32
        )
        self.motion_vel = np.where(upd[:, None], self.pend_vel, self.motion_vel).astype(
            np.float32
        )
        self.pend_flag[:] = False

        # spatial.rs:228-235: rotate smoothed start/end positions
        sm0 = _smoothed_position(
            self.prev_position, self.dt, 0.0, self.motion_pos, self.motion_vel
        )
        sm1 = _smoothed_position(
            self.prev_position, self.dt, elapsed, self.motion_pos, self.motion_vel
        )
        prev_position = quat_rotate(prev_rot[None, :], sm0)
        next_position = quat_rotate(rot[None, :], sm1)
        self.dt = (self.dt + np.float32(elapsed)).astype(np.float32)

        # spatial.rs:241-261: lingering reclamation with propagation delay
        distance = v3_norm(prev_position)
        lingering = ~np.isnan(self.finished_for)
        expire = lingering & (self.finished_for > distance / SPEED_OF_SOUND)
        self.stopped |= expire & self.mask
        self.finished_for = np.where(
            lingering & ~expire,
            (self.finished_for + np.float32(elapsed)).astype(np.float32),
            self.finished_for,
        )
        newly = self.mask & ~lingering & inner_finished
        self.finished_for = np.where(newly, np.float32(elapsed), self.finished_for)

        drop = self.mask & self.stopped
        if drop.any():
            self.mask &= ~drop
            for i in np.nonzero(drop)[0]:
                self.slot_gen[i] += 1
                self._free.append(int(i))
        return prev_position, next_position

    # handle interface shared with the DR pool
    def push_motion(self, slot, gen, pos, vel, disc):
        if self.slot_gen[slot] == gen:
            self.pend_pos[slot] = f32(pos)
            self.pend_vel[slot] = f32(vel)
            self.pend_disc[slot] = bool(disc)
            self.pend_flag[slot] = True

    def handle_finished(self, slot, gen):
        if self.slot_gen[slot] != gen:
            return True
        return bool(self.stopped[slot])

    def sync(self):
        pass


class _BufferedPool(_VoicePool):
    """Voices played via play_buffered whose chains keep host-fed state
    (Streams, custom signals): per-voice delay rings on device, geometry on
    the host.  Per-voice write cursors differ here (no shared-phase trick),
    so writes scatter and reads gather per (voice, frame); only the cursor
    math lives host-side."""

    def __init__(self, name, spec, capacity, rate, ring_len):
        self.rate = int(rate)
        self.ring_len = int(ring_len)
        assert ring_len % RING_ROW == 0
        self._n_inner = 1
        super().__init__(name, spec, capacity)
        self.ring = None  # jnp (V * ring_len/ROW, ROW), created lazily

    def _alloc_cols(self, V):
        super()._alloc_cols(V)
        self.write = full((V,), 0.0)
        self.max_delay = full((V,), 0.0)

    _COL_NAMES = _VoicePool._COL_NAMES + ["write", "max_delay"]

    def grow(self):
        old = self.capacity
        super().grow()
        if self.ring is not None:
            add = jnp.zeros(((self.capacity - old) * self._rpv, RING_ROW), jnp.float32)
            self.ring = jnp.concatenate([self.ring, add])

    @property
    def _rpv(self):
        return self.ring_len // RING_ROW  # ring rows per voice

    def ring_state(self):
        if self.ring is None:
            self.ring = jnp.zeros(
                (self.capacity * self._rpv, RING_ROW), jnp.float32
            )
        return self.ring

    def play(self, spec, options, max_delay):
        i, gen = self.claim(spec, options)
        cap = int(np.ceil(np.float32(max_delay) * np.float32(self.rate))) + 1
        assert cap <= self.ring_len
        self.max_delay[i] = np.float32(max_delay)
        # SpatialSignalBuffered::new (spatial.rs:39-43): pre-delay the ring by
        # min(|position|/c, max_delay).  The pool modulus is uniform (longer
        # history than the per-voice cap, audio-identical; PARITY.md).
        d = np.minimum(
            v3_norm(f32(options.position)[None, :])[0] / SPEED_OF_SOUND,
            np.float32(max_delay),
        )
        self.write[i] = rust_rem(
            np.float32(self.rate) * np.float32(d), np.float32(self.ring_len)
        )
        self.ring_state()
        self.ring = self.ring.at[i * self._rpv : (i + 1) * self._rpv].set(0.0)
        return i, gen

    def host_prepare(self, prev_rot, rot, interval, n):
        elapsed = (f32(interval) * np.float32(n)).astype(np.float32)
        prev_position, next_position = self.common_walk(prev_rot, rot, elapsed)
        V = self.capacity
        ratef = np.float32(self.rate)
        L = self.ring_len
        capf = np.float32(L)

        # Ring::write bookkeeping (ring.rs:18-41), uniform modulus.  The
        # UNWRAPPED end keeps n_write correct when a block advances by >=
        # the ring modulus (elapsed > max_delay is legal for large n; a
        # wrapped end == start would alias to "no write"); L is a pow2
        # integer and w + adv < 2L, so the mod is exact.
        w = self.write
        w_un = (w + elapsed * ratef).astype(np.float32)
        end = rust_rem(w_un, capf)
        start_idx = np.ceil(w).astype(np.int64)
        n_write = (np.ceil(w_un).astype(np.int64) - start_idx).astype(np.int32)
        self.write = end.astype(np.float32)
        # static per (block size, interval): upper bound on any voice's write
        self._n_inner = int(np.ceil(np.float64(elapsed) * self.rate)) + 1 if n > 0 else 1
        inner_interval = np.full(V, np.float32(1.0) / ratef, np.float32)
        inner_params = self._inner_prepare(inner_interval, self._n_inner, n_write)

        # Per-ear offsets/gains (spatial.rs:409-431)
        prev_off, prev_gain = _ear_states(prev_position, self.radius)
        next_off, next_gain = _ear_states(next_position, self.radius)
        prev_off = np.maximum((prev_off - elapsed).astype(np.float32), -self.max_delay[:, None])
        next_off = np.maximum(next_off, -self.max_delay[:, None])
        nf = np.float32(n) if n > 0 else np.float32(1.0)
        dt_e = ((next_off - prev_off) / nf).astype(np.float32)
        d_gain = ((next_gain - prev_gain) / nf).astype(np.float32)
        # Ring::sample base offset (ring.rs:57): (write' + t*rate) rem_euclid cap
        offset0 = rem_euclid(
            (self.write[:, None] + prev_off * ratef).astype(np.float32), capf
        )
        # split into an exact integer base and a fractional start so device
        # positions are near-exact (see ops/_dev.py)
        obase = np.floor(offset0)
        ds = (dt_e * ratef).astype(np.float32)
        ds_int, f_hi, f_lo = split_ds(ds)
        params = {
            "mask": self.mask.copy(),
            "n_write": n_write,
            "gain0": prev_gain,
            "d_gain": d_gain,
            "inner": inner_params,
            "start": start_idx.astype(np.int32),
            "obase": obase.astype(np.int32),
            "ofrac": (offset0 - obase).astype(np.float32),
            "ds_int": ds_int,
            "f_hi": f_hi,
            "f_lo": f_lo,
        }
        return params

    def _inner_prepare(self, inner_interval, n_inner, n_write):
        return self.sig.host_prepare(inner_interval, n_inner, count=n_write)

    def _inner_render(self, dstate, ddata, params, n_inner):
        return jax.vmap(
            lambda d, p: self.sig.render(d, ddata.get("inner", {}), p, n_inner)
        )(dstate["inner"], params["inner"])

    def render(self, dstate, ddata, params, n):
        # statics set by host_prepare; archetype() includes _n_inner so the
        # driver re-traces when the block config changes
        n_inner = self._n_inner
        # derive the voice count from a per-voice leaf: under shard_map this
        # is the per-shard slice of the pool, not the full capacity
        V = params["mask"].shape[0]
        dsub, blocks = self._inner_render(dstate, ddata, params, n_inner)
        samples = blocks[:, 0, :]  # (V, n_inner) mono
        L = self.ring_len
        rpv = self._rpv
        # Ring::write (ring.rs:18-41): scatter the consumed frames at each
        # voice's write cursor
        ring = dstate["ring"].reshape(V, L)
        j = jnp.arange(n_inner)
        idx = jnp.mod(params["start"][:, None] + j[None, :], L)
        idx = jnp.where(j[None, :] < params["n_write"][:, None], idx, L)
        ring = ring.at[jnp.arange(V)[:, None], idx].set(samples, mode="drop")
        # Ring::sample (ring.rs:51-79) per ear with gain ramps
        # (spatial.rs:409-431)
        jn = jnp.arange(n, dtype=jnp.float32)
        whole, fr = exact_positions(
            params["ofrac"], params["ds_int"], params["f_hi"], params["f_lo"], n
        )
        x = jnp.mod(params["obase"][:, :, None] + whole, L)
        x1 = jnp.mod(x + 1, L)
        flat = lambda ix: jnp.take_along_axis(
            ring, ix.reshape(V, 2 * n), axis=1
        ).reshape(V, 2, n)
        a = flat(x)
        b = flat(x1)
        s = a + fr * (b - a)
        gains = (
            params["gain0"][:, :, None]
            + jn[None, None, :] * params["d_gain"][:, :, None]
        )
        contrib = jnp.where(params["mask"][:, None, None], s * gains, 0.0)
        return (
            {"ring": ring.reshape(V * rpv, RING_ROW), "inner": dsub},
            jnp.sum(contrib, axis=0),
        )


class _BufferedPoolSingleton(_BufferedPool):
    """A one-voice buffered pool for NON-BATCHABLE signals — submixes
    (`Mixer`, nested scenes) played into a SpatialScene, which the
    reference allows for any Signal (spatial.rs:314-340).  The voice's
    signal renders unbatched; everything else (geometry walk, ring
    cursors, reads at V=1) reuses the host buffered pool."""

    is_singleton = True

    def __init__(self, name, spec, rate, ring_len):
        # _VoicePool.__init__ without clone_batched: the signal itself IS
        # the single voice
        self.name = name
        self.proto = spec
        self.sig = spec
        self.capacity = 1
        self._alloc_cols(1)
        self._free = [0]
        self.rate = int(rate)
        self.ring_len = int(ring_len)
        assert ring_len % RING_ROW == 0
        self._n_inner = 1
        self.ring = None
        self.write = full((1,), 0.0)
        self.max_delay = full((1,), 0.0)

    def grow(self):
        raise RuntimeError("singleton pools hold exactly one voice")

    def claim(self, spec, options):
        i = 0
        gen = int(self.slot_gen[i])
        spec._moved = True
        self.mask[i] = True
        self.stopped[i] = False
        self.radius[i] = options.radius
        self.motion_pos[i] = options.position
        self.motion_vel[i] = options.velocity
        self.pend_flag[i] = False
        self.prev_position[i] = options.position
        self.dt[i] = 0.0
        self.finished_for[i] = np.nan
        return i, gen

    def _inner_prepare(self, inner_interval, n_inner, n_write):
        # batch-() signals take scalar interval/count
        return self.sig.host_prepare(
            np.float32(inner_interval[0]), n_inner, count=int(n_write[0])
        )

    def _inner_render(self, dstate, ddata, params, n_inner):
        dsub, block = self.sig.render(
            dstate["inner"], ddata.get("inner", {}), params["inner"], n_inner
        )
        return dsub, block[None]  # (1, C, n_inner)


class _SeekPool(_VoicePool):
    """Voices played via play(): deterministic sources re-sampled per ear with
    warped time (doppler by time-warp, spatial.rs:438-470)."""

    def host_prepare(self, prev_rot, rot, interval, n):
        elapsed = (f32(interval) * np.float32(n)).astype(np.float32)
        prev_position, next_position = self.common_walk(prev_rot, rot, elapsed)
        prev_off, prev_gain = _ear_states(prev_position, self.radius)
        next_off, next_gain = _ear_states(next_position, self.radius)
        nf = np.float32(n) if n > 0 else np.float32(1.0)
        # spatial.rs:449-453
        effective = ((np.float32(elapsed) + next_off) - prev_off).astype(np.float32)
        dt_e = (effective / nf).astype(np.float32)
        d_gain = ((next_gain - prev_gain) / nf).astype(np.float32)
        ear_params = []
        for e in (0, 1):
            self.sig.host_seek(prev_off[:, e])  # initial real time -> delayed
            ear_params.append(self.sig.host_prepare(dt_e[:, e], n))
            # final delayed -> initial real time (spatial.rs:465)
            self.sig.host_seek((-effective[:, e] - prev_off[:, e]).astype(np.float32))
        self.sig.host_seek(np.full(self.capacity, elapsed, np.float32))
        return {
            "mask": self.mask.copy(),
            "earL": ear_params[0],
            "earR": ear_params[1],
            "gain0": prev_gain,
            "d_gain": d_gain,
        }

    def render(self, dstate, ddata, params, n):
        dd = ddata.get("inner", {})
        d2, bL = jax.vmap(lambda d, p: self.sig.render(d, dd, p, n))(
            dstate["inner"], params["earL"]
        )
        d3, bR = jax.vmap(lambda d, p: self.sig.render(d, dd, p, n))(
            d2, params["earR"]
        )
        s = jnp.stack([bL[:, 0, :], bR[:, 0, :]], axis=1)  # (V, 2, n)
        jn = jnp.arange(n, dtype=jnp.float32)
        gains = (
            params["gain0"][:, :, None]
            + jn[None, None, :] * params["d_gain"][:, :, None]
        )
        contrib = jnp.where(params["mask"][:, None, None], s * gains, 0.0)
        return {"inner": d3}, jnp.sum(contrib, axis=0)


from .core.drctrl import DRCtrlMixin


class _DRPoolBase(DRCtrlMixin):
    """Shared device-resident control plane for spatial voice pools.

    All per-voice control state — motion, smoothing, lingering, masks, and
    the inner sources' playback state — lives on the device; every block the
    geometry (spatial.rs:204-261, 530-550) runs inside the jitted graph.
    The host ships only *sparse control deltas* (plays, set_motion) — the
    device-resident equivalent of oddio's bounded spsc/swap channels, with the
    same bounded-capacity backpressure (overflow carries to the next block).
    Handle state (is_finished) is observed at sync points (every
    render_frames, periodic render_block sync, or SpatialScene.sync()).
    """

    is_dr = True

    #: set by ScenePack: called before any direct mutation of ``self.state``
    #: outside the jitted step (grow, eager plays).  While packed, the
    #: authoritative state is the pack's stacked ``_dstate``; mutating the
    #: per-scene ``pool.state`` without first pulling the carry back would
    #: silently discard device-side progress (see parallel/sharded.py).
    _unpack_hook = None

    #: per-voice geometry/lifecycle columns common to every DR pool kind
    GEOM_KEYS = (
        "mask", "stopped", "finished_for", "radius", "motion_pos",
        "motion_vel", "prev_position", "smdt",
    )
    #: state keys carried in play rows (subclasses extend)
    ROW_KEYS = GEOM_KEYS

    def _init_base(self, name, spec, capacity, k_motion, k_play):
        self.name = name
        # ingest-needing protos (Stream) keep BATCHED host mirror columns
        # (the pool's shadow of the device cursors + per-slot producer
        # queues; see Stream.dr_bind_slot)
        self.proto = (
            spec.clone_batched(capacity) if spec.dr_needs_ingest() else spec
        )
        self.capacity = capacity
        self.k_motion = k_motion
        self.k_play = k_play
        self._elapsed = 0.0
        self.slot_gen = np.zeros(capacity, dtype=np.int64)
        self._free = list(range(capacity - 1, -1, -1))
        self.mask_host = np.zeros(capacity, dtype=bool)
        self.stopped_host = np.zeros(capacity, dtype=bool)
        self.pending_plays = []  # (slot, row pytree)
        self.pending_motion = {}  # slot -> (pos, vel, disc); last-wins
        #: always ship delta arrays (ScenePack needs uniform structures)
        self.force_deltas = False
        self.state = None
        # exact host mirrors of the device walk's geometry inputs (same f32
        # math, updated at play and at motion-delta SHIP time): the per-block
        # read-walk bound derives from these, so the buffered read tier can
        # tighten to the scene's actual motion without any device sync
        self._g_prev = np.zeros((capacity, 3), np.float32)
        self._g_mpos = np.zeros((capacity, 3), np.float32)
        self._g_mvel = np.zeros((capacity, 3), np.float32)
        self._g_smdt = np.zeros(capacity, np.float32)
        #: pack-wide walk-bound floor (ScenePack renders every scene with ONE
        #: program, so aligned pools must agree on the read tier)
        self._dmax_floor = 0.0
        #: cached walk-bound verdict + validity horizons (see _block_b);
        #: None = mirrors changed, recompute
        self._b_cache = None
        self._t_scene = 0.0
        self._init_ctrl(spec)

    # -- state ---------------------------------------------------------------

    def _geom_zero(self, V):
        return {
            "mask": jnp.zeros(V, bool),
            "stopped": jnp.zeros(V, bool),
            "finished_for": jnp.full(V, jnp.nan, dtype=jnp.float32),
            "radius": jnp.full(V, 0.1, dtype=jnp.float32),
            "motion_pos": jnp.zeros((V, 3), jnp.float32),
            "motion_vel": jnp.zeros((V, 3), jnp.float32),
            "prev_position": jnp.zeros((V, 3), jnp.float32),
            "smdt": jnp.zeros(V, jnp.float32),
        }

    def _extra_zero(self, V):
        """Subclass state leaves beyond geometry + inner (e.g. ring columns)."""
        return {}

    def _fresh_state(self, V):
        st = self._geom_zero(V)
        st.update(self._extra_zero(V))
        st["inner"] = jax.tree.map(jnp.asarray, self.proto.dr_state_init(V))
        return st

    def dr_state(self):
        if self.state is None:
            self.state = self._fresh_state(self.capacity)
        return self.state

    def _concat_state(self, st, fresh, old, new):
        """Concatenate fresh slots onto every leaf (subclasses override for
        layout-sensitive leaves like paged rings)."""
        return jax.tree.map(lambda a, b: jnp.concatenate([a, b]), st, fresh)

    def grow(self):
        """set-realloc analogue (set.rs:57-63): double capacity in place."""
        if self._unpack_hook is not None:
            self._unpack_hook()
        old = self.capacity
        new = old * 2
        self._ctrl_grow(old, new)
        self.dr_state()
        fresh = self._fresh_state(old)
        self.state = self._concat_state(self.state, fresh, old, new)
        self.slot_gen = np.concatenate([self.slot_gen, np.zeros(old, np.int64)])
        self.mask_host = np.concatenate([self.mask_host, np.zeros(old, bool)])
        self.stopped_host = np.concatenate([self.stopped_host, np.zeros(old, bool)])
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        self._g_prev = np.concatenate([self._g_prev, np.zeros((old, 3), np.float32)])
        self._g_mpos = np.concatenate([self._g_mpos, np.zeros((old, 3), np.float32)])
        self._g_mvel = np.concatenate([self._g_mvel, np.zeros((old, 3), np.float32)])
        self._g_smdt = np.concatenate([self._g_smdt, np.zeros(old, np.float32)])
        self._b_cache = None
        if self.proto.batch:
            self.proto.grow_batched(new)
        self.capacity = new

    # -- control side ----------------------------------------------------------

    def _claim_slot(self, spec):
        if not self._free:
            self.grow()
        i = self._free.pop()
        gen = int(self.slot_gen[i])
        stack = [spec]
        while stack:  # Rust move semantics, recursively
            s = stack.pop()
            if s._moved:
                raise RuntimeError(
                    "signal was already played (moved); construct a new one"
                )
            s._moved = True
            stack.extend(s.children().values())
        self._rebind_ctrl(spec, i, gen)
        self._fade_claim_reset(i)
        self._fade_mirror_on_play(i, spec)
        self._track_spec(i, spec)
        if self.proto.batch:
            self.proto.dr_bind_slot(i, spec, self, gen)
        return i, gen

    def _geom_row(self, options):
        return {
            "mask": True,
            "stopped": False,
            "finished_for": np.float32(np.nan),
            "radius": np.float32(options.radius),
            "motion_pos": f32(options.position),
            "motion_vel": f32(options.velocity),
            "prev_position": f32(options.position),
            "smdt": np.float32(0.0),
        }

    def _default_row(self):
        """Benign padding row for unfilled play-delta lanes."""
        row = {
            "mask": False,
            "stopped": True,
            "finished_for": np.float32(np.nan),
            "radius": np.float32(0.1),
            "motion_pos": np.zeros(3, np.float32),
            "motion_vel": np.zeros(3, np.float32),
            "prev_position": np.zeros(3, np.float32),
            "smdt": np.float32(0),
            "inner": self.proto.dr_default_row(
                getattr(self, "interval_inner", 0.0)
            ),
        }
        return row

    def _queue_play(self, i, row):
        self.pending_plays.append((i, row))
        self.mask_host[i] = True
        self.stopped_host[i] = False
        self._g_prev[i] = row["prev_position"]
        self._g_mpos[i] = row["motion_pos"]
        self._g_mvel[i] = row["motion_vel"]
        self._g_smdt[i] = row["smdt"]
        self._b_cache = None

    def push_motion(self, slot, gen, pos, vel, disc):
        if self.slot_gen[slot] == gen:
            self.pending_motion[slot] = (f32(pos), f32(vel), bool(disc))

    def handle_finished(self, slot, gen):
        self._maybe_sync()
        if self.slot_gen[slot] != gen:
            return True
        return bool(self.stopped_host[slot])

    def _maybe_sync(self):
        """Refresh handle-visible state at most once per rendered block so
        queries observe reclamation with the reference's timing
        (spatial.rs:241-261) without per-query device readbacks."""
        if getattr(self, "_sync_seen", -1) != getattr(self, "_prep_count", 0):
            self.sync()
            self._sync_seen = getattr(self, "_prep_count", 0)

    def _clear_rows(self, S, idx):
        """Reset layout-sensitive per-slot state (e.g. delay rings) for the
        slots in ``idx`` (entries == capacity are padding and must drop)."""
        pass

    def _apply_plays_eager(self):
        """Apply all pending plays directly to device state (one-off scatters
        outside the jitted step; the bulk-setup path)."""
        if self._unpack_hook is not None:
            self._unpack_hook()
        self.dr_state()
        idx = jnp.asarray([i for i, _ in self.pending_plays], jnp.int32)
        rows = jax.tree.map(
            lambda *xs: np.stack(xs), *[r for _, r in self.pending_plays]
        )
        self.pending_plays = []
        S = dict(self.state)
        for k in self.ROW_KEYS:
            S[k] = S[k].at[idx].set(jnp.asarray(rows[k]))
        from .core.drctrl import rows_scatter

        S["inner"] = rows_scatter(S["inner"], rows["inner"], idx)
        self._clear_rows(S, idx)
        self.state = S

    def sync_prefetch(self):
        """Start the device->host copy of handle-visible state so a
        following sync() doesn't stall the render pipeline (packed: one
        ~V/4-byte transfer instead of two V-byte columns)."""
        self._sync_start()

    def sync(self):
        """Pull mask/stopped back from the device; reclaim freed slots."""
        if self.state is None:
            return
        mask, stopped = self._sync_read()
        pending = {i for i, _ in self.pending_plays}
        for i in range(self.capacity):
            if i in pending:
                continue
            if self.mask_host[i] and stopped[i] and not mask[i]:
                self.mask_host[i] = False
                self.stopped_host[i] = True
                self.slot_gen[i] += 1
                self._free.append(i)
                self._b_cache = None  # the live set shrank; re-bound

    # -- per block ---------------------------------------------------------------

    def _delta_params(self, params, force=False):
        """Pack queued control events into bounded per-block delta arrays.

        Bulk plays (engine setup) apply eagerly outside the jitted step so
        per-block delta shapes stay constant; the per-block channel handles
        the steady trickle.  Blocks without control events ship no delta
        arrays at all (the zero-delta fast path) unless ``force_deltas``.
        """
        self._prep_count = getattr(self, "_prep_count", 0) + 1
        if len(self.pending_plays) > self.k_play:
            self._apply_plays_eager()
        # a single "control events present" step variant (plays AND motion
        # arrays ship together, padded): live scenes then alternate between
        # exactly two jitted programs — the idle one and the delta one — so
        # a play or set_motion after warmup never triggers a fresh compile
        # (the reference's "no glitches" contract, README.md:11)
        has = (
            bool(self.pending_plays) or bool(self.pending_motion)
            or self._ctrl_pending_any() or self.force_deltas or force
        )
        self._has_play = self._has_mot = has
        if has:
            self._ctrl_delta_params(params)
        if self._has_play:
            Kp = self.k_play
            take = self.pending_plays[:Kp]
            self.pending_plays = self.pending_plays[Kp:]
            play_idx = np.full(Kp, self.capacity, np.int32)
            rows = [r for _, r in take]
            if len(rows) < Kp:
                rows = rows + [self._default_row()] * (Kp - len(rows))
            for j, (i, _) in enumerate(take):
                play_idx[j] = i
            params["play_idx"] = play_idx
            params["play"] = jax.tree.map(lambda *xs: np.stack(xs), *rows)

        # motion deltas (last-wins per slot; overflow carries to the next
        # block — bounded-channel semantics like a full swap/spsc pair)
        if self._has_mot:
            Km = self.k_motion
            items = list(self.pending_motion.items())[:Km]
            for k, _ in items:
                del self.pending_motion[k]
            mot_idx = np.full(Km, self.capacity, np.int32)
            mot_pos = np.zeros((Km, 3), np.float32)
            mot_vel = np.zeros((Km, 3), np.float32)
            mot_disc = np.zeros(Km, bool)
            for j, (slot, (p, v, d)) in enumerate(items):
                mot_idx[j] = slot
                mot_pos[j] = p
                mot_vel[j] = v
                mot_disc[j] = d
                # mirror the device's motion-refresh math (walk step 2):
                # shipped deltas apply on THIS block
                sm = _smooth_host(
                    self._g_prev[slot : slot + 1],
                    self._g_smdt[slot : slot + 1],
                    0.0,
                    self._g_mpos[slot : slot + 1],
                    self._g_mvel[slot : slot + 1],
                )[0]
                self._g_prev[slot] = p if d else sm
                self._g_smdt[slot] = 0.0
                self._g_mpos[slot] = p
                self._g_mvel[slot] = v
                self._b_cache = None
            params["mot_idx"] = mot_idx
            params["mot_pos"] = mot_pos
            params["mot_vel"] = mot_vel
            params["mot_disc"] = mot_disc
        return params

    def _walk_device(self, S, params, elapsed):
        """In-graph control walk: apply play/motion deltas, smooth + rotate
        positions, handle lingering reclamation (spatial.rs:204-261).
        Returns (S, mask, prev_pos, next_pos) with the positions as
        component tuples ((V,), (V,), (V,)) — lane-major geometry (the
        packed (V, 3) forms run at ~2% lane occupancy; ops/geometry.py
        component-split notes)."""
        from .ops.geometry import (
            smoothed_position, smoothed_position_c, quat_rotate_c,
            unstack3, v3_norm_c,
        )
        from .parallel.context import localize_index

        V = S["mask"].shape[0]

        # 1. plays (set.rs insert semantics: applied before the walk)
        if "play_idx" in params:
            from .core.drctrl import rows_scatter

            pidx = localize_index(params["play_idx"], V)
            rows = params["play"]
            for k in self.ROW_KEYS:
                S[k] = S[k].at[pidx].set(rows[k], mode="drop")
            S["inner"] = rows_scatter(S["inner"], rows["inner"], pidx)
            self._clear_rows(S, pidx)

        # 1b. control-field deltas (set_gain/set_speed/..., gain.rs:103-108)
        S["inner"] = self._ctrl_apply(S["inner"], params)
        # 1c. fade starts (fader.rs:86-93 swap-channel delivery)
        S["inner"] = self._fade_apply(S["inner"], params)

        # 2. motion refresh (swap-channel drain + smoothing, spatial.rs:216-227)
        if "mot_idx" in params:
            midx = localize_index(params["mot_idx"], V)
            upd = jnp.zeros(V, bool).at[midx].set(True, mode="drop")
            pend_pos = S["motion_pos"].at[midx].set(params["mot_pos"], mode="drop")
            pend_vel = S["motion_vel"].at[midx].set(params["mot_vel"], mode="drop")
            pend_disc = jnp.zeros(V, bool).at[midx].set(params["mot_disc"], mode="drop")
            sm_orig = smoothed_position(
                S["prev_position"], S["smdt"], 0.0, S["motion_pos"], S["motion_vel"]
            )
            new_prev = jnp.where(pend_disc[:, None], pend_pos, sm_orig)
            S["prev_position"] = jnp.where(upd[:, None], new_prev, S["prev_position"])
            S["smdt"] = jnp.where(upd, 0.0, S["smdt"])
            S["motion_pos"] = jnp.where(upd[:, None], pend_pos, S["motion_pos"])
            S["motion_vel"] = jnp.where(upd[:, None], pend_vel, S["motion_vel"])

        # 3. geometry (spatial.rs:228-238), component-split
        prev3 = unstack3(S["prev_position"])
        mp3 = unstack3(S["motion_pos"])
        mv3 = unstack3(S["motion_vel"])
        sm0 = smoothed_position_c(prev3, S["smdt"], 0.0, mp3, mv3)
        sm1 = smoothed_position_c(prev3, S["smdt"], elapsed, mp3, mv3)
        prev_pos = quat_rotate_c(params["rot_prev"], sm0)
        next_pos = quat_rotate_c(params["rot"], sm1)
        S["smdt"] = S["smdt"] + elapsed

        # 4. lingering reclamation (spatial.rs:241-261)
        dist = v3_norm_c(prev_pos)
        inner_fin = self.proto.dr_is_finished(S["inner"])
        ff = S["finished_for"]
        lingering = ~jnp.isnan(ff)
        expire = lingering & (ff > dist / SPEED_OF_SOUND)
        S["stopped"] = S["stopped"] | (expire & S["mask"])
        ff = jnp.where(lingering & ~expire, ff + elapsed, ff)
        newly = S["mask"] & ~lingering & inner_fin
        S["finished_for"] = jnp.where(newly, elapsed, ff)
        S["mask"] = S["mask"] & ~S["stopped"]
        return S, S["mask"], prev_pos, next_pos

    def render_multi(self, dstate, ddata, params, n, nb):
        """Default fused idle group: loop the per-block render (subclasses
        override to share work across the group's blocks).  Returns
        ``(S, (C, nb*n))``."""
        S = dstate
        outs = []
        for _ in range(nb):
            S, block = self.render(S, ddata, params, n)
            outs.append(block)
        return S, jnp.concatenate(outs, axis=-1)


class _SeekPoolDR(_DRPoolBase):
    """Device-resident seek-path pool: the flagship scale path for
    deterministic sources.

    The reference's ``play()`` voices re-sample their Seek-able source per
    ear at time-shifted, rate-warped positions (doppler by time-warp,
    spatial.rs:438-470) — no delay ring exists on this path at all.  With a
    positionally-evaluable source chain (``dr_warp_render``), a whole block
    is pure elementwise math over (voice, ear, frame): geometry, two warped
    source evaluations, gain ramps, and one masked reduction — no gathers,
    no scatters; XLA fuses it into a few HBM-light kernels.
    """

    ROW_KEYS = _DRPoolBase.GEOM_KEYS

    def __init__(self, name, spec, capacity, k_motion=64, k_play=8):
        self._init_base(name, spec, capacity, k_motion, k_play)

    def play(self, spec, options):
        i, gen = self._claim_slot(spec)
        row = self._geom_row(options)
        # seek-path sources are sampled at per-block warped intervals; the
        # slot row therefore encodes only position state (interval-free)
        row["inner"] = spec.dr_slot_row(0.0)
        self._queue_play(i, row)
        return i, gen

    def host_prepare(self, prev_rot, rot, interval, n, force=False):
        # rotation values arrive in-graph from the scene's "_rot" state leaf
        self._elapsed = float(np.float32(f32(interval) * np.float32(n)))
        # warp steps are the scene interval times the doppler factor; 1.25
        # covers the clamped |v|/c range with margin
        self._ema_flag_sync(float(f32(interval)) * 1.25)
        params = self._delta_params({}, force)
        # keep the geometry mirrors' smoothing clock current (the seek pool
        # never reads them, but delta-ship math does)
        self._g_smdt = (self._g_smdt + np.float32(self._elapsed)).astype(np.float32)
        return params

    def render(self, dstate, ddata, params, n):
        from .ops.geometry import ear_states_c

        S = dict(dstate)
        elapsed = np.float32(self._elapsed)
        S, mask, prev_pos, next_pos = self._walk_device(S, params, elapsed)

        # per-ear offsets/gains and warp rates (spatial.rs:445-453),
        # component-split then stacked once for the bulk warp render
        p_off_c, p_gain_c = ear_states_c(prev_pos, S["radius"])
        n_off_c, n_gain_c = ear_states_c(next_pos, S["radius"])
        nf = np.float32(n) if n > 0 else np.float32(1.0)
        p_off = jnp.stack(p_off_c, axis=-1)
        p_gain = jnp.stack(p_gain_c, axis=-1)
        dt_e = jnp.stack(
            [((elapsed + n_off_c[e]) - p_off_c[e]) / nf for e in range(2)],
            axis=-1,
        )
        d_gain = jnp.stack(
            [(n_gain_c[e] - p_gain_c[e]) / nf for e in range(2)], axis=-1
        )

        # sample both ears at cursor + p_off + j*dt (spatial.rs:455-463),
        # then advance the real cursor by the block (spatial.rs:465-468)
        samples = self.proto.dr_warp_render(
            S["inner"], ddata.get("inner", {}), p_off, dt_e, n
        )
        S["inner"] = self.proto.dr_advance(S["inner"], self._elapsed)

        jn = jnp.arange(n, dtype=jnp.float32)
        gains = p_gain[:, :, None] + jn[None, None, :] * d_gain[:, :, None]
        contrib = jnp.where(mask[:, None, None], samples * gains, 0.0)
        return S, jnp.sum(contrib, axis=0)


class _BufferedPoolDR(_DRPoolBase):
    """Device-resident buffered pool: the flagship scale path.

    All per-voice control-plane state — motion, smoothing, lingering, masks,
    ring cursors, and the inner sources' playback cursors — lives on the
    device; every block the geometry (spatial.rs:204-261, 530-550), the
    delay-ring write (ring.rs:18-41), the inner source render, and the
    fractional ear reads (ring.rs:51-79, spatial.rs:409-431) run inside one
    jitted graph.  The host ships only *sparse control deltas* (plays,
    set_motion) — the device-resident equivalent of oddio's bounded
    spsc/swap channels, with the same bounded-capacity backpressure
    (overflow carries to the next block).

    Ring storage is ``(V, RPV, 128)`` per voice, covering the flat span
    ``F + L + M + SLACK`` (front pad, ring, mirror — cols ``[F+L, F+L+M)``
    replicate ``[F, F+M)`` — and dump slack); the flat ``(V, rowlen)``
    view is a free reshape.  Because the pool shares one write cursor, the
    per-block append is two slab writes (primary + mirror-maintenance
    legs) into the donated ring, costing exactly the bytes written; reads
    gather per (voice, ear, frame) (``_ring_reader``: the Triton kernel on
    GPUs, the plain XLA read elsewhere).

    Requires the inner chain to be device-resident capable (static after
    play: Sine/Constant/FramesSignal/Cycle/FixedGain). Handle state
    (is_finished) is observed at sync points (every render_frames, or
    SpatialScene.sync()).
    """

    ROW_KEYS = _DRPoolBase.GEOM_KEYS + ("max_delay", "phase", "tight")

    #: columns per write chunk (and the front-pad width; any n_inner
    #: writes as ceil(n_inner/W_CHUNK) slab pairs)
    W_CHUNK = 1024
    #: mirror width: bounds the read-tier windows (_select_window of a
    #: full 512-frame chunk at the 128-row stagger = 896)
    M_PAD = 1024
    #: family sub-pass slot count: wide-walk voices (offset-clamped /
    #: fast movers, spatial.rs:414-415) are host-listed into a fixed-size
    #: side list and rendered by a small wide-tier read pass while the
    #: main pool keeps its tight tier — one distant voice no longer
    #: demotes the whole pool
    SUBCAP = 256
    #: read-tier ladder for the sub-pass ((256, 256) carries the full
    #: frozen-read family exactly; (128, 192) extends to ~1.5x supersonic)
    SUB_TIERS = ((256, 256), (128, 192))

    def __init__(self, name, spec, capacity, rate, cap_pool, k_motion=64, k_play=8):
        self._init_base(name, spec, capacity, k_motion, k_play)
        self.rate = int(rate)
        #: the POOL's shared write cursor (f32, host-authoritative): every
        #: voice writes at the same phase, so ring appends are slab writes
        self._w_host = np.float32(0.0)
        #: uniform ring modulus for the pool (>= every voice's required
        #: capacity; a longer history is audio-identical, the per-voice
        #: max_delay column still clamps reads like spatial.rs:414-415).
        self.cap_pool = int(cap_pool)
        assert self.cap_pool % PAGE == 0 and self.cap_pool >= 2 * PAGE
        self.ring_len = self.cap_pool
        self.interval_inner = float(np.float32(1.0) / np.float32(rate))
        #: inter-ear read stagger bound in samples (|d_L - d_R| <= 0.215 m,
        #: spatial.rs:571-598); the select kernel reaches it without realign
        self.emax2 = int(np.ceil(0.215 / float(SPEED_OF_SOUND) * rate)) + 2
        self._n_inner = 1
        self._read_cfg = None  # set per block by host_prepare
        #: per-voice max_delay host column: a voice whose propagation offset
        #: can hit the -max_delay clamp (spatial.rs:414-415) reads FROZEN
        #: (ds = 0), which only the small-chunk tier represents exactly
        self._md_host = np.zeros(capacity, np.float32)
        #: family sub-pass: the SHIPPED wide-voice list (host-authoritative
        #: twin of the device's sub_idx/sub_on/tight state), its read tier
        #: for this block, and the ship-pending flag (membership changes
        #: ride the delta program; see force_needed)
        self._sub_list = np.zeros(0, np.int64)
        self._sub_cfg = None
        self._sub_dirty = False
        #: tier-transition log for observability (SpatialSceneControl
        #: .read_tiers()/.tier_events()): (t_scene, read_cfg, sub_cfg,
        #: listed) appended whenever the active tier plan changes — the
        #: run3-style silent 2x demotion collapse must be user-diagnosable
        self._tier_log = []
        self._tier_last = None

    # -- state ---------------------------------------------------------------

    @property
    def rowlen(self):
        return self.W_CHUNK + self.ring_len + self.M_PAD + self.W_CHUNK

    def _ring_shape(self, V):
        return (V, self.rowlen // 128, 128)

    def _extra_zero(self, V):
        return {
            "ring": jnp.zeros(self._ring_shape(V), jnp.float32),
            "max_delay": jnp.zeros(V, jnp.float32),
            "phase": jnp.zeros(V, jnp.float32),
            # device twin of the pool write cursor (_w_host): idle blocks
            # derive the ring cursor in-graph and ship NO params at all
            # (delta blocks resync it); (1,)-shaped, replicated
            "wcur": jnp.zeros(1, jnp.float32),
            # family sub-pass state (fixed SUBCAP shape regardless of V so
            # the state tree is stable across growth and ScenePack stacking)
            "tight": jnp.ones(V, jnp.float32),
            "sub_idx": jnp.zeros(self.SUBCAP, jnp.int32),
            "sub_on": jnp.zeros(self.SUBCAP, jnp.float32),
        }

    def _concat_state(self, st, fresh, old, new):
        """Per-voice leaves concatenate; the fixed-shape sub-pass list
        leaves carry over unchanged (growth invalidates the walk cache, so
        the next ship refreshes membership against the new capacity)."""
        st = dict(st)
        fresh = dict(fresh)
        keep = {k: st.pop(k) for k in ("sub_idx", "sub_on", "wcur")}
        for k in keep:
            fresh.pop(k)
        out = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), st, fresh)
        out.update(keep)
        return out

    # -- control side ----------------------------------------------------------

    def grow(self):
        old = self.capacity
        super().grow()
        self._md_host = np.concatenate(
            [self._md_host, np.zeros(old, np.float32)]
        )

    def play(self, spec, options, max_delay):
        i, gen = self._claim_slot(spec)
        cap = int(np.ceil(np.float32(max_delay) * np.float32(self.rate))) + 1
        assert cap <= self.cap_pool
        # The voice starts at the POOL's shared write cursor: its freshly
        # zeroed band plays the role of SpatialSignalBuffered::new's
        # pre-delay zeros (spatial.rs:39-43) — early reads wrap into the
        # voice's own zeros exactly like the reference's fresh ring, and a
        # shared cursor makes every voice's write rows identical, so the
        # per-block ring append is a slab write with no row gather.  The
        # pre-delay's FRACTIONAL sample phase (and the pool cursor's phase
        # at play) become a per-voice read-offset constant.
        d = np.minimum(
            v3_norm(f32(options.position)[None, :])[0] / SPEED_OF_SOUND,
            np.float32(max_delay),
        )
        w0 = np.float32(np.float32(self.rate) * np.float32(d))
        W = np.float32(self._w_host)
        row = self._geom_row(options)
        row["phase"] = np.float32(
            (w0 - np.ceil(w0)) - (W - np.ceil(W))
        )
        row["max_delay"] = np.float32(max_delay)
        row["tight"] = np.float32(1.0)  # reused slots rejoin the main pass
        row["inner"] = spec.dr_slot_row(self.interval_inner)
        self._md_host[i] = np.float32(max_delay)
        self._queue_play(i, row)
        return i, gen

    def _default_row(self):
        row = super()._default_row()
        row["max_delay"] = np.float32(0)
        row["phase"] = np.float32(0)
        row["tight"] = np.float32(1.0)
        return row

    def _clear_rows(self, S, idx):
        """Zero the delay rings of newly played slots (padding lanes drop)."""
        S["ring"] = S["ring"].at[idx].set(0.0, mode="drop")

    # -- per block ---------------------------------------------------------------

    def _walk_bound(self, elapsed, rot_sin_half):
        """Conservative bounds on this block's |apparent radial velocity|/c
        over audible voices (the read-walk tier feed), from the exact host
        geometry mirrors — no device sync.  Returns (steady, full):

        * ``steady`` — persistent contributions: set velocities, plus >= 1.0
          when any voice's propagation offset may hit the -max_delay clamp
          (frozen read, ds = 0, spatial.rs:414-415).  Tier escalation from
          these is exact (they describe the scene's standing state).
        * ``full`` — adds TRANSIENT contributions: the position-smoothing
          transition term after a motion refresh, and the listener-rotation
          ear swing (``rot_sin_half`` = sin(theta/2) of a rotation step
          interpolating across this block; 0 when unchanged).  The caller
          caps their tier effect at the K=64 delta class so spikes never
          compile fresh programs (beyond it the walk clips — the documented
          supersonic behavior, PARITY.md)."""
        C = np.float32(SPEED_OF_SOUND)
        T = np.float32(POSITION_SMOOTHING_PERIOD)
        live = self.mask_host
        if not live.any():
            self._b_cache = {
                "elapsed": elapsed, "steady": 0.0, "full": 0.0,
                "clamp": False, "valid_until": np.inf, "trans_until": 0.0,
                "d_hi_max": 0.0, "spd_max": 0.0, "t": self._t_scene,
            }
            return 0.0, 0.0
        livef = live.astype(np.float32)
        mvel = self._g_mvel
        prev = self._g_prev
        mpos = self._g_mpos
        smdt = self._g_smdt
        vn = np.sqrt(np.einsum("ij,ij->i", mvel, mvel))
        # while smoothing (smdt < T) the apparent velocity carries the
        # pos-refresh transition term (d/dt of r*(intended - naive)),
        # CONSTANT until each voice's smdt crosses T
        d = mpos - prev
        tn = np.sqrt(np.einsum("ij,ij->i", d, d))
        smoothing = smdt < T
        trans = np.where(smoothing & live, tn / T, np.float32(0.0))
        vn = vn * livef
        spd = vn + trans
        # offset-clamp check on the block-endpoint positions (within-block
        # ear offsets interpolate between them); the verdict stays valid
        # until some voice could CROSS a boundary (|gap| / speed)
        e32 = np.float32(elapsed)
        margin = np.float32(2.0 / self.rate + 1e-4)
        d_hi = np.float32(0.0)
        d_lo = np.float32(np.inf)
        for dt_extra in (np.float32(0.0), e32):
            dt = smdt + dt_extra
            r = np.minimum(dt / T, np.float32(1.0))
            p = prev + mvel * dt[:, None] + r[:, None] * d
            nn = np.sqrt(np.einsum("ij,ij->i", p, p))
            d_hi = np.maximum(d_hi, nn)
            d_lo = np.minimum(d_lo, nn)
        d_hi = d_hi + np.float32(HEAD_RADIUS)
        d_lo = np.maximum(d_lo - np.float32(HEAD_RADIUS), np.float32(0.0))
        # three regimes (spatial.rs:414-416 clamping at -max_delay):
        #  * inside (d_hi < bnd): no ear offset can clamp — tight walk
        #  * CERTAINLY FROZEN (d_lo >= bnd_hi): both ears clamp at both
        #    endpoints, the device computes ds = 0 exactly and the select
        #    kernel's frozen branch reads it on the tight tier — these
        #    voices are EXEMPT from tier bounds and sub-pass listing
        #  * the band between: ds anywhere in (0, 1] — escalates the bound
        bnd = (self._md_host - e32 - margin) * C  # may-clamp boundary, m
        bnd_hi = (self._md_host + margin) * C  # certainly-frozen boundary
        frozen = (d_lo >= bnd_hi) & live
        band = (d_hi >= bnd) & live & ~frozen
        clamp = bool(band.any())
        gap = np.where(
            live,
            np.minimum(np.abs(d_hi - bnd), np.abs(d_lo - bnd_hi)),
            np.float32(np.inf),
        )
        if self._sub_list.size:
            # family-sub-listed voices are tier-safe FOREVER (the sub
            # tiers cover every subsonic walk, ds in [0, 2]); without
            # this, band voices drag the cache horizon to ~0 and the
            # O(V) sweep would run every block in drift scenes
            gap[self._sub_list] = np.float32(np.inf)
        # frozen voices ride the kernel's frozen branch: their velocities
        # do not widen the read walk (spd keeps them for crossing horizons)
        vn_t = np.where(frozen, np.float32(0.0), vn)
        spd_t = np.where(frozen, np.float32(0.0), spd)
        steady = (float(vn_t.max()) * 1.05 + 0.5) / float(C)
        full = (float(spd_t.max()) * 1.05 + 0.5) / float(C)
        with np.errstate(divide="ignore", invalid="ignore"):
            horizon = float(np.where(spd > 0, gap / np.maximum(spd, 1e-9),
                                     np.float32(np.inf)).min())
        rem = np.where(smoothing & live, T - smdt, np.float32(0.0))
        self._b_cache = {
            "elapsed": elapsed,
            "steady": steady,
            "full": full,
            "clamp": clamp,
            "valid_until": self._t_scene + horizon,
            "trans_until": self._t_scene + float(rem.max()),
            # rotation blocks ride the cache: the ear-swing term needs only
            # max distance, inflated conservatively by the max speed times
            # the cache age (see _block_b) — without these, every rotating-
            # listener block would pay the full O(V) sweep.  Frozen voices
            # are exempt (rotation preserves norms, so it cannot unfreeze).
            "d_hi_max": float(np.where(frozen, np.float32(0.0), d_hi).max()),
            "spd_max": float(spd.max()),
            "t": self._t_scene,
            # per-voice components (same sweep, same validity horizons) —
            # the family sub-pass verdict derives from these
            "pv": {
                "live": live.copy(),
                "vn": vn,
                "trans": trans,
                "clamp": band,
                "frozen": frozen,
                "d_hi": d_hi,
                "d_lo": d_lo,
                "spd": spd,
            },
        }
        if clamp:
            steady = max(steady, 1.0)
            full = max(full, 1.0)
        if rot_sin_half > 0.0 and elapsed > 0:
            # the rotation moves each EAR distance by at most
            # min(2*HEAD, 2*dist*sin(theta/2)), spread across the block
            # (frozen voices exempt: rotation preserves their norms)
            swing = 2.0 * min(
                float(HEAD_RADIUS),
                self._b_cache["d_hi_max"] * float(rot_sin_half),
            )
            full += 1.05 * swing / (float(C) * elapsed)
        return steady, full

    def _block_b(self, elapsed, n, ratio, rot_sin_half):
        """Final walk-bound fraction for this block: steady contributions
        escalate exactly; transient ones are capped at the K=64 delta-class
        envelope so control traffic never compiles a fresh variant.

        The full mirror sweep is O(V) numpy, too hot per block — it runs
        only when the cached verdict can have
        changed: mirrors touched, block size changed, a rotation step, or a
        voice able to reach its clamp boundary (|gap|/speed horizon)."""
        c = self._b_cache
        if (
            c is None
            or c["elapsed"] != elapsed
            or self._t_scene >= c["valid_until"]
        ):
            steady, full = self._walk_bound(elapsed, rot_sin_half)
        else:
            steady, full = c["steady"], c["full"]
            if self._t_scene >= c["trans_until"]:
                full = steady  # every smoothing transition has decayed
            if c["clamp"]:
                steady = max(steady, 1.0)
                full = max(full, 1.0)
            if rot_sin_half > 0.0 and elapsed > 0:
                # rotation ear swing from the CACHED max distance, inflated
                # by max-speed x cache-age (a conservative upper bound on
                # drift since the sweep; the min with 2*HEAD caps any
                # overestimate) — a rotating listener would otherwise force
                # the O(V) sweep on every block of its turn
                d_hi = c["d_hi_max"] + c["spd_max"] * max(
                    0.0, self._t_scene + elapsed - c["t"]
                )
                swing = 2.0 * min(
                    float(HEAD_RADIUS), d_hi * float(rot_sin_half)
                )
                full += 1.05 * swing / (float(SPEED_OF_SOUND) * elapsed)
        b_cap = max(
            0.0, (64.0 / min(512, max(n, 1)) - abs(ratio - 1.0)) / max(ratio, 1e-9)
        )
        return max(steady, min(full, max(b_cap, steady)))

    def force_needed(self):
        """Whether this pool wants the (already-compiled) DELTA step variant
        even without queued events: while a motion refresh's position
        smoothing decays (smdt < T with a nonzero transition), the walk
        bound is temporarily wider, and riding the delta program — whose
        tier is pinned at the K=64 class — keeps live scenes on exactly two
        jitted programs (the README:11 no-glitch contract).  A pending
        family-sub-pass membership change also rides the delta program
        (the list ships with the delta arrays)."""
        if getattr(self, "_sub_dirty", False):
            return True
        c = self._b_cache
        if c is None:
            return True  # mirrors just changed; re-bound on the delta program
        return (
            self._t_scene < c["trans_until"]
            and c["full"] > c["steady"] + 1e-6
        )

    def _per_voice_bounds(self, elapsed, n, ratio, rot_sin_half):
        """Per-voice analogue of ``_block_b``: returns ``(b_v, dmax_v,
        live)`` numpy arrays (same sweep, caching and transient-capping
        semantics — the max over live voices of ``b_v`` equals the pool
        bound), or None when no voices are live.  Feeds the family
        sub-pass verdict: a handful of wide-walk voices (offset-clamped or
        fast movers) can be split out into a small wide-tier pass instead
        of demoting the whole pool's read tier."""
        c = self._b_cache
        if (
            c is None
            or c["elapsed"] != elapsed
            or self._t_scene >= c["valid_until"]
        ):
            self._walk_bound(elapsed, rot_sin_half)
            c = self._b_cache
        pv = c.get("pv")
        if pv is None:
            return None
        # between sweeps the per-voice bounds change only at the
        # trans_until cutoff (and under listener rotation, which varies
        # per block — not memoized): a live sub list would otherwise pay
        # this O(V) pass every block
        memo_key = None
        if rot_sin_half == 0.0:
            memo_key = (
                c["t"], elapsed, n, ratio,
                self._t_scene < c["trans_until"],
            )
            hit = getattr(self, "_pvb_memo", None)
            if hit is not None and hit[0] == memo_key:
                return hit[1]
        C = float(SPEED_OF_SOUND)
        live = pv["live"]
        vn = pv["vn"]
        trans = (
            pv["trans"]
            if self._t_scene < c["trans_until"]
            else np.zeros_like(pv["trans"])
        )
        steady = (vn * np.float32(1.05) + np.float32(0.5)) / C
        full = ((vn + trans) * np.float32(1.05) + np.float32(0.5)) / C
        clamp_v = pv["clamp"]
        steady = np.where(clamp_v, np.maximum(steady, 1.0), steady)
        full = np.where(clamp_v, np.maximum(full, 1.0), full)
        if rot_sin_half > 0.0 and elapsed > 0:
            # cached per-voice distances, inflated by per-voice speed x
            # cache age (same conservative rotation-swing bound as
            # _block_b's cache-hit branch)
            age = np.float32(max(0.0, self._t_scene + elapsed - c["t"]))
            d_hi = pv["d_hi"] + (vn + pv["trans"]) * age
            swing = 2.0 * np.minimum(
                float(HEAD_RADIUS), d_hi * np.float32(rot_sin_half)
            )
            full = full + np.float32(1.05) * swing / (C * elapsed)
        b_cap = max(
            0.0, (64.0 / min(512, max(n, 1)) - abs(ratio - 1.0)) / max(ratio, 1e-9)
        )
        b_v = np.maximum(steady, np.minimum(full, np.maximum(b_cap, steady)))
        # certainly-frozen voices (ds = 0 exactly) ride the select kernel's
        # frozen branch on ANY tier: no walk bound, no sub-pass slot
        active = live & ~pv["frozen"]
        b_v = np.where(active, b_v, 0.0)
        dmax_v = np.where(active, abs(ratio - 1.0) + b_v * ratio, 0.0)
        out = (b_v, dmax_v, live)
        if memo_key is not None:
            self._pvb_memo = (memo_key, out)
        return out

    def tier_bound(self, interval, n):
        """PRE-drain conservative walk bound for pack-wide tier agreement
        (ScenePack renders every scene with one program): the post-drain
        bound any aligned pool can compute this block is <= this value, so
        max-over-pack of tier_bound is a sound shared floor.  Transient
        terms are capped exactly like ``_block_b``."""
        elapsed = float(np.float32(f32(interval) * np.float32(n)))
        ratio = float(np.float32(self.rate) * f32(interval))
        C = float(SPEED_OF_SOUND)
        T = float(POSITION_SMOOTHING_PERIOD)
        b_cap = max(
            0.0, (64.0 / min(512, max(n, 1)) - abs(ratio - 1.0)) / max(ratio, 1e-9)
        )
        b = self._block_b(elapsed, n, ratio, 0.0)
        margin = 2.0 / self.rate + 1e-4
        for slot, (p, v, d) in self.pending_motion.items():
            sm = _smooth_host(
                self._g_prev[slot : slot + 1],
                self._g_smdt[slot : slot + 1],
                0.0,
                self._g_mpos[slot : slot + 1],
                self._g_mvel[slot : slot + 1],
            )[0]
            vn = float(np.linalg.norm(np.asarray(v, np.float64)))
            trans = (
                0.0 if d else float(np.linalg.norm(np.asarray(p, np.float64) - sm)) / T
            )
            steady_p = (1.05 * vn + 0.5) / C
            full_p = (1.05 * (vn + trans) + 0.5) / C
            np_ = float(np.linalg.norm(np.asarray(p, np.float64)))
            ns_ = float(np.linalg.norm(sm.astype(np.float64)))
            d_hi = max(np_, ns_) + float(HEAD_RADIUS) + (vn + trans) * elapsed
            d_lo = min(np_, ns_) - float(HEAD_RADIUS) - (vn + trans) * elapsed
            if d_lo / C >= float(self._md_host[slot]) + margin:
                # certainly frozen for this block: rides the select
                # kernel's frozen branch, exempt from the walk bound
                steady_p = full_p = 0.0
            elif d_hi / C >= float(self._md_host[slot]) - elapsed - margin:
                steady_p = max(steady_p, 1.0)
                full_p = max(full_p, 1.0)
            b = max(b, max(steady_p, min(full_p, max(b_cap, steady_p))))
        return b

    def host_prepare(self, prev_rot, rot, interval, n, force=False):
        # per-(interval, n) invariants (elapsed, inner frame count, cursor
        # advance, rate ratio): scalar np.float32 chains cost ~1 us each
        # through the ufunc machinery, far too hot per block
        key = (float(interval), n)
        if getattr(self, "_prep_key", None) == key:
            elapsed, n_inner, advf, ratio = self._prep_inv
        else:
            elapsed = float(np.float32(f32(interval) * np.float32(n)))
            n_inner = (
                int(np.ceil(np.float64(elapsed) * self.rate)) + 1 if n > 0 else 1
            )
            advf = float(np.float32(np.float32(elapsed) * np.float32(self.rate)))
            ratio = float(np.float32(self.rate) * f32(interval))
            self._prep_key = key
            self._prep_inv = (elapsed, n_inner, advf, ratio)
        self._elapsed = elapsed
        self._n_inner = n_inner
        # shared ring cursor bookkeeping (ring.rs:18-41), host-authoritative:
        # all voices write at the pool cursor's phase (the zeroed band at
        # play supplies the pre-delay history), so these are four scalars
        # instead of per-voice columns and the append is a slab write
        cap = self.cap_pool
        w0f = float(self._w_host)
        int_path = advf.is_integer() and w0f.is_integer()
        if int_path:
            # integer fast path (the flagship config: rate-matched blocks,
            # aligned cursor): every f32 op below is exact on integers
            # < 2^24, so plain int arithmetic reproduces it bit-for-bit
            w_uni = int(w0f) + int(advf)
            endi = w_uni % cap
            start_i = int(w0f)
            n_write = int(advf)
            end = np.float32(endi)
            self._w_host = end
        else:
            end, start_i, n_write = self._prepare_cursor_f32(advf)
        params = {
            "w": end,
            "nw": np.int32(n_write),
            "wstart": np.int32(start_i),
        }
        # deltas ship (and mirror-update) BEFORE the tier choice: shipped
        # motion applies on this block, so the walk bound must reflect the
        # post-application trajectories
        params = self._delta_params(params, force)
        # fader bookkeeping rides the inner timebase (faders advance by the
        # ring-write frame count, like every inner node); it runs BEFORE
        # the read-path flag sync because a released fade's incoming spec
        # renders THIS block — a heavy (ds > tier) target must widen the
        # windows now, not one block late
        self._fade_tick(
            params if self._has_play else None, self.interval_inner, n_write
        )
        self._ema_flag_sync(self.interval_inner)
        # read-path tier: ring reads step at ds = (ring rate / scene rate)
        # x doppler (ring.rs:51-79 resamples at ANY ratio), so the chunk
        # length and walk bound K adapt to the ratio AND to the scene's
        # actual motion (exact host mirrors of the walk geometry); ratios/
        # walks beyond the kernel tiers take the exact elementwise read
        # (correctness path).  A voice whose propagation offset can clamp
        # at -max_delay (spatial.rs:414-415) reads FROZEN (ds = 0): the
        # bound goes >= 1 and only the 128-frame tier represents it.
        if prev_rot is rot:
            rot_sin_half = 0.0
        else:
            pr = np.asarray(prev_rot, np.float64)
            rr = np.asarray(rot, np.float64)
            rot_sin_half = (
                0.0
                if np.array_equal(pr, rr)
                else float(np.sqrt(max(0.0, 1.0 - min(1.0, np.dot(pr, rr) ** 2))))
            )
        # (256, 256) carries the full frozen-read family (|ds-1| <= 1, a
        # clamped voice's walk <= n_c) at half the chunking overhead of
        # (128, 192); its window is exactly M_PAD wide
        # ((256, 192) would be dead here: (256, 256) accepts a strict
        # superset of bounds and its window also fits M_PAD at all
        # realistic rates)
        tiers = ((512, 32), (512, 64), (512, 128), (256, 256), (128, 192))
        if self._has_play:
            # delta blocks skip the tight tier (pin at the K=64 class): a
            # live scene then alternates between exactly two programs
            # (idle@32 + delta@64) for the whole ±40 m/s envelope, with
            # wider STANDING bounds (clamp/fast velocities) authoritative
            tiers = tiers[1:]
        self._sub_plan(n, ratio, elapsed, rot_sin_half, params, tiers)
        # mirror the walk's smoothing-clock advance (step 3); f32 array +
        # f32 scalar stays f32 (no astype copy needed)
        self._g_smdt = self._g_smdt + np.float32(elapsed)
        self._t_scene += elapsed
        # stream ingest + cursor-mirror shadow (ingest grows len first,
        # then the advance releases — the order dr_render uses in-graph);
        # counts mirror the device's mask gate (idle slots hold cursors)
        if self.proto.batch:
            ing = self.proto.dr_ingest_params()
            if ing is not None:
                params["ing"] = ing
            if self.mask_host.all():
                # uniform tick: the leaves defer it (O(1) debt, replayed
                # exactly at the first mirror read) — write-free stream
                # pools then cost no per-block numpy work
                self.proto.dr_host_tick(self.interval_inner, int(n_write))
            else:
                self.proto.dr_host_tick(
                    self.interval_inner,
                    np.where(self.mask_host, np.int32(n_write), np.int32(0)),
                )
        # param-FREE idle blocks: when the cursor math is on the integer
        # fast path, the traced step derives (w, nw, wstart) from the
        # carried device cursor ("wcur") exactly and the dispatch ships
        # NOTHING.  Delta blocks keep the params and resync the device
        # cursor.
        self._w_free = int_path and n_write > 0 and len(params) == 3
        if self._w_free:
            return {}
        return params

    def _prepare_cursor_f32(self, advf):
        """General (fractional-cursor) f32 cursor advance — the exact
        original np.float32 chain, for non-rate-matched configs."""
        capf = np.float32(self.cap_pool)
        adv = np.float32(advf)
        w0 = np.float32(self._w_host)
        # UNWRAPPED advance: blocks may exceed the ring modulus (elapsed >
        # max_delay is legal for large n), where a wrapped end == start
        # would alias to "no write"; cap is a pow2 integer and w0 + adv <
        # 2*cap, so the mod below is exact and ceil(end) stays consistent
        # with the unwrapped count across blocks
        w_un = np.float32(w0 + adv)
        end = np.float32(np.mod(w_un, capf))
        start_i = int(np.ceil(w0))
        n_write = int(np.ceil(w_un)) - start_i
        self._w_host = end
        return end, start_i, n_write

    def _pick_tier(self, d, n, ladder):
        memo = getattr(self, "_tier_memo", None)
        if memo is None:
            memo = self._tier_memo = {}
        key = (d, n, ladder)
        hit = memo.get(key, False)
        if hit is not False:
            return hit
        out = None
        for n_c, k in ladder:
            if (
                d * min(n_c, max(n, 1)) <= k
                and _select_window(n_c, 127 + self.emax2, k) <= self.M_PAD
            ):
                out = (n_c, k)
                break
        if len(memo) > 256:
            memo.clear()
        memo[key] = out
        return out

    def _sub_plan(self, n, ratio, elapsed, rot_sin_half, params, tiers):
        """Pick the read tier(s) for this block, splitting wide-walk voices
        into the family sub-pass when that keeps the main pool on a
        512-frame tier.

        A voice is WIDE when its standing walk bound exceeds the loosest
        512-class tier (offset-clamped voices — frozen reads, ds = 0,
        spatial.rs:414-415 — and movers beyond ~±80 m/s).  Wide voices are
        host-listed (<= SUBCAP), masked out of the main pass via the
        carried ``tight`` column, and rendered by a small wide-tier pass
        over gathered rows.  Membership ships only on delta blocks (the
        list rides the delta program's params; ``force_needed`` pulls the
        next block onto it when a change is pending) — until it ships, the
        stray voice demotes the main tier for a block, exactly like the
        pre-split behavior.  Under a pack-wide floor the split is disabled
        (packed scenes must agree on one program; they demote as before)."""
        desired = None  # None = keep the shipped list as-is
        pvb = None
        if self._dmax_floor > 0.0 and self._sub_list.size:
            desired = self._EMPTY_SUB  # packs demote; no sub-pass under floors
        if self._dmax_floor == 0.0 and n > 0:
            # the per-voice sweep costs O(V) numpy per block; run it only
            # when the cheap pool-wide bound would demote the tier (or a
            # list is already live) — the flagship fast path skips it
            b_all = self._block_b(elapsed, n, ratio, rot_sin_half)
            cfg_all = self._pick_tier(abs(ratio - 1.0) + b_all * ratio, n, tiers)
            if cfg_all is None or cfg_all[0] < 512 or self._sub_list.size:
                pvb = self._per_voice_bounds(elapsed, n, ratio, rot_sin_half)
        if pvb is not None:
            b_v, dmax_v, live = pvb
            wide_v = live & (dmax_v * min(512, max(n, 1)) > 128.0)
            in_ship = np.zeros(self.capacity, bool)
            in_ship[self._sub_list] = True
            covered = not bool((wide_v & ~in_ship).any())
            c = self._b_cache
            fresh = c is not None and c.get("t") == self._t_scene
            # Replan only when the shipped list no longer covers every
            # wide voice (urgent), or right after a fresh sweep (cheap
            # relative to it).  Staying covered keeps the list as-is —
            # stale members are harmless (the sub tiers cover every
            # subsonic walk, and the sub pass is fixed SUBCAP shape), and
            # NOT shipping is what lets sweeps and ships batch.
            if (not covered or fresh) and (
                wide_v.any() or self._sub_list.size
            ):
                # PRE-LIST HORIZON: also list voices that can reach the
                # clamp transition band within H seconds (halved until the
                # candidate set fits SUBCAP).  Until H elapses no unlisted
                # voice can need the wide tier, so membership ships — and
                # the O(V) sweep reruns — in ~1/H-per-second batches
                # instead of per crossing (listed voices are horizon-
                # exempt, see _walk_bound's gap).
                pv = c["pv"]
                age = np.float32(max(0.0, self._t_scene - c["t"]))
                C = np.float32(SPEED_OF_SOUND)
                e32 = np.float32(elapsed)
                margin = np.float32(2.0 / self.rate + 1e-4)
                bnd = (self._md_host - e32 - margin) * C
                bnd_hi = (self._md_host + margin) * C
                spd = pv["spd"]
                d_hi = pv["d_hi"] + spd * age
                d_lo = np.maximum(pv["d_lo"] - spd * age, np.float32(0.0))
                frozen = pv["frozen"]
                cand = None
                for H in (8.0, 4.0, 2.0, 1.0, 0.5, 0.25, 0.1, 0.0):
                    r = spd * np.float32(H)
                    near = live & (
                        wide_v
                        | (~frozen & (d_hi + r >= bnd))
                        | (frozen & (d_lo - r <= bnd_hi))
                    )
                    idx = np.nonzero(near)[0]
                    if idx.size <= self.SUBCAP:
                        cand = idx
                        break
                desired = self._EMPTY_SUB
                if cand is not None and cand.size:
                    sd = dmax_v[cand]
                    sub_ok = self._pick_tier(
                        float(sd.max()), n, self.SUB_TIERS
                    )
                    mask_c = np.zeros(self.capacity, bool)
                    mask_c[cand] = True
                    tb = float(np.where(mask_c, 0.0, b_v).max())
                    main = self._pick_tier(
                        abs(ratio - 1.0) + tb * ratio, n, tiers
                    )
                    # splitting pays only when it rescues a 512 tier
                    if (sub_ok is not None and main is not None
                            and main[0] == 512):
                        desired = cand
        # membership updates ride delta blocks (ship path); a stray change
        # on an idle block leaves the shipped list authoritative and the
        # main tier demoted for one block (exact, just slower)
        if desired is not None and not np.array_equal(
            desired, self._sub_list
        ):
            if self._has_play:
                self._sub_list = desired
                self._sub_dirty = False
            else:
                self._sub_dirty = True
        else:
            self._sub_dirty = False
        shipped = self._sub_list
        if shipped.size:
            if self._has_play:
                # the delta program always carries the current list (one
                # param structure per program)
                idx = np.zeros(self.SUBCAP, np.int32)
                on = np.zeros(self.SUBCAP, np.float32)
                idx[: shipped.size] = shipped
                on[: shipped.size] = 1.0
                params["sub_idx"] = idx
                params["sub_on"] = on
            in_sub = np.zeros(self.capacity, bool)
            in_sub[shipped] = True
            if pvb is not None:
                b_v, dmax_v, live = pvb
                mb = float(np.where(in_sub, 0.0, b_v).max())
                sd_live = dmax_v[shipped][live[shipped]]
                sd = float(sd_live.max()) if sd_live.size else 0.0
            else:
                mb, sd = 0.0, 0.0
            self._read_cfg = self._pick_tier(
                abs(ratio - 1.0) + max(mb, float(self._dmax_floor)) * ratio,
                n, tiers,
            )
            self._sub_cfg = self._pick_tier(sd, n, self.SUB_TIERS)
            if self._read_cfg is None or self._sub_cfg is None:
                # beyond every kernel tier: whole-pool exact fallback reads
                # every voice (the sub split disengages)
                self._read_cfg = None
                self._sub_cfg = None
        else:
            b = max(
                self._block_b(elapsed, n, ratio, rot_sin_half),
                float(self._dmax_floor),
            )
            self._read_cfg = self._pick_tier(
                abs(ratio - 1.0) + b * ratio, n, tiers
            )
            self._sub_cfg = None
        cur = (self._read_cfg, self._sub_cfg, int(self._sub_list.size))
        if cur != self._tier_last:
            self._tier_last = cur
            if len(self._tier_log) < 4096:
                self._tier_log.append((float(self._t_scene),) + cur)

    _EMPTY_SUB = np.zeros(0, np.int64)

    def _advance_block(self, dstate, ddata, params, n):
        """One block's control walk, ring append, and read-prep geometry
        (steps 1-6 of the render plus the per-ear cursor/gain scalars).
        Returns ``(S, ro)`` with ``ro`` holding the per-ear read
        operands."""
        from .ops.geometry import ear_states_c

        S = dict(dstate)
        V = S["mask"].shape[0]
        elapsed = np.float32(self._elapsed)
        ratef = np.float32(self.rate)
        n_inner = self._n_inner

        # 1-4. control walk (plays, motion, geometry, lingering)
        S, mask, prev_pos, next_pos = self._walk_device(S, params, elapsed)

        # 5. shared ring cursor: host-computed scalars on delta blocks
        # (resyncing the carried device cursor), derived in-graph from
        # "wcur" on param-free idle blocks (see host_prepare; the f32 adds
        # below are exact on the integer fast path, so the traced values
        # equal the host mirror bit-for-bit)
        cap = self.cap_pool
        capf = np.float32(cap)
        if "w" in params:
            w_end = params["w"]
            nw_s = jnp.int32(params["nw"])
            start_i = params["wstart"]
        else:
            adv = np.float32(self._prep_inv[2])
            w0 = S["wcur"][0]
            w_un = w0 + adv
            w_end = jnp.mod(w_un, capf)
            start_i = jnp.ceil(w0).astype(jnp.int32)
            nw_s = jnp.ceil(w_un).astype(jnp.int32) - start_i
        S["wcur"] = w_end[None]
        # dead/unplayed slots do not advance their inner cursors (their ring
        # writes are garbage masked out at the read anyway); without this an
        # idle slot's int32 sample cursor would grow every block and wrap
        # after ~12 h at 48 kHz, corrupting lingering is_finished readbacks
        n_write = jnp.where(mask, nw_s, 0)

        # 6. inner source render; flat slab append (ring.rs:18-41).  All
        # n_inner frames are written every block — the <=1-frame overlap past
        # n_write is recomputed identically next block (deterministic
        # sources), so audio is exact while writes stay slab-shaped.
        if "ing" in params:
            # stream PCM ingest at the device write cursors (before the
            # inner render reads, like the host pools' write-then-read)
            S["inner"] = self.proto.dr_ingest(S["inner"], params["ing"])
        inner2, samples = self.proto.dr_render(
            S["inner"], ddata.get("inner", {}), self.interval_inner, n_inner, n_write
        )
        S["inner"] = inner2
        flat = _ring_append(
            S["ring"].reshape(V, self.rowlen), samples, start_i, cap,
            self.W_CHUNK, self.M_PAD,
        )
        S["ring"] = flat.reshape(self._ring_shape(V))

        # 7. per-ear read cursors and gain ramps (spatial.rs:409-431),
        # component-split per ear: every array below is (V,) (see
        # ops/geometry.py component notes)
        p_off_c, p_gain_c = ear_states_c(prev_pos, S["radius"])
        n_off_c, n_gain_c = ear_states_c(next_pos, S["radius"])
        nmd = -S["max_delay"]
        p_off_c = [jnp.maximum(po - elapsed, nmd) for po in p_off_c]
        n_off_c = [jnp.maximum(no, nmd) for no in n_off_c]
        nf = np.float32(n) if n > 0 else np.float32(1.0)
        d_gain_c = [(n_gain_c[e] - p_gain_c[e]) / nf for e in range(2)]
        wp = w_end + S["phase"]
        offset0_c = [
            jnp.mod(wp + p_off_c[e] * ratef, capf) for e in range(2)
        ]
        obase_c = [jnp.floor(o) for o in offset0_c]
        split_c = [
            device_split_ds(((n_off_c[e] - p_off_c[e]) / nf) * ratef)
            for e in range(2)
        ]
        maskf = mask.astype(jnp.float32)
        return S, {
            "maskf": maskf,
            "p_gain_c": p_gain_c,
            "d_gain_c": d_gain_c,
            "offset0_c": offset0_c,
            "obase_c": obase_c,
            "split_c": split_c,
        }

    def render(self, dstate, ddata, params, n):
        S, ro = self._advance_block(dstate, ddata, params, n)
        V = S["mask"].shape[0]
        maskf = ro["maskf"]
        p_gain_c = ro["p_gain_c"]
        d_gain_c = ro["d_gain_c"]
        split_c = ro["split_c"]
        base_c = [o.astype(jnp.int32) for o in ro["obase_c"]]
        frac_c = [ro["offset0_c"][e] - ro["obase_c"][e] for e in range(2)]
        # beyond every read tier (exotic rate ratios): one exact read in
        # WARP_CHUNK-frame chunks
        cfg = self._read_cfg or (WARP_CHUNK, 0)
        sub_cfg = self._sub_cfg
        if "sub_idx" in params:
            # membership refresh (delta blocks): carry the list and the
            # derived per-voice tight flags in state
            S["sub_idx"] = jnp.asarray(params["sub_idx"], jnp.int32)
            S["sub_on"] = jnp.asarray(params["sub_on"], jnp.float32)
            hit = (
                S["sub_idx"][:, None]
                == jnp.arange(V, dtype=jnp.int32)[None, :]
            ) & (S["sub_on"][:, None] > 0.0)
            S["tight"] = 1.0 - hit.any(axis=0).astype(jnp.float32)
        maskf_main = maskf * S["tight"] if sub_cfg is not None else maskf
        out = self._windows_read(
            S["ring"], jnp.arange(V, dtype=jnp.int32), base_c, frac_c,
            split_c, p_gain_c, d_gain_c, maskf_main, cfg, n,
        )
        if sub_cfg is not None:
            # family sub-pass: the host-listed wide-walk voices render in
            # the wide tier's chunks (row-granular take of a 128-lane packed
            # scalar matrix), while the pool above kept its tight tier
            packc = jnp.stack(
                [jax.lax.bitcast_convert_type(base_c[0], jnp.float32),
                 jax.lax.bitcast_convert_type(base_c[1], jnp.float32),
                 frac_c[0], frac_c[1],
                 split_c[0][0].astype(jnp.float32),
                 split_c[1][0].astype(jnp.float32),
                 split_c[0][1], split_c[1][1],
                 split_c[0][2], split_c[1][2],
                 p_gain_c[0], p_gain_c[1],
                 d_gain_c[0], d_gain_c[1],
                 maskf],
                axis=-1,
            )  # (V, 15) -> padded to a 128-lane row for the row gather
            packc = jnp.pad(packc, ((0, 0), (0, 128 - packc.shape[1])))
            g = jnp.take(packc, S["sub_idx"], axis=0)
            gi = jax.lax.bitcast_convert_type(g, jnp.int32)
            out = out + self._windows_read(
                S["ring"],
                S["sub_idx"],
                [gi[:, 0], gi[:, 1]],
                [g[:, 2], g[:, 3]],
                [(g[:, 4].astype(jnp.int32), g[:, 6], g[:, 8]),
                 (g[:, 5].astype(jnp.int32), g[:, 7], g[:, 9])],
                [g[:, 10], g[:, 11]],
                [g[:, 12], g[:, 13]],
                g[:, 14] * S["sub_on"],
                sub_cfg, n,
            )
        return S, out

    #: blocks fused per multi-block dispatch group: consecutive idle blocks
    #: render in one traced group (fewer dispatches).  Env-tunable; <2
    #: disables.
    MULTI_NB = int(os.environ.get("ODDIO_MULTI_NB", "4"))

    def host_multiblock(self, interval, n):
        """Whether (and how wide) the NEXT idle blocks may dispatch as
        fused multi-block groups: requires the param-free cursor path, a
        single-chunk 512-class tier with no sub-pass, and ring slack for a
        group's appends (``max_delay*rate + (nb-1)*adv + K + 1152 <=
        cap``).  Returns nb >= 2 or 0."""
        nb = self.MULTI_NB
        if nb < 2 or not getattr(self, "_w_free", False):
            return 0
        cfg = self._read_cfg
        if cfg is None or self._sub_cfg is not None or cfg[0] < n:
            return 0
        advf = self._prep_inv[2]
        live = self.mask_host
        md = float(self._md_host[live].max()) if live.any() else 0.0
        if md * self.rate + (nb - 1) * advf + cfg[1] + 1152 > self.cap_pool:
            return 0
        return nb

    def _windows_read(self, ring, vidx, base_c, frac_c, split_c,
                      p_gain_c, d_gain_c, maskf, cfg, n):
        """Fractional per-ear reads with gain ramps over one voice set (the
        main pool or the family sub-pass list), mixed to (2, n).  ``ring``
        is the pool's (V, RPV, 128) ring; ``vidx`` (Vr,) maps each rendered
        row to its voice.  Cursor args are per-ear (Vr,) component lists
        (base_c, frac_c, p_gain_c, d_gain_c; split_c = [(ds_int, f_hi,
        f_lo)] x 2); ``maskf`` folds into the gains.  The block reads in
        ``cfg[0]``-frame chunks, cursors advanced exactly between them."""
        R_CHUNK = cfg[0]
        cap = self.cap_pool
        read = _ring_reader()
        flat = ring.reshape(-1)
        voff = vidx * np.int32(self.rowlen) + np.int32(self.W_CHUNK)
        base_c, frac_c = list(base_c), list(frac_c)
        parts = []
        for j0 in range(0, n, R_CHUNK):
            n_c = min(R_CHUNK, n - j0)
            g0_c = [
                (p_gain_c[e] + np.float32(j0) * d_gain_c[e]) * maskf
                for e in range(2)
            ]
            dg_c = [d_gain_c[e] * maskf for e in range(2)]
            parts.append(read(
                flat, voff, base_c, frac_c, split_c, g0_c, dg_c, n_c, cap
            ))
            if j0 + n_c < n:
                for e in range(2):
                    ds_e, fh_e, fl_e = split_c[e]
                    base_c[e], frac_c[e] = device_advance(
                        base_c[e], frac_c[e], jnp.int32(n_c), ds_e, fh_e, fl_e
                    )
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)


def _next_pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


class SpatialScene(Signal):
    """Signal for stereo output from a spatial scene (spatial.rs:159-188)."""

    channels = 2

    def __init__(self, initial_capacity=DEFAULT_CAPACITY):
        super().__init__()
        self.initial_capacity = initial_capacity
        self._rot = np.array([1.0, 0.0, 0.0, 0.0], dtype=np.float32)
        self._rot_pending = None
        self._rot_dev = None  # device copy ("_rot" state leaf)
        self._has_rot = False
        self._seek_pools = {}
        self._buffered_pools = {}

    @classmethod
    def new(cls, initial_capacity=DEFAULT_CAPACITY):
        """spatial.rs:170-188 — returns (SpatialSceneControl, SpatialScene)."""
        sig = cls(initial_capacity)
        return SpatialSceneControl(sig), sig

    def host_batchable(self):
        return False

    # -- control side ---------------------------------------------------------

    def _play(self, spec, options):
        if spec.channels != 1:
            raise ValueError("spatial signals must be mono (spatial.rs:276-279)")
        if not spec.seekable:
            raise TypeError(
                "play() requires a seekable (deterministic) signal; "
                "use play_buffered() for arbitrary signals"
            )
        dr = spec.dr_seek_supported()
        key = (spec.archetype(), dr)
        pool = self._seek_pools.get(key)
        if pool is None:
            cls = _SeekPoolDR if dr else _SeekPool
            pool = cls(f"s{len(self._seek_pools)}", spec, self.initial_capacity)
            self._seek_pools[key] = pool
        if dr:
            i, gen = pool.play(spec, options)
        else:
            i, gen = pool.claim(spec, options)
        return Spatial(pool, i, gen)

    def _play_buffered(self, spec, options, max_distance, rate, buffer_duration):
        if spec.channels != 1:
            raise ValueError("spatial signals must be mono (spatial.rs:276-279)")
        # spatial.rs:330: max_delay = max_distance / c + buffer_duration
        max_delay = np.float32(max_distance) / SPEED_OF_SOUND + np.float32(
            buffer_duration
        )
        cap = int(np.ceil(np.float32(max_delay) * np.float32(rate))) + 1
        bucket = max(2048, _next_pow2(cap))  # pool modulus / storage bucket
        if not spec.host_batchable():
            # submixes (Mixer / chains containing one): one-voice pool,
            # rendered unbatched (spatial.rs:314-340 takes any Signal)
            name = f"b{len(self._buffered_pools)}"
            pool = _BufferedPoolSingleton(name, spec, rate, bucket)
            self._buffered_pools[("singleton", name)] = pool
            i, gen = pool.play(spec, options, max_delay)
            return Spatial(pool, i, gen)
        # ingest-needing chains (streams, stream.rs:6 under any filter) go
        # DR when the route to the stream leaf is clean (single leaf,
        # interval-preserving wrappers — dr_ingest_ok); Speed/Fader-wrapped
        # streams keep the host-pool path
        dr = spec.dr_supported() and spec.dr_ingest_ok()
        key = (spec.archetype(), int(rate), bucket, dr)
        pool = self._buffered_pools.get(key)
        if pool is None:
            cls = _BufferedPoolDR if dr else _BufferedPool
            pool = cls(
                f"b{len(self._buffered_pools)}",
                spec,
                self.initial_capacity,
                rate,
                bucket,
            )
            self._buffered_pools[key] = pool
        i, gen = pool.play(spec, options, max_delay)
        return Spatial(pool, i, gen)

    def sync(self):
        """Pull device-resident voice state back to the host so handles
        observe finishes and freed slots become reusable."""
        for p in self._all_pools():
            p.sync()

    def sync_prefetch(self):
        for p in self._all_pools():
            pf = getattr(p, "sync_prefetch", None)
            if pf is not None:
                pf()

    # -- checkpoint/resume -----------------------------------------------------

    def host_snapshot(self):
        from .utils.checkpoint import _host_state

        out = {"rot": self._rot.copy(), "rot_pending": self._rot_pending}
        for p in self._all_pools():
            st = {"gen": p.slot_gen.copy(), "free": list(p._free)}
            if getattr(p, "is_dr", False):
                st["mask_host"] = p.mask_host.copy()
                st["stopped_host"] = p.stopped_host.copy()
                # queued control events are part of engine state: a snapshot
                # between play()/set_motion() and the next block must not
                # lose them (the reference's channels hold them in memory)
                import copy as _copy

                st["pending_plays"] = _copy.deepcopy(p.pending_plays)
                st["pending_motion"] = _copy.deepcopy(p.pending_motion)
                st["pending_ctrl"] = _copy.deepcopy(p.pending_ctrl)
                st["pending_fades"] = {
                    k: dict(v) for k, v in p.pending_fades.items()
                }
                st["fade_mirrors"] = {
                    name: {k: np.copy(v) for k, v in getattr(p, name).items()}
                    for name in ("_fade_prog", "_fade_inc", "_fade_fading",
                                 "_fade_flip", "_fade_dur")
                }
                st["geom_mirror"] = {
                    "prev": p._g_prev.copy(), "mpos": p._g_mpos.copy(),
                    "mvel": p._g_mvel.copy(), "smdt": p._g_smdt.copy(),
                    # the cached walk-bound verdict routes blocks between
                    # the idle/delta programs (force_needed); restore it so
                    # a resumed run replays the same program sequence
                    "t_scene": float(p._t_scene),
                    "b_cache": dict(p._b_cache) if p._b_cache else None,
                }
                if hasattr(p, "_md_host"):
                    st["md_host"] = p._md_host.copy()
                if hasattr(p, "_w_host"):
                    st["w_host"] = float(p._w_host)
                if p.proto.batch:
                    # batched proto mirrors (stream cursors) + producer queues
                    st["proto_host"] = _host_state(p.proto)
                    st["proto_pending"] = [
                        [np.copy(c) for c in q] for q in p.proto._pending
                    ]
                    st["proto_dirty"] = set(p.proto._dirty)
            else:
                st["cols"] = {c: np.copy(getattr(p, c)) for c in p._COL_NAMES}
                st["sig"] = _host_state(p.sig)
                if isinstance(p, _BufferedPool):
                    st["write"] = p.write.copy()
            out[p.name] = st
        return out

    def host_restore(self, snap):
        from .utils.checkpoint import _set_host_state

        self._rot = snap["rot"].copy()
        self._rot_pending = snap["rot_pending"]
        self._rot_dev = None  # re-upload the restored rotation
        for p in self._all_pools():
            st = snap[p.name]
            p.slot_gen = st["gen"].copy()
            p._free = list(st["free"])
            if getattr(p, "is_dr", False):
                p.mask_host = st["mask_host"].copy()
                p.stopped_host = st["stopped_host"].copy()
                import copy as _copy

                p.pending_plays = _copy.deepcopy(st.get("pending_plays", []))
                p.pending_motion = _copy.deepcopy(st.get("pending_motion", {}))
                p.pending_ctrl = _copy.deepcopy(
                    st.get("pending_ctrl", p.pending_ctrl)
                )
                p.pending_fades = {
                    k: dict(v)
                    for k, v in st.get("pending_fades", p.pending_fades).items()
                }
                for name, saved in st.get("fade_mirrors", {}).items():
                    setattr(p, name, {k: np.copy(v) for k, v in saved.items()})
                if "geom_mirror" in st:
                    gm = st["geom_mirror"]
                    p._g_prev = gm["prev"].copy()
                    p._g_mpos = gm["mpos"].copy()
                    p._g_mvel = gm["mvel"].copy()
                    p._g_smdt = gm["smdt"].copy()
                    p._t_scene = gm.get("t_scene", 0.0)
                    bc = gm.get("b_cache")
                    p._b_cache = dict(bc) if bc else None
                if "md_host" in st:
                    p._md_host = st["md_host"].copy()
                if "w_host" in st:
                    p._w_host = np.float32(st["w_host"])
                if "proto_host" in st:
                    _set_host_state(p.proto, st["proto_host"])
                    for i, q in enumerate(st["proto_pending"]):
                        p.proto._pending[i] = [np.copy(c) for c in q]
                    p.proto._dirty = set(st["proto_dirty"])
            else:
                for c, v in st["cols"].items():
                    setattr(p, c, np.copy(v))
                _set_host_state(p.sig, st["sig"])

    # scene-in-scene submixes checkpoint through the aux hook like mixers
    host_aux_snapshot = host_snapshot
    host_aux_restore = host_restore

    def _set_listener_rotation(self, rotation):
        """spatial.rs:345-349 — stores the inverse quaternion."""
        q = f32(rotation)
        self._rot_pending = quat_invert(q)

    # -- Signal protocol ---------------------------------------------------------

    def _all_pools(self):
        return list(self._buffered_pools.values()) + list(self._seek_pools.values())

    def archetype(self):
        pools = tuple(
            (
                p.name,
                (p.proto if getattr(p, "is_dr", False) else p.sig).archetype(),
                getattr(p, "ring_len", 0),
                getattr(p, "_n_inner", 0),
                getattr(p, "is_dr", False),
                getattr(p, "_elapsed", 0.0),
                getattr(p, "_has_play", False),
                getattr(p, "_has_mot", False),
                getattr(p, "_w_free", False),
                getattr(p, "_read_cfg", None),
                getattr(p, "_sub_cfg", None),
            )
            for p in self._all_pools()
        )
        return ("SpatialScene", self._has_rot, pools)

    def host_structure_event(self):
        for p in self._all_pools():
            if getattr(p, "is_dr", False):
                # bulk plays apply eagerly outside the jitted step
                if len(p.pending_plays) > p.k_play:
                    return True
            elif p.sig.host_structure_event():
                return True
        return False

    def host_wants_deltas(self):
        """True when the NEXT block would ship control-delta arrays — the
        pack-coordination predicate (ScenePack ORs it across scenes so
        every scene takes the same step variant on a given block, while
        all-idle pack blocks ship nothing)."""
        return self._rot_pending is not None or any(
            bool(p.pending_plays) or bool(p.pending_motion)
            or p._ctrl_pending_any() or p.force_deltas
            or getattr(p, "force_needed", lambda: False)()
            for p in self._all_pools()
            if getattr(p, "is_dr", False)
        )

    def host_prepare(self, interval, n, count=None, force=False):
        # listener rotation swap refresh (spatial.rs:382-386).  The host
        # keeps the authoritative mirror; device-resident pools read the
        # device copy ("_rot" state leaf, updated via a delta only when a
        # rotation event occurs) so idle blocks ship no rotation params.
        prev_rot = self._rot
        rot_event = self._rot_pending is not None
        if rot_event:
            if self._rot_dev is None:
                # materialize the device copy of the PRE-event rotation now:
                # the in-graph refresh needs (prev, new), and device_collect
                # runs after this swap
                self._rot_dev = jnp.asarray(self._rot)
            self._rot = self._rot_pending
            self._rot_pending = None
        rot = self._rot
        # scene-global control-event flag: when ANY device-resident pool has
        # queued events, every DR pool ships (padded) delta arrays, so a live
        # scene alternates between exactly two step variants regardless of
        # which pool the events hit (retrace containment).  ``force`` is the
        # pack-level equivalent (an event in a SIBLING scene).
        force = force or rot_event or any(
            bool(p.pending_plays) or bool(p.pending_motion)
            or p._ctrl_pending_any() or p.force_deltas
            or getattr(p, "force_needed", lambda: False)()
            for p in self._all_pools()
            if getattr(p, "is_dr", False)
        )
        self._has_rot = force
        out = {}
        if force:
            out["_rot_new"] = rot.copy()
        for p in self._all_pools():
            if getattr(p, "is_dr", False):
                out[p.name] = p.host_prepare(prev_rot, rot, f32(interval), n, force)
            else:
                out[p.name] = p.host_prepare(prev_rot, rot, f32(interval), n)
        return out

    def device_collect(self):
        if self._rot_dev is None:
            self._rot_dev = jnp.asarray(self._rot)
        out = {"_rot": self._rot_dev}
        for p in self._all_pools():
            if getattr(p, "is_dr", False):
                out[p.name] = p.dr_state()
            else:
                d = {"inner": p.sig.device_collect()}
                if isinstance(p, _BufferedPool):
                    d["ring"] = p.ring_state()
                out[p.name] = d
        return out

    def device_store(self, d):
        self._rot_dev = d["_rot"]
        for p in self._all_pools():
            if getattr(p, "is_dr", False):
                p.state = d[p.name]
            else:
                p.sig.device_store(d[p.name]["inner"])
                if isinstance(p, _BufferedPool):
                    p.ring = d[p.name]["ring"]

    def device_data(self):
        return {
            p.name: {
                "inner": (p.proto if getattr(p, "is_dr", False) else p.sig).device_data()
            }
            for p in self._all_pools()
        }

    def host_multiblock(self, interval, n):
        """Fused idle-group width the Renderer may dispatch (0 = off):
        every pool must be device-resident, at least one buffered pool
        must profit, and each buffered pool must pass its superwindow
        gate (_BufferedPoolDR.host_multiblock)."""
        nb = 0
        for p in self._all_pools():
            if not getattr(p, "is_dr", False):
                return 0
            m = getattr(p, "host_multiblock", None)
            if m is None:
                continue
            k = m(interval, n)
            if k < 2:
                return 0
            nb = k if nb == 0 else min(nb, k)
        return nb

    def render_multi(self, dstate, ddata, n, nb):
        """``nb`` consecutive PARAM-FREE blocks as one traced group (the
        Renderer dispatches these only for idle runs that passed
        host_multiblock): per-block semantics identical to ``render`` with
        empty params; buffered pools share one superwindow gather per
        group.  Returns (d2, (2, nb*n))."""
        rot_prev = dstate["_rot"]
        out = jnp.zeros((2, nb * n), dtype=jnp.float32)
        d2 = {"_rot": rot_prev}
        for p in self._all_pools():
            pp = {"rot_prev": rot_prev, "rot": rot_prev}
            dsub, block = p.render_multi(
                dstate[p.name], ddata[p.name], pp, n, nb
            )
            d2[p.name] = dsub
            out = out + block
        return d2, out

    def render(self, dstate, ddata, params, n):
        # rotation refresh in-graph: prev = state, cur = delta (if any)
        rot_prev = dstate["_rot"]
        rot_cur = params["_rot_new"] if "_rot_new" in params else rot_prev
        out = jnp.zeros((2, n), dtype=jnp.float32)
        d2 = {"_rot": rot_cur}
        for p in self._all_pools():
            pp = params[p.name]
            if getattr(p, "is_dr", False):
                pp = dict(pp)
                pp["rot_prev"] = rot_prev
                pp["rot"] = rot_cur
            if getattr(p, "is_singleton", False):
                # under a sharded pack the singleton (submix) subtree is
                # REPLICATED over the voice mesh axis: render it outside the
                # delta-localization context (its inner indices are not
                # shard-offset) and count it on voice-shard 0 only, or the
                # pack's closing psum would multiply it by the shard count
                from .parallel.context import current_voice_axis, voice_axis

                ax = current_voice_axis()
                with voice_axis(None):
                    dsub, block = p.render(
                        dstate[p.name], ddata[p.name], pp, n
                    )
                if ax is not None:
                    block = jnp.where(
                        jax.lax.axis_index(ax) == 0, block, 0.0
                    )
            else:
                dsub, block = p.render(dstate[p.name], ddata[p.name], pp, n)
            d2[p.name] = dsub
            out = out + block
        return d2, out

    def params_voice_axes(self, params):
        """Which param leaves carry a leading voice axis (for sharding):
        device-resident pools ship sparse deltas (replicated), host pools
        ship per-voice arrays (voice-sharded)."""
        import jax

        out = {}
        for p in self._all_pools():
            sub = params[p.name]
            pv = not getattr(p, "is_dr", False) and not getattr(
                p, "is_singleton", False
            )
            m = jax.tree.map(lambda _, pv=pv: pv, sub)
            if getattr(p, "is_dr", False) and "ing" in sub:
                # DR stream-ingest chunks are dense per-voice payloads
                m["ing"] = jax.tree.map(lambda _: True, sub["ing"])
            out[p.name] = m
        if "_rot_new" in params:
            out["_rot_new"] = False
        return out

    def device_state_voice_axes(self):
        """Which device-state leaves carry a leading voice axis (for
        sharding); the scene-level rotation replicates."""
        import jax

        out = jax.tree.map(lambda _: True, self.device_collect())
        out["_rot"] = False
        for p in self._all_pools():
            if isinstance(p, _BufferedPoolDR):
                out[p.name]["wcur"] = False  # pool-wide cursor, replicated
            if getattr(p, "is_singleton", False):
                # submix subtree is scene-level: replicate over voice axis
                out[p.name] = jax.tree.map(lambda _: False, out[p.name])
        return out


class SpatialSceneControl:
    """Control for modifying a SpatialScene (spatial.rs:267-350)."""

    def __init__(self, scene):
        self._scene = scene

    def play(self, signal, options=None):
        return self._scene._play(signal, options or SpatialOptions())

    def play_buffered(self, signal, options=None, max_distance=100.0, rate=48000,
                      buffer_duration=0.1):
        return self._scene._play_buffered(
            signal, options or SpatialOptions(), max_distance, rate, buffer_duration
        )

    def set_listener_rotation(self, rotation):
        """Listener rotation as quaternion (s, x, y, z); an unrotated listener
        faces -Z with +X right and +Y up (spatial.rs:342-349)."""
        self._scene._set_listener_rotation(rotation)

    # -- observability (additive; the reference exposes only per-handle
    # getters, gain.rs:134-136 / frames.rs:238-247 — the tier machinery is
    # engine-specific and its demotions must be user-diagnosable) ------

    def read_tiers(self):
        """Per-pool snapshot of the active buffered read plan: the
        ``(chunk, K)`` tier of the main pass, the family sub-pass tier and
        its occupancy, counts of certainly-frozen / band voices from the
        last host walk sweep, and whether the pool is DEMOTED off the
        tight 512-frame tier (the run3-style silent 2x collapse)."""
        out = {}
        for p in self._scene._buffered_pools.values():
            if not getattr(p, "is_dr", False):
                out[p.name] = {"kind": "host"}
                continue
            cfg = p._read_cfg
            pv = (p._b_cache or {}).get("pv") or {}
            frozen = pv.get("frozen")
            band = pv.get("clamp")
            out[p.name] = {
                "kind": "dr",
                "read_cfg": cfg,
                "sub_cfg": p._sub_cfg,
                "listed": int(p._sub_list.size),
                "frozen": int(frozen.sum()) if frozen is not None else None,
                "band": int(band.sum()) if band is not None else None,
                "demoted": cfg is None or cfg[0] < 512,
            }
        return out

    def tier_events(self, drain=True):
        """Tier-transition log: ``{pool: [(t_scene, read_cfg, sub_cfg,
        listed), ...]}`` appended whenever a pool's read plan changes.
        ``drain=True`` (default) clears the log."""
        out = {}
        for p in self._scene._buffered_pools.values():
            log = getattr(p, "_tier_log", None)
            if log:
                out[p.name] = list(log)
                if drain:
                    log.clear()
        return out


class Spatial:
    """Control for updating the motion of a spatial signal (spatial.rs:119-157)."""

    def __init__(self, pool, slot, gen):
        self._pool = pool
        self._slot = slot
        self._gen = gen

    def _live(self):
        return self._pool.slot_gen[self._slot] == self._gen

    def set_motion(self, position, velocity, discontinuity=False):
        """spatial.rs:137-149 — last-value-wins, applied at the next block."""
        self._pool.push_motion(self._slot, self._gen, position, velocity, discontinuity)

    def is_finished(self):
        """Whether the signal has completed and can no longer be heard,
        accounting for propagation delay (spatial.rs:151-157).  For
        device-resident pools this is observed as of the last state sync."""
        return self._pool.handle_finished(self._slot, self._gen)
