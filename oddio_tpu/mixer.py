"""Dense masked mixer — oddio's dynamic voice set as a batched voice pool.

Reference: /root/reference/src/mixer.rs — ``Mixer`` sums a dynamic ``Set`` of
boxed same-frame-type signals (mixer.rs:89-120): drain control messages, drop
stopped/finished voices (setting their stop flag so handles observe it,
mixer.rs:102-105), then sample each voice and accumulate.  The lock-free
``Set``/``spsc`` plumbing (set.rs, spsc.rs) exists to do this without locks
on the audio thread.

Batch redesign (SURVEY.md §7): voices of equal *archetype* (graph structure)
live in a fixed-capacity pool of stacked host/device state with an active
mask.  Rendering is ``vmap`` over the voice axis plus a masked sum — one
fused reduction instead of a pointer-chasing loop.  ``play`` claims a slot
and writes the signal's state into the pool columns (the host-side analogue
of ``SetHandle::insert``, set.rs:55-66); capacity doubles by growing the
columns (the analogue of ``Msg::ReallocSignals``, set.rs:57-63, as a rare
re-jit event).  Finished voices are observed via host cursors at the *next*
block boundary, reproducing the reference's one-scan-late reclamation
semantics (mixer.rs:129-147).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .core.drctrl import DRCtrlMixin
from .core.hostmath import f32
from .core.signal import Signal


def _ingest_leaves(node):
    """Leaf signals in the chain that own a host->device ingest channel
    (Streams): the idle fast path tick-defers them directly."""
    kids = node.children()
    if not kids:
        return [node] if node.dr_needs_ingest() else []
    out = []
    for c in kids.values():
        out.extend(_ingest_leaves(c))
    return out

__all__ = ["Mixer", "MixerControl", "Mixed"]

DEFAULT_CAPACITY = 16


class Pool:
    """A fixed-capacity pool of voices sharing one signal archetype."""

    is_dr = False

    #: set by ScenePack (see PoolDR._unpack_hook): the batched sig's device
    #: leaves go stale while packed, so growth must pull the carry first
    _unpack_hook = None

    def __init__(self, name, spec, capacity):
        self.name = name
        self.proto = spec  # structure donor for clone/grow (state is per-slot)
        self.sig = spec.clone_batched(capacity)
        self.capacity = capacity
        self.mask = np.zeros(capacity, dtype=bool)
        self.stop = np.zeros(capacity, dtype=bool)
        self.slot_gen = np.zeros(capacity, dtype=np.int64)
        self._free = list(range(capacity - 1, -1, -1))

    def grow(self):
        if self._unpack_hook is not None:
            self._unpack_hook()
        old = self.capacity
        new = old * 2
        self.sig.grow_batched(new)
        self.mask = np.concatenate([self.mask, np.zeros(old, bool)])
        self.stop = np.concatenate([self.stop, np.zeros(old, bool)])
        self.slot_gen = np.concatenate([self.slot_gen, np.zeros(old, np.int64)])
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        self.capacity = new

    def play(self, spec):
        if not self._free:
            self.grow()
        i = self._free.pop()
        gen = int(self.slot_gen[i])
        self.sig.write_slot(i, spec, self, gen)
        spec._moved = True
        self.sig.device_reset_slot(i)
        self.mask[i] = True
        self.stop[i] = False
        return i, gen

    def reap(self):
        """Drop stopped/finished voices before rendering (mixer.rs:100-105)."""
        fin = self.sig.host_is_finished()
        drop = self.mask & (self.stop | fin)
        if drop.any():
            self.stop |= drop
            self.mask &= ~drop
            for i in np.nonzero(drop)[0]:
                self.slot_gen[i] += 1
                self._free.append(int(i))

    # handle interface shared with PoolDR
    def push_stop(self, slot, gen):
        if self.slot_gen[slot] == gen:
            self.stop[slot] = True

    def handle_stopped(self, slot, gen):
        if self.slot_gen[slot] != gen:
            return True
        return bool(self.stop[slot])


class PoolSingleton(Pool):
    """A one-voice pool for NON-BATCHABLE signals — submixes (a Mixer
    played into another Mixer), which the reference boxes like any Signal
    (mixer.rs:18-26).  The voice renders unbatched."""

    is_singleton = True

    def __init__(self, name, spec):
        self.name = name
        self.proto = spec
        self.sig = spec
        #: the signal's archetype AS PLAYED (before per-block dynamic
        #: fields evolve): fresh same-construction signals match this, so
        #: replays can rebind the freed pool (see Mixer.play)
        self._arch0 = spec.archetype()
        self.capacity = 1
        self.mask = np.zeros(1, dtype=bool)
        self.stop = np.zeros(1, dtype=bool)
        self.slot_gen = np.zeros(1, dtype=np.int64)
        self._free = [0]

    def grow(self):
        raise RuntimeError("singleton pools hold exactly one voice")

    def play(self, spec):
        i = self._free.pop()
        gen = int(self.slot_gen[i])
        spec._moved = True
        self.mask[i] = True
        self.stop[i] = False
        return i, gen

    def rebind(self, spec):
        """Reuse this freed one-voice pool for a fresh SAME-ARCHETYPE
        signal: the python subtree swaps wholesale (fresh host + device
        state), while the traced structure — and therefore every cached
        jitted program — is unchanged.  This is the singleton analogue of
        a batched pool's slot reuse (write_slot + device_reset_slot):
        replaying submixes neither leaks pools nor compiles new programs."""
        if self._unpack_hook is not None:
            self._unpack_hook()  # packed state is authoritative; pull first
        self.proto = self.sig = spec
        self._arch0 = spec.archetype()
        return self.play(spec)


class PoolDR(DRCtrlMixin):
    """Device-resident voice pool: mask/stop/finish tracking and the inner
    chain's whole state live on the device; the host ships only sparse play,
    stop and control-field deltas (the device-resident analogue of mixer.rs's Set
    messages + the filters' shared atomics) and observes handle state at
    sync points.  Mirrors _BufferedPoolDR (spatial.py); requires a mono,
    dr-capable inner chain."""

    is_dr = True

    #: set by ScenePack: called before any direct mutation of ``self.state``
    #: outside the jitted step (see _DRPoolBase._unpack_hook)
    _unpack_hook = None

    def __init__(self, name, spec, capacity, k_play=8, k_stop=64):
        self.name = name
        # ingest-needing protos (Stream) keep BATCHED host mirror columns:
        # the pool's host shadow of the device cursors plus the per-slot
        # producer queues (see Stream.dr_bind_slot)
        self.proto = (
            spec.clone_batched(capacity) if spec.dr_needs_ingest() else spec
        )
        self.capacity = capacity
        self.k_play = k_play
        self.k_stop = k_stop
        self.slot_gen = np.zeros(capacity, dtype=np.int64)
        self._free = list(range(capacity - 1, -1, -1))
        self.mask_host = np.zeros(capacity, dtype=bool)
        self.stopped_host = np.zeros(capacity, dtype=bool)
        self.pending_plays = []  # (slot, spec) — rows materialize at prepare
        self.pending_stops = set()
        self.force_deltas = False
        self._interval = None
        self.state = None
        self._init_ctrl(spec)
        #: ingest leaves (Streams) of the batched proto, cached once —
        #: object identity survives grow_batched; the idle fast path ticks
        #: them directly (deferred) instead of recursing the chain
        self._ingest_leaves = (
            _ingest_leaves(self.proto) if self.proto.batch else []
        )
        self._counts_memo = (None, None)  # (count, (V,) int32 array)

    def dr_state(self):
        if self.state is None:
            V = self.capacity
            self.state = {
                "mask": jnp.zeros(V, bool),
                "stopped": jnp.zeros(V, bool),
                "inner": jax.tree.map(jnp.asarray, self.proto.dr_state_init(V)),
            }
        return self.state

    def grow(self):
        if self._unpack_hook is not None:
            self._unpack_hook()
        old = self.capacity
        new = old * 2
        self._ctrl_grow(old, new)
        self.dr_state()
        fresh = {
            "mask": jnp.zeros(old, bool),
            "stopped": jnp.zeros(old, bool),
            "inner": jax.tree.map(jnp.asarray, self.proto.dr_state_init(old)),
        }
        self.state = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b]), self.state, fresh
        )
        self.slot_gen = np.concatenate([self.slot_gen, np.zeros(old, np.int64)])
        self.mask_host = np.concatenate([self.mask_host, np.zeros(old, bool)])
        self.stopped_host = np.concatenate(
            [self.stopped_host, np.zeros(old, bool)]
        )
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        if self.proto.batch:
            self.proto.grow_batched(new)
        self.capacity = new

    def play(self, spec):
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
        self.pending_plays.append((i, spec))
        self.mask_host[i] = True
        self.stopped_host[i] = False
        return i, gen

    def push_stop(self, slot, gen):
        if self.slot_gen[slot] == gen:
            self.pending_stops.add(int(slot))

    def handle_stopped(self, slot, gen):
        self._maybe_sync()
        if self.slot_gen[slot] != gen:
            return True
        return bool(self.stopped_host[slot])

    def _maybe_sync(self):
        """Refresh handle-visible state at most once per rendered block, so
        control-thread queries observe reclamation with the reference's
        one-scan-late timing (mixer.rs:129-147) without per-query readbacks."""
        if getattr(self, "_sync_seen", -1) != getattr(self, "_prep_count", 0):
            self.sync()
            self._sync_seen = getattr(self, "_prep_count", 0)

    def _rows(self, plays, interval):
        rows = [
            {"mask": True, "stopped": False, "inner": s.dr_slot_row(interval)}
            for _, s in plays
        ]
        return rows

    def _apply_plays_eager(self, interval):
        if self._unpack_hook is not None:
            self._unpack_hook()
        self.dr_state()
        idx = jnp.asarray([i for i, _ in self.pending_plays], jnp.int32)
        rows = jax.tree.map(
            lambda *xs: np.stack(xs),
            *self._rows(self.pending_plays, interval),
        )
        self.pending_plays = []
        S = dict(self.state)
        for k in ("mask", "stopped"):
            S[k] = S[k].at[idx].set(jnp.asarray(rows[k]))
        from .core.drctrl import rows_scatter

        S["inner"] = rows_scatter(S["inner"], rows["inner"], idx)
        self.state = S

    def sync_prefetch(self):
        self._sync_start()

    def sync(self):
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

    def _idle_gate(self, iv):
        """True when this block needs no params, cannot change the
        archetype, and every per-block side effect is deferrable: the
        render is then a pure device scan iteration."""
        return (not self.force_deltas and not self.pending_plays
                and not self.pending_stops and self._fade_quiet
                and not self._ema_dirty
                and getattr(self, "_ema_interval", None) == iv
                and not self._ctrl_pending_any()
                and not any(l._dirty for l in self._ingest_leaves))

    def _idle_apply(self, times, count=None):
        """Side effects of ``times`` consecutive idle blocks, O(1): defers
        the stream-cursor ticks as leaf debt (replayed exactly on read)."""
        cnt = self._count if count is None else int(count)
        self._has_play = self._has_stop = False
        for l in self._ingest_leaves:
            if getattr(l, "_has_write", False):
                l._has_write = False  # back to the write-free variant
            l.tick_debt_add(self._interval, cnt, times)

    def _idle_bulk_apply(self, interval, n, times, count=None):
        """Advance ``times`` idle blocks at once (caller checked
        _idle_gate); the per-block fast path and this are equivalent."""
        self._interval = float(np.float32(interval))
        self._count = int(n if count is None else count)
        self._prep_count = getattr(self, "_prep_count", 0) + times
        self._idle_apply(times)

    def host_prepare(self, interval, n, force=False, count=None):
        self._interval = float(np.float32(interval))
        #: frames each voice ADVANCES this block (mixer.rs renders and
        #: advances n; a submix inside a buffered spatial voice renders the
        #: ring lookahead but advances only the written count)
        self._count = int(n if count is None else count)
        self._prep_count = getattr(self, "_prep_count", 0) + 1
        params = {}
        if not force and self._idle_gate(self._interval):
            # IDLE fast path: no control traffic, quiet fades, clean ds
            # flags, no queued stream writes.  Params are {}, the archetype
            # cannot change, and the only per-block side effect — the
            # stream-cursor mirror tick — is DEFERRED by the leaves (O(1)
            # debt, replayed exactly at the first mirror read).  This keeps
            # idle pool blocks at Python-compare cost: per-block numpy
            # mirror ticks were a large share of a 16-scene ScenePack's
            # audio block before this path existed.
            self._idle_apply(1)
            return params
        if len(self.pending_plays) > self.k_play:
            self._apply_plays_eager(self._interval)
        # single "control events present" variant: plays AND stops ship
        # together so live pools alternate between two jitted programs only
        has = (
            bool(self.pending_plays) or bool(self.pending_stops)
            or self._ctrl_pending_any() or self.force_deltas or force
        )
        self._has_play = self._has_stop = has
        if has:
            self._ctrl_delta_params(params)
        if self._has_play:
            Kp = self.k_play
            take = self.pending_plays[:Kp]
            self.pending_plays = self.pending_plays[Kp:]
            play_idx = np.full(Kp, self.capacity, np.int32)
            rows = self._rows(take, self._interval)
            if len(rows) < Kp:
                default = {
                    "mask": False,
                    "stopped": True,
                    "inner": self.proto.dr_default_row(self._interval),
                }
                rows = rows + [default] * (Kp - len(rows))
            for j, (i, _) in enumerate(take):
                play_idx[j] = i
            params["play_idx"] = play_idx
            params["play"] = jax.tree.map(lambda *xs: np.stack(xs), *rows)
        if self._has_stop:
            Ks = self.k_stop
            items = sorted(self.pending_stops)[:Ks]
            for s in items:
                self.pending_stops.discard(s)
            stop_idx = np.full(Ks, self.capacity, np.int32)
            stop_idx[: len(items)] = items
            params["stop_idx"] = stop_idx
        # fader bookkeeping: release waiting fades into delta lanes (only
        # on control-event blocks, keeping two step variants) + advance
        # the deterministic progress mirrors every block
        # NB: mirrors advance by the CONSUMED frame count (count < n when a
        # buffered spatial voice wraps this mixer), matching dr_render's
        # device-side progress advance — an n-based tick would run the host
        # mirror ahead and flip fade banks out of sync with the device
        self._fade_tick(params if has else None, self._interval, self._count)
        # the AGC-path flag syncs AFTER fade releases: a shipped fade row
        # renders THIS block, so its Adapt taus must gate the step traced
        # for it, not one block late
        self._ema_flag_sync(self._interval)
        # stream ingest + cursor-mirror shadow (order mirrors render:
        # ingest grows len, then the advance releases consumed samples)
        if self.proto.batch:
            ing = self.proto.dr_ingest_params()
            if ing is not None:
                params["ing"] = ing
            if self._counts_memo[0] != (self.capacity, self._count):
                self._counts_memo = (
                    (self.capacity, self._count),
                    np.full(self.capacity, self._count, np.int32),
                )
            self.proto.dr_host_tick(self._interval, self._counts_memo[1])
        return params

    def render(self, dstate, ddata, params, n):
        from .parallel.context import localize_index

        S = dict(dstate)
        V = S["mask"].shape[0]
        # 1. plays (set.rs insert semantics: applied before the walk)
        if "play_idx" in params:
            from .core.drctrl import rows_scatter

            pidx = localize_index(params["play_idx"], V)
            rows = params["play"]
            for k in ("mask", "stopped"):
                S[k] = S[k].at[pidx].set(rows[k], mode="drop")
            S["inner"] = rows_scatter(S["inner"], rows["inner"], pidx)
        # 1b. control-field deltas (set_gain/set_speed, gain.rs:103-108)
        S["inner"] = self._ctrl_apply(S["inner"], params)
        # 1c. fade starts (fader.rs:86-93 swap-channel delivery)
        S["inner"] = self._fade_apply(S["inner"], params)
        # 1d. stream PCM ingest at the device write cursors
        if "ing" in params:
            S["inner"] = self.proto.dr_ingest(S["inner"], params["ing"])
        # 2. stop deltas (Mixed::stop, mixer.rs:33-36)
        if "stop_idx" in params:
            sidx = localize_index(params["stop_idx"], V)
            S["stopped"] = S["stopped"].at[sidx].set(True, mode="drop")
        # 3. reap finished/stopped voices, setting the stop flag so handles
        # observe it (mixer.rs:102-105)
        fin = self.proto.dr_is_finished(S["inner"])
        S["stopped"] = S["stopped"] | (S["mask"] & fin)
        S["mask"] = S["mask"] & ~S["stopped"]
        # 4. render + masked sum (NaN-safe where); mono chains return
        # (V, n), frame-generic ones (V, C, n) (frame.rs:67-79)
        count = jnp.full(V, getattr(self, "_count", n), jnp.int32)
        inner2, samples = self.proto.dr_render(
            S["inner"], ddata.get("inner", {}), self._interval, n, count
        )
        S["inner"] = inner2
        if samples.ndim == 2:
            samples = samples[:, None, :]
        out = jnp.sum(
            jnp.where(S["mask"][:, None, None], samples, 0.0), axis=0
        )
        return S, out


class Mixer(Signal):
    """A Signal that mixes a dynamic set of Signals (mixer.rs:60-120)."""

    def __init__(self, channels=1, initial_capacity=DEFAULT_CAPACITY):
        super().__init__()
        self.channels = channels
        self.initial_capacity = initial_capacity
        self._pools = {}  # archetype -> Pool, insertion-ordered

    @classmethod
    def new(cls, channels=1):
        """mixer.rs:70-82 — returns (MixerControl, Mixer)."""
        sig = cls(channels)
        return MixerControl(sig), sig

    def host_batchable(self):
        return False

    # -- control side -------------------------------------------------------

    def play(self, spec):
        """Begin playing ``spec``; returns a Mixed handle (mixer.rs:18-26)."""
        if spec.channels != self.channels:
            raise ValueError(
                f"signal has {spec.channels} channels, mixer expects {self.channels}"
            )
        if not spec.host_batchable():
            # reuse a freed same-archetype singleton first: the replay
            # rebinds the subtree in place (no new pool, no new programs)
            arch = spec.archetype()
            for pool in self._pools.values():
                if (
                    getattr(pool, "is_singleton", False)
                    and pool._free
                    and getattr(pool, "_arch0", None) == arch
                ):
                    slot, gen = pool.rebind(spec)
                    return Mixed(pool, slot, gen)
            name = f"p{len(self._pools)}"
            pool = PoolSingleton(name, spec)
            self._pools[("singleton", name)] = pool
            slot, gen = pool.play(spec)
            return Mixed(pool, slot, gen)
        # ingest-needing chains (streams, stream.rs:6 under any filter) go
        # DR when the route to the stream leaf is clean (single leaf,
        # interval-preserving wrappers — dr_ingest_ok); Speed/Fader-wrapped
        # streams keep the host-pool path
        dr = spec.dr_supported() and spec.dr_ingest_ok()
        arch = (spec.archetype(), dr)
        pool = self._pools.get(arch)
        if pool is None:
            cls = PoolDR if dr else Pool
            pool = cls(f"p{len(self._pools)}", spec, self.initial_capacity)
            self._pools[arch] = pool
        slot, gen = pool.play(spec)
        return Mixed(pool, slot, gen)

    # -- Signal protocol ------------------------------------------------------

    def children(self):
        return {}

    def _arch_extra(self):
        return (self.initial_capacity,)

    def archetype(self):
        # live signal archetypes: host pools' batched templates carry
        # per-block trace-relevant flags (e.g. Stream's zero-write variant)
        pools = tuple(
            (
                p.name,
                p.proto.archetype() if p.is_dr else p.sig.archetype(),
                getattr(p, "_interval", None),
                getattr(p, "_count", None),
                getattr(p, "_has_play", False),
                getattr(p, "_has_stop", False),
            )
            for p in self._pools.values()
        )
        return ("Mixer", self.channels, pools)

    def host_structure_event(self):
        for p in self._pools.values():
            if p.is_dr:
                # bulk plays apply eagerly outside the jitted step
                if len(p.pending_plays) > p.k_play:
                    return True
            elif p.sig.host_structure_event():
                return True
        return False

    def host_wants_deltas(self):
        """Pack-coordination predicate; see SpatialScene.host_wants_deltas."""
        return any(
            bool(p.pending_plays) or bool(p.pending_stops)
            or p._ctrl_pending_any() or p.force_deltas
            for p in self._pools.values()
            if p.is_dr
        )

    def host_idle_bulk_ok(self, interval):
        """True when ``host_prepare`` would take the idle fast path for
        every pool: params {}, archetype stable, side effects deferrable.
        Since the host is single-threaded, no control traffic can arrive
        inside one render call — a True gate holds for the whole remaining
        run, so block loops may advance it in O(1) (host_idle_bulk)."""
        iv = float(np.float32(interval))
        return all(
            p.is_dr and p._idle_gate(iv) for p in self._pools.values()
        )

    def host_idle_bulk(self, interval, n, times, count=None):
        """Advance ``times`` consecutive idle blocks at O(1) host cost.
        Returns False (no state touched) unless every pool passes the idle
        gate; equivalent to ``times`` host_prepare calls returning {}."""
        if not self.host_idle_bulk_ok(interval):
            return False
        for p in self._pools.values():
            p._idle_bulk_apply(interval, n, times, count)
        return True

    def host_prepare(self, interval, n, count=None, force=False):
        # scene-global control-event flag (retrace containment; see
        # SpatialScene.host_prepare); ``force`` adds pack-level events
        force = force or any(
            bool(p.pending_plays) or bool(p.pending_stops)
            or p._ctrl_pending_any()
            for p in self._pools.values()
            if p.is_dr
        )
        out = {}
        for arch, pool in self._pools.items():
            if pool.is_dr:
                out[pool.name] = pool.host_prepare(interval, n, force,
                                                   count=count)
                continue
            pool.reap()
            if getattr(pool, "is_singleton", False):
                out[pool.name] = {
                    "mask": pool.mask.copy(),
                    "p": pool.sig.host_prepare(
                        f32(interval), n,
                        None if count is None else int(count),
                    ),
                }
                continue
            V = pool.capacity
            iv = np.broadcast_to(f32(interval), (V,)).astype(np.float32)
            cnt = None if count is None else np.broadcast_to(count, (V,))
            out[pool.name] = {
                "mask": pool.mask.copy(),
                "p": pool.sig.host_prepare(iv, n, cnt),
            }
        return out

    def device_collect(self):
        return {
            p.name: (p.dr_state() if p.is_dr else p.sig.device_collect())
            for p in self._pools.values()
        }

    def device_store(self, d):
        for p in self._pools.values():
            if p.is_dr:
                p.state = d[p.name]
            else:
                p.sig.device_store(d[p.name])

    def device_reset_slot(self, i):
        """Batched-pool slot reset does not apply to engines: a Mixer is
        never host_batchable, so engines route through one-voice singleton
        pools (mixer.rs:18-26 boxes anything), whose replay path rebinds
        the whole subtree instead (PoolSingleton.rebind).  Reaching this
        would mean an engine was cloned into a batched pool — a bug."""
        raise RuntimeError(
            "engines render through singleton pools; batched slot reset "
            "is not applicable to a Mixer"
        )

    def device_data(self):
        return {
            p.name: (p.proto if p.is_dr else p.sig).device_data()
            for p in self._pools.values()
        }

    def _all_pools(self):
        return list(self._pools.values())

    def params_voice_axes(self, params):
        """Device-resident pools ship sparse deltas (replicated over the
        voice mesh axis); host pools ship per-voice arrays (voice-sharded).
        DR stream-ingest chunks are dense per-voice payloads, so they shard
        with the voices."""
        out = {}
        for p in self._pools.values():
            sub = params[p.name]
            pv = (not p.is_dr) and not getattr(p, "is_singleton", False)
            m = jax.tree.map(lambda _, pv=pv: pv, sub)
            if p.is_dr and "ing" in sub:
                m["ing"] = jax.tree.map(lambda _: True, sub["ing"])
            out[p.name] = m
        return out

    def device_state_voice_axes(self):
        """Which device-state leaves carry a leading voice axis (for
        sharding): batched/DR pools do; singleton (submix) subtrees are
        scene-level and replicate over the voice mesh axis."""
        return {
            p.name: jax.tree.map(
                lambda _, s=getattr(p, "is_singleton", False): not s,
                p.dr_state() if p.is_dr else p.sig.device_collect(),
            )
            for p in self._pools.values()
        }

    def sync(self):
        """Pull device-resident handle state back (is_stopped, reclamation)."""
        for p in self._pools.values():
            if p.is_dr:
                p.sync()

    def sync_prefetch(self):
        for p in self._pools.values():
            if p.is_dr:
                p.sync_prefetch()

    def render(self, dstate, ddata, params, n):
        out = jnp.zeros((self.channels, n), dtype=jnp.float32)
        d2 = {}
        for pool in self._pools.values():
            ps = params[pool.name]
            dd = ddata.get(pool.name, {})
            if pool.is_dr:
                dsub, block = pool.render(
                    dstate[pool.name], {"inner": dd}, ps, n
                )
                d2[pool.name] = dsub
                out = out + block
                continue
            if getattr(pool, "is_singleton", False):
                # under a sharded pack the singleton subtree is REPLICATED
                # over the voice mesh axis: render it outside the delta-
                # localization context (its inner indices are not shard-
                # offset) and count it on voice-shard 0 only, or the pack's
                # closing psum would multiply it by the shard count
                from .parallel.context import current_voice_axis, voice_axis

                ax = current_voice_axis()
                with voice_axis(None):
                    dsub, block1 = pool.sig.render(
                        dstate[pool.name], dd, ps["p"], n
                    )
                if ax is not None:
                    block1 = jnp.where(
                        jax.lax.axis_index(ax) == 0, block1, 0.0
                    )
                blocks = block1[None]
            else:
                dsub, blocks = jax.vmap(
                    lambda d, p: pool.sig.render(d, dd, p, n)
                )(dstate[pool.name], ps["p"])
            d2[pool.name] = dsub
            # where() (not multiply) so garbage from inactive slots — including
            # NaN/inf — never reaches the output
            contrib = jnp.where(ps["mask"][:, None, None], blocks, 0.0)
            out = out + jnp.sum(contrib, axis=0)
        return d2, out


    # -- checkpoint/resume ----------------------------------------------------

    def host_snapshot(self):
        import copy as _copy

        from .utils.checkpoint import _host_state

        out = {}
        for p in self._pools.values():
            st = {"gen": p.slot_gen.copy(), "free": list(p._free)}
            if p.is_dr:
                st["mask_host"] = p.mask_host.copy()
                st["stopped_host"] = p.stopped_host.copy()
                st["pending_plays"] = list(p.pending_plays)
                st["pending_stops"] = set(p.pending_stops)
                st["pending_ctrl"] = _copy.deepcopy(p.pending_ctrl)
                st["pending_fades"] = {
                    k: dict(v) for k, v in p.pending_fades.items()
                }
                st["fade_mirrors"] = {
                    name: {k: np.copy(v) for k, v in getattr(p, name).items()}
                    for name in ("_fade_prog", "_fade_inc", "_fade_fading",
                                 "_fade_flip", "_fade_dur")
                }
                st["interval"] = p._interval
                if p.proto.batch:
                    # batched proto mirrors (stream cursors) + producer queues
                    st["proto_host"] = _host_state(p.proto)
                    st["proto_pending"] = [
                        [np.copy(c) for c in q] for q in p.proto._pending
                    ]
                    st["proto_dirty"] = set(p.proto._dirty)
            else:
                st["mask"] = p.mask.copy()
                st["stop"] = p.stop.copy()
                st["sig"] = _host_state(p.sig)
            out[p.name] = st
        return out

    def host_restore(self, snap):
        from .utils.checkpoint import _set_host_state

        for p in self._pools.values():
            st = snap[p.name]
            p.slot_gen = st["gen"].copy()
            p._free = list(st["free"])
            if p.is_dr:
                p.mask_host = st["mask_host"].copy()
                p.stopped_host = st["stopped_host"].copy()
                p.pending_plays = list(st["pending_plays"])
                p.pending_stops = set(st["pending_stops"])
                import copy as _copy

                p.pending_ctrl = _copy.deepcopy(
                    st.get("pending_ctrl", p.pending_ctrl)
                )
                p.pending_fades = {
                    k: dict(v)
                    for k, v in st.get("pending_fades", p.pending_fades).items()
                }
                for name, saved in st.get("fade_mirrors", {}).items():
                    setattr(p, name, {k: np.copy(v) for k, v in saved.items()})
                p._interval = st["interval"]
                if "proto_host" in st:
                    _set_host_state(p.proto, st["proto_host"])
                    for i, q in enumerate(st["proto_pending"]):
                        p.proto._pending[i] = [np.copy(c) for c in q]
                    p.proto._dirty = set(st["proto_dirty"])
            else:
                p.mask = st["mask"].copy()
                p.stop = st["stop"].copy()
                _set_host_state(p.sig, st["sig"])

    # submixes (a Mixer played as a voice in another engine) checkpoint
    # through the generic host-state walk's aux hook
    # (utils/checkpoint._host_state)
    host_aux_snapshot = host_snapshot
    host_aux_restore = host_restore


class MixerControl:
    """Handle for controlling a Mixer from the game thread (mixer.rs:7-27)."""

    def __init__(self, mixer):
        self._mixer = mixer

    def play(self, spec):
        return self._mixer.play(spec)


class Mixed:
    """Handle to a signal playing in a Mixer (mixer.rs:30-44)."""

    def __init__(self, pool, slot, gen):
        self._pool = pool
        self._slot = slot
        self._gen = gen

    def _live(self):
        return self._pool.slot_gen[self._slot] == self._gen

    def stop(self):
        """Halt playback at the next block boundary (mixer.rs:33-36)."""
        self._pool.push_stop(self._slot, self._gen)

    def is_stopped(self):
        """Set by stop() and by signals naturally finishing (mixer.rs:38-44).
        For device-resident pools this is observed as of the last sync."""
        return self._pool.handle_stopped(self._slot, self._gen)
