"""Streaming audio ingest.

Reference: /root/reference/src/stream.rs — dynamic audio pushed from outside
(decoder/network) through a wait-free spsc channel; playback lerps between
buffered samples, zero-pads on underrun (stream.rs:37-61), releases consumed
samples back to the sender (stream.rs:63-69), and finishes once the sender is
dropped and the buffer drained (stream.rs:88-91).

Like the reference's ``Stream<T>`` (stream.rs:6), streams are frame-generic:
``channels=C`` buffers (frame, C) data and renders a (C, n) block.

Device form: the spsc ring becomes a device-resident ring tensor per stream
voice.  The control half appends frames into a host-side pending list; each
block the pending chunk ships to the device and is scattered into the ring
(the host→device copy *is* the producer side of the channel), while the host
mirrors the ring's (start, len, t) bookkeeping with the reference's exact f32
arithmetic.  Consumption ("release") is pure cursor math — the ring is simply
overwritten later.  Ingest bookkeeping is O(active writers), not O(voices):
a dirty-set tracks which voices have pending frames.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.hostmath import f32, full
from ..core.signal import ControlBlock, Signal
from ._dev import iota_f32, lerp

__all__ = ["Stream", "StreamControl"]


class Stream(Signal):
    _host_fields = ("rate", "t", "buflen", "closed", "stopping", "start")

    def __init__(self, rate, size, max_write_per_block=None, channels=1):
        """``rate``: stream sample rate; ``size``: max buffered frames
        (stream.rs:17-34); ``channels``: frame width (Stream<T>, stream.rs:6).
        ``max_write_per_block`` caps how many new frames ship to the device
        per block (defaults to ``size``, which is fully faithful; smaller
        values bound per-block transfer for huge pools)."""
        super().__init__()
        self.size = int(size)
        # internal ring modulus, padded to whole 128-sample rows with room
        # for the zero-termination column; capacity checks (free/write) use
        # the logical ``size``, so buffering semantics are unchanged
        self.size_pad = -(-(self.size + 1) // 256) * 256 + 256
        self.max_write = int(max_write_per_block or size)
        self.channels = int(channels)
        self._alloc_host(())
        self.rate[()] = np.float64(rate)
        self._cb = ControlBlock(self)
        # host-side producer queue (list of np (k, C) chunks); aliases the
        # slot queue once played into a pool
        self._cb.pending = self._pending.flat[0]
        self.control = StreamControl(self._cb)

    @classmethod
    def new(cls, rate, size, channels=1):
        sig = cls(rate, size, channels=channels)
        return sig.control, sig

    def _alloc_host(self, batch):
        self.rate = full(batch, 1.0, np.float64)
        self.t = full(batch, 0.0)
        self.buflen = full(batch, 0, np.int32)
        self.closed = np.zeros(batch, dtype=bool)
        self.stopping = np.zeros(batch, dtype=bool)
        self.start = full(batch, 0, np.int32)
        # per-slot producer queues (object array so pools keep one per voice)
        self._pending = np.empty(batch if batch else (1,), dtype=object)
        for i in range(self._pending.size):
            self._pending.flat[i] = []
        # voices with queued frames — ingest cost is O(|dirty|) per block
        self._dirty = set()
        # deferred uniform cursor ticks: [interval, count, times] runs —
        # write-free idle blocks cost O(1) host work and the mirror math
        # replays EXACTLY (same per-block f32 chain) at the first read
        self._tick_debt = []

    def _copy_static_from(self, other):
        self.size = other.size
        self.size_pad = other.size_pad
        self.max_write = other.max_write
        self.channels = other.channels

    def grow_batched(self, new_V):
        # the per-slot producer queues are an object array, not a numpy
        # host field — extend them alongside the columns
        self._flush_tick_debt()  # replay at the pre-growth shape
        old = self._pending
        super().grow_batched(new_V)
        pend = np.empty((new_V,), dtype=object)
        pend[: len(old)] = old
        for i in range(len(old), new_V):
            pend[i] = []
        self._pending = pend

    def _arch_extra(self):
        # _has_write is set per block by host_prepare: blocks with no queued
        # producer data skip the (V, C, max_write) chunk params entirely —
        # the stream analogue of the engines' zero-delta fast path.  The
        # renderer keys steps on the archetype after preparing, so the two
        # variants get their own jitted programs.
        return (self.size, self.max_write, self.channels,
                getattr(self, "_has_write", False))

    def write_slot(self, i, spec, pool, gen):
        super().write_slot(i, spec, pool, gen)
        self._pending[i] = spec._cb.pending
        spec._cb.pending = self._pending[i]
        if self._pending[i]:
            self._dirty.add(int(i))
        else:
            self._dirty.discard(int(i))

    # control-side helpers (called through the ControlBlock)
    def _free_space(self, idx):
        self._flush_tick_debt()
        pend = sum(len(c) for c in self._cb_pending(idx))
        return max(0, self.size - int(self.buflen[idx]) - pend)

    def _flush_tick_debt(self):
        """Replay deferred idle-block cursor ticks (exactly the per-block
        f32 release math, in order) before any mirror read or write."""
        debt = self._tick_debt
        if not debt:
            return
        self._tick_debt = []
        shape = self.batch if self.batch else ()
        for iv, cnt, times in debt:
            counts = np.broadcast_to(np.int32(cnt), shape)
            for _ in range(times):
                self._tick_math(iv, counts)

    def _cb_pending(self, idx):
        if self.batch == ():
            return self._pending.flat[0]
        return self._pending[idx]

    def _mark_dirty(self, idx):
        self._dirty.add(0 if self.batch == () else int(idx))

    # ring device state is (C*R, 128); the (C, size) view is a free reshape

    @property
    def _rows(self):
        return self.size_pad // 128

    def _own_device_init(self):
        return {
            "ring": jnp.zeros(
                self.batch + (self.channels * self._rows, 128), jnp.float32
            )
        }

    def _own_slot_init(self, i):
        return {
            "ring": np.zeros((self.channels * self._rows, 128), np.float32)
        }

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        # drain producer queues into a fixed-size chunk (Receiver::update);
        # only voices in the dirty set are visited
        V = self.batch[0] if self.batch else 1
        C = self.channels
        self._has_write = bool(self._dirty)
        # one spare column zero-TERMINATES each voice's chunk: the device
        # write also refreshes the boundary lerp cell (get_pair's b at
        # k == len, frames.rs:105-123), so no per-block ring scatter is
        # needed on the read side — a ring-sized write+gather pair in one
        # scan body re-materializes the whole ring every block
        mw = (self.max_write + 1) if self._has_write else 0
        chunk = np.zeros((V, C, mw), np.float32)
        counts = np.zeros(V, np.int32)
        lens = np.atleast_1d(self.buflen).copy()
        for v in sorted(self._dirty):
            q = self._pending.flat[v]
            room = self.max_write
            got = []
            while q and room > 0:
                c = q[0]
                if len(c) <= room:
                    got.append(c)
                    room -= len(c)
                    q.pop(0)
                else:
                    got.append(c[:room])
                    q[0] = c[room:]
                    room = 0
            if got:
                flat = np.concatenate(got).astype(np.float32)  # (k, C)
                chunk[v, :, : len(flat)] = flat.T
                counts[v] = len(flat)
        self._dirty = {v for v in self._dirty if self._pending.flat[v]}
        write_pos = (np.atleast_1d(self.start) + lens) % np.int32(self.size_pad)
        new_len = lens + counts
        self.stopping = self.stopping | self.closed  # stream.rs:76-78

        ds = (interval * self.rate.astype(np.float32)).astype(np.float32)
        params = {
            "t": self.t.copy(),
            "ds": ds,
            "len": new_len.reshape(self.batch).astype(np.int32),
            "start": self.start.copy(),
        }
        if self._has_write:
            params["chunk"] = chunk.reshape(self.batch + (C, mw))
            params["wcount"] = (counts + 1).reshape(self.batch)
            params["wpos"] = write_pos.reshape(self.batch)
        # advance (stream.rs:63-69): next = t + dt*rate, release whole samples
        cnt = np.broadcast_to(f32(n if count is None else count), self.batch)
        nxt = (self.t + (interval * cnt * self.rate.astype(np.float32))).astype(
            np.float32
        )
        lenf = new_len.reshape(self.batch).astype(np.float32)
        tc = np.minimum(nxt, lenf)
        released = np.trunc(tc).astype(np.int32)
        self.t = (tc - released).astype(np.float32)
        self.buflen = (new_len.reshape(self.batch) - released).astype(np.int32)
        self.start = ((self.start + released) % np.int32(self.size_pad)).astype(np.int32)
        return params

    def host_is_finished(self):
        """stream.rs:88-91: stopping && t == len (all drained)."""
        self._flush_tick_debt()
        return self.stopping & (self.t == self.buflen.astype(np.float32))

    def _write_one(self, ring, params):
        """Scatter one voice's newly shipped chunk at its write cursor
        (Receiver::update, stream.rs:24-69); pools vmap it."""
        size = self.size_pad
        flat = ring.reshape(self.channels, size)
        j = jnp.arange(params["chunk"].shape[-1])
        idx = jnp.mod(params["wpos"] + j, size)
        idx = jnp.where(j < params["wcount"], idx, size)  # drop overflow
        flat = flat.at[:, idx].set(params["chunk"], mode="drop")
        return flat.reshape(ring.shape)

    def render(self, dstate, ddata, params, n):
        ring = dstate["ring"]  # (C*R, 128) unbatched (vmapped in pools)
        size = self.size_pad
        if "chunk" in params:
            ring = self._write_one(ring, params)
        flat = ring.reshape(self.channels, size)
        # consumer: lerp read with zero padding (stream.rs:37-61)
        s = params["t"] + params["ds"] * iota_f32(n)
        x0 = jnp.trunc(s).astype(jnp.int32)

        def get(k):
            valid = (k >= 0) & (k < params["len"])
            kk = jnp.mod(params["start"] + jnp.clip(k, 0, size - 1), size)
            return jnp.where(valid[None, :], flat[:, kk], 0.0)

        a = get(x0)
        b = get(x0 + 1)
        out = lerp(a, b, (s - jnp.trunc(s))[None, :])
        return {"ring": ring}, out

    # -- device-resident mode --------------------------------------------------
    # The ring AND its (t, len, start) cursors live on device, advancing
    # in-graph so many-block scans never touch the host; the host keeps
    # f32-exact mirrors (dr_host_tick repeats the device's release math
    # term-for-term) purely for StreamControl.free()'s lower-bound
    # backpressure (stream.rs:99-101).  Producer PCM ships as a per-block
    # ingest param only on blocks with queued writes (the stream analogue
    # of the engines' zero-delta fast path); the write position is derived
    # from the DEVICE cursors, so mirror drift on dead voices is harmless.
    # The ring leaf is NOT part of dr_slot_row (plays would ship it through
    # delta lanes): a fresh row's len=0 gates every read, and ingest
    # zero-terminates each chunk so the boundary lerp cell (get_pair's b at
    # k == len, frames.rs:105-123) never sees a previous tenant's data.

    _dr_ctrl_fields = ("closed",)

    def dr_supported(self):
        return True

    def dr_needs_ingest(self):
        return True

    def dr_state_init(self, V):
        return {
            "ring": np.zeros((V, self.channels * self._rows, 128), np.float32),
            "t": np.zeros(V, np.float32),
            "len": np.zeros(V, np.int32),
            "start": np.zeros(V, np.int32),
            "closed": np.zeros(V, np.float32),
            "rate": np.ones(V, np.float32),
        }

    def dr_slot_row(self, interval):
        return {
            "t": np.float32(self.t[()]),
            "len": np.int32(self.buflen[()]),
            "start": np.int32(self.start[()]),
            "closed": np.float32(bool(self.closed[()]) or bool(self.stopping[()])),
            "rate": np.float32(self.rate[()]),
        }

    def dr_default_row(self, interval):
        return {
            "t": np.float32(0.0),
            "len": np.int32(0),
            "start": np.int32(0),
            "closed": np.float32(1.0),
            "rate": np.float32(1.0),
        }

    def dr_bind_slot(self, i, spec, pool, gen):
        """Adopt a played spec's mirrors + producer queue into this BATCHED
        proto (the pool's host shadow).  Like write_slot, but the pool has
        already marked the spec moved, and the spec's ControlBlock keeps
        its dr routing (mirror reads/writes hit these columns; device
        deltas ride the pool's sparse channels)."""
        self._flush_tick_debt()
        for f in self._host_fields:
            getattr(self, f)[i] = getattr(spec, f)[()]
        cb = getattr(spec, "_cb", None)
        if cb is not None:
            cb.rebind(self, i, pool, gen)
        self._pending[i] = spec._cb.pending
        if self._pending[i]:
            self._dirty.add(int(i))
        else:
            self._dirty.discard(int(i))

    def dr_ingest_params(self):
        """Drain producer queues into a fixed-size ingest chunk, or None on
        write-free blocks.  Each voice's chunk is zero-terminated (one spare
        column) so the device write also refreshes the boundary lerp cell.
        Advances the host ``buflen`` mirrors by the shipped counts."""
        self._flush_tick_debt()
        V = self.batch[0]
        C = self.channels
        self._has_write = bool(self._dirty)
        if not self._has_write:
            return None
        chunk = np.zeros((V, C, self.max_write + 1), np.float32)
        counts = np.zeros(V, np.int32)
        for v in sorted(self._dirty):
            q = self._pending[v]
            room = self.max_write
            got = []
            while q and room > 0:
                c = q[0]
                if len(c) <= room:
                    got.append(c)
                    room -= len(c)
                    q.pop(0)
                else:
                    got.append(c[:room])
                    q[0] = c[room:]
                    room = 0
            if got:
                flat = np.concatenate(got).astype(np.float32)  # (k, C)
                chunk[v, :, : len(flat)] = flat.T
                counts[v] = len(flat)
        self._dirty = {v for v in self._dirty if self._pending[v]}
        self.buflen = (self.buflen + counts).astype(np.int32)
        return {"chunk": chunk, "wcount": counts}

    def dr_host_tick(self, interval, counts):
        """Advance the (t, buflen, start) mirrors by ``counts`` frames —
        the host shadow of dr_render's in-graph release (term-for-term the
        f32 math of host_prepare).  A SCALAR ``counts`` marks a uniform
        write-free idle tick: it is deferred (O(1) debt merge) and replayed
        exactly at the first mirror read — idle pool blocks then cost no
        numpy work at all."""
        if np.ndim(counts) == 0:
            self.tick_debt_add(interval, counts, 1)
            return
        self._flush_tick_debt()
        self._tick_math(interval, counts)

    def tick_debt_add(self, interval, count, times):
        """Queue ``times`` deferred uniform ticks (bulk idle runs)."""
        iv, cnt = float(interval), int(count)
        debt = self._tick_debt
        if debt and debt[-1][0] == iv and debt[-1][1] == cnt:
            debt[-1][2] += times
        else:
            debt.append([iv, cnt, times])

    def _tick_math(self, interval, counts):
        self.stopping = self.stopping | self.closed
        interval = np.float32(interval)
        cnt = counts.astype(np.float32)
        nxt = (self.t + (interval * cnt * self.rate.astype(np.float32))).astype(
            np.float32
        )
        lenf = self.buflen.astype(np.float32)
        tc = np.minimum(nxt, lenf)
        released = np.trunc(tc).astype(np.int32)
        self.t = (tc - released).astype(np.float32)
        self.buflen = (self.buflen - released).astype(np.int32)
        self.start = ((self.start + released) % np.int32(self.size_pad)).astype(
            np.int32
        )

    def dr_ingest(self, state, ing):
        """In-graph Receiver::update: place each voice's shipped chunk at its
        DEVICE write cursor (start + len) and grow len."""
        import jax

        wpos = jnp.mod(state["len"] + state["start"], np.int32(self.size_pad))
        params = {
            "chunk": ing["chunk"],
            "wcount": ing["wcount"] + 1,  # zero-termination column
            "wpos": wpos,
        }
        ring = jax.vmap(self._write_one)(state["ring"], params)
        out = dict(state)
        out["ring"] = ring
        out["len"] = state["len"] + ing["wcount"]
        return out

    def dr_render(self, state, ddata, interval, n, count):
        import jax

        params = {
            "t": state["t"],
            "ds": np.float32(interval) * state["rate"],
            "len": state["len"],
            "start": state["start"],
        }
        _, samp = jax.vmap(lambda d, p: self.render(d, ddata, p, n))(
            {"ring": state["ring"]}, params
        )
        out = dict(state)
        # release consumed whole samples (stream.rs:63-69), mirrored by
        # dr_host_tick on the host
        cf = count.astype(jnp.float32)
        nxt = state["t"] + (np.float32(interval) * cf) * state["rate"]
        lenf = state["len"].astype(jnp.float32)
        tc = jnp.minimum(nxt, lenf)
        released = jnp.trunc(tc).astype(jnp.int32)
        out["t"] = tc - released.astype(jnp.float32)
        out["len"] = state["len"] - released
        out["start"] = jnp.mod(
            state["start"] + released, np.int32(self.size_pad)
        )
        if self.channels == 1:
            samp = samp[:, 0, :]
        return out, samp

    def dr_is_finished(self, state):
        """stream.rs:88-91: closed && drained."""
        return (state["closed"] > 0.5) & (
            state["t"] >= state["len"].astype(jnp.float32)
        )


class StreamControl:
    """Thread-safe control for a Stream (stream.rs:96-112)."""

    def __init__(self, cb):
        self._cb = cb

    def free(self):
        """Lower bound on frames the next write will consume (stream.rs:99-101)."""
        if not self._cb.live():
            return 0
        return self._cb.sig._free_space(self._cb.idx)

    def write(self, samples):
        """Add frames; returns the number consumed (stream.rs:103-110).
        Accepts (k,) mono or (k, C) frame arrays."""
        if not self._cb.live():
            return 0
        sig = self._cb.sig
        samples = f32(np.atleast_1d(samples))
        if samples.ndim == 1:
            samples = samples[:, None]
        if samples.shape[1] != sig.channels:
            raise ValueError(
                f"stream carries {sig.channels}-channel frames, "
                f"got {samples.shape[1]}"
            )
        take = min(len(samples), self.free())
        if take:
            q = sig._cb_pending(self._cb.idx)
            q.append(np.array(samples[:take], np.float32))
            sig._mark_dirty(self._cb.idx)
        return take

    def close(self):
        """Signal that no further samples will arrive (the sender-drop of
        stream.rs:76-78); playback finishes once the buffer drains."""
        self._cb.set("closed", True)
