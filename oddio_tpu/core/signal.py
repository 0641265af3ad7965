"""The core Signal protocol, redesigned for batch rendering on an accelerator.

Reference: /root/reference/src/signal.rs:14-28 defines oddio's pull-based
``Signal`` trait (``sample(&mut self, interval, out)``), with combinators
wrapping each other and a lock-free control plane mutating parameters from
another thread.

Batch redesign (see SURVEY.md §7): a Signal here is a *template* with three
separated aspects:

* **host state** — small numpy arrays (shape = ``batch``), e.g. f64 playback
  cursors, smoothing ramps, phases.  Advanced once per block by
  ``host_prepare`` using the exact reference arithmetic (f64 cursors from
  frames.rs:143-149, f32 ramps from smooth.rs), producing a pytree of
  per-block parameter arrays.  This *is* the control plane: control handles
  write host values that take effect at the next block boundary, exactly like
  oddio's atomics/swap channels are observed once per ``sample`` call.
* **device state** — jnp arrays for data-plane state that must live on the
  device (delay rings, stream buffers, AGC accumulators).
* **render** — a pure JAX function ``(dstate, ddata, params, n) -> (dstate',
  block)`` over fixed-size frame blocks, written unbatched and ``vmap``-ed
  over the voice axis by engine pools.  Blocks are channels-first ``(C, n)``
  so the frame axis is the minor (contiguous) axis.

``Seek`` (signal.rs:48-58) maps to ``seekable`` signals which additionally
expose a *pure* ``host_params_at`` (parameters for a time-shifted, rate-warped
read that does not advance state) plus ``host_seek`` — the pair the spatial
scene's per-ear doppler resampling needs (spatial.rs:438-470).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Signal", "ControlBlock", "arch_of"]


class ControlBlock:
    """Routes control-handle writes to wherever a signal's host state lives.

    Replaces oddio's per-filter cross-thread cells (``Arc<AtomicU32>`` in
    gain.rs:58-93, ``swap`` channels in spatial.rs:93-116): a handle writes a
    value; the signal observes it at its next block. When a signal is played
    into an engine pool its host state is copied into the pool's column
    arrays and the ControlBlock is rebound to (pool signal, slot); a slot
    generation counter makes writes through stale handles harmless no-ops
    (mirroring oddio, where writes to a dropped voice's atomics go nowhere).
    """

    def __init__(self, sig):
        self.sig = sig
        self.idx = ()  # () indexes the 0-d arrays of a standalone signal
        self.pool = None
        self.gen = 0
        self._dr = None  # (pool, slot, gen, path) when in a DR pool

    def rebind(self, sig, idx, pool, gen):
        self.sig = sig
        self.idx = idx
        self.pool = pool
        self.gen = gen

    def rebind_dr(self, pool, slot, gen, path):
        """Route writes into a device-resident pool as sparse control deltas
        (the batch analogue of the reference's shared atomics): the spec's own
        host field doubles as the handle-readable mirror."""
        self._dr = (pool, slot, gen, path)

    def live(self):
        if self._dr is not None:
            pool, slot, gen, _ = self._dr
            return pool.slot_gen[slot] == gen
        return self.pool is None or self.pool.slot_gen[self.idx] == self.gen

    def _flush_sig(self):
        # signals with deferred idle-tick mirror debt (Stream pools) must
        # replay it before any handle read/write of their host fields
        flush = getattr(self.sig, "_flush_tick_debt", None)
        if flush is not None:
            flush()

    def set(self, field, value):
        self._flush_sig()
        if self._dr is not None:
            pool, slot, gen, path = self._dr
            # the mirror is the spec's own (per-handle) host field, so it is
            # always writable — like the reference's orphaned Arc'd atomics
            # (gain.rs:130-139): set-after-death still updates what get()
            # reads back.  Only the device delta is skipped when stale.
            getattr(self.sig, field)[self.idx] = value  # handle mirror
            if pool.slot_gen[slot] == gen:
                pool.push_ctrl(path, field, slot, value)
            return
        if self.live():
            getattr(self.sig, field)[self.idx] = value

    def get(self, field, default=None):
        self._flush_sig()
        if self._dr is not None:
            # last-written value survives voice death, like the reference's
            # Arc'd atomics (gain.rs:130-139)
            return getattr(self.sig, field)[self.idx]
        if self.live():
            return getattr(self.sig, field)[self.idx]
        return default


def arch_of(sig):
    return sig.archetype()


class Signal:
    """Base class for all signal templates."""

    #: number of output channels (1 = mono)
    channels = 1
    #: whether the signal supports deterministic time-shifted evaluation
    #: (oddio's ``Seek``, signal.rs:48-58)
    seekable = False

    def __init__(self):
        self.batch = ()
        self._moved = False  # set when played into an engine (Rust move semantics)
        self._dev = None  # this node's own device-state leaves

    # -- structure ---------------------------------------------------------

    def children(self):
        """Ordered mapping name -> child Signal."""
        return {}

    def _arch_extra(self):
        """Static (trace-relevant) config beyond channels, e.g. buffer sizes."""
        return ()

    def archetype(self):
        """Hashable structural key; equal archetypes can share a pool/jit."""
        kids = tuple((k, c.archetype()) for k, c in self.children().items())
        return (type(self).__qualname__, self.channels, self._arch_extra(), kids)

    def host_batchable(self):
        """Whether this chain can stack into a multi-voice pool (dense
        batched state).  Engines themselves (Mixer, SpatialScene) cannot —
        played as voices (submixes), they get a singleton pool instead
        (the reference boxes any Signal, mixer.rs:18-26,
        spatial.rs:314-340)."""
        return all(c.host_batchable() for c in self.children().values())

    # -- host state lifecycle -----------------------------------------------

    #: names of numpy host-state attributes, each shaped ``batch + extra``
    _host_fields = ()

    def _alloc_host(self, batch):
        """Allocate default host-state arrays for ``batch``. Per-class."""
        raise NotImplementedError

    def clone_batched(self, V):
        """Build a batched (pool) template with the same structure."""
        new = object.__new__(type(self))
        Signal.__init__(new)
        new.batch = (V,)
        new.channels = self.channels
        new._copy_static_from(self)
        new._alloc_host((V,))
        for k, c in self.children().items():
            setattr(new, k, c.clone_batched(V))
        return new

    def _copy_static_from(self, other):
        """Copy static (archetype-level) config when cloning. Per-class."""
        pass

    def write_slot(self, i, spec, pool, gen):
        """Copy ``spec``'s (batch=()) host state into slot ``i`` and rebind
        its controls. Mirrors oddio's move of the signal into the Set."""
        if spec._moved:
            raise RuntimeError("signal was already played (moved); construct a new one")
        spec._moved = True  # recursion marks every node, incl. shared inners
        for f in self._host_fields:
            getattr(self, f)[i] = getattr(spec, f)[()] if getattr(spec, f).ndim == 0 else getattr(spec, f)
        self._rebind_controls(spec, i, pool, gen)
        for (k, mine), theirs in zip(self.children().items(), spec.children().values()):
            mine.write_slot(i, theirs, pool, gen)

    def _rebind_controls(self, spec, i, pool, gen):
        cb = getattr(spec, "_cb", None)
        if cb is not None:
            cb.rebind(self, i, pool, gen)

    # -- host per-block protocol ---------------------------------------------

    def host_prepare(self, interval, n, count=None):
        """Compute per-block device parameters and advance host state.

        ``interval`` is an f32 array broadcastable to ``batch`` (seconds per
        frame; may vary per voice under Speed).  ``count`` optionally gives
        the number of frames actually consumed per voice (< n), used by the
        spatial delay-ring writer whose per-voice write counts vary by one
        (ring.rs:18-41); state must advance by ``count`` frames only.
        Returns a pytree (dict) of numpy arrays shaped ``batch + (...)``.
        """
        return {}

    def host_params_at(self, tshift, interval, n):
        """Pure variant for Seek-path reads: parameters for sampling with the
        start time shifted by ``tshift`` seconds at ``interval`` seconds per
        frame, WITHOUT advancing host state. Only for ``seekable`` signals."""
        raise NotImplementedError(f"{type(self).__name__} is not seekable")

    def host_seek(self, seconds):
        """Shift the playback cursor (signal.rs:48-51). Host-state mutation."""
        raise NotImplementedError(f"{type(self).__name__} is not seekable")

    def seek(self, seconds):
        """Public Seek API (signal.rs:48-58): shift the starting point of the
        next block by ``seconds``.  Only for ``seekable`` signals."""
        if not self.seekable:
            raise NotImplementedError(f"{type(self).__name__} is not seekable")
        self.host_seek(seconds)

    def host_is_finished(self):
        """Per-voice finished flags (signal.rs:21-27), computed from host state."""
        return np.zeros(self.batch, dtype=bool)

    def host_structure_event(self):
        """True when the NEXT host_prepare will mutate python graph
        structure or apply state eagerly outside the jitted step (Fader
        swaps, bulk play application).  Block-batching renderers must
        dispatch already-prepared blocks first (core/run.py)."""
        return any(c.host_structure_event() for c in self.children().values())

    def params_voice_axes(self, params):
        """Pytree of bools: True where a param leaf has a leading voice axis
        (shardable over the voice mesh axis); sparse delta leaves are False."""
        import jax

        return jax.tree.map(lambda _: True, params)

    # -- device state ---------------------------------------------------------
    # Each node *owns* its device-state leaves (rings, accumulators) in
    # ``self._dev``; collect/store assemble the nested pytree for the jitted
    # step.  Engines reset rows in a node's own leaves when reusing a slot.

    def _own_device_init(self):
        """This node's own device-state leaves (jnp, shapes include batch)."""
        return {}

    def _own_slot_init(self, i):
        """Numpy row values to reset this node's own leaves for slot ``i``."""
        return {}

    def _own_device_data(self):
        """This node's read-only shared device arrays (e.g. sample arenas)."""
        return {}

    def device_collect(self):
        if self._dev is None:
            self._dev = self._own_device_init()
        d = dict(self._dev)
        for k, c in self.children().items():
            # always include children (even empty) so the carry pytree
            # structure matches render outputs exactly
            d[k] = c.device_collect()
        return d

    def device_store(self, d):
        kids = self.children()
        self._dev = {k: v for k, v in d.items() if k not in kids}
        for k, c in kids.items():
            if k in d:
                c.device_store(d[k])

    def device_reset_slot(self, i):
        """Reset device state for pool slot ``i`` after a new play()."""
        if self._dev is None:
            self._dev = self._own_device_init()
        rows = self._own_slot_init(i)
        if rows:
            self._dev = {
                k: (v.at[i].set(rows[k]) if k in rows else v)
                for k, v in self._dev.items()
            }
        for c in self.children().values():
            c.device_reset_slot(i)

    def device_data(self):
        """Read-only device arrays shared across blocks (e.g. sample arenas).
        Passed to render separately so multi-block scans don't stack them."""
        d = dict(self._own_device_data())
        for k, c in self.children().items():
            sub = c.device_data()
            if sub:
                d[k] = sub
        return d

    def grow_batched(self, new_V):
        """Grow this batched template's capacity in place (the analogue of
        oddio's set-realloc protocol, set.rs:57-63): host columns and device
        leaves are extended; existing ControlBlocks stay valid because they
        reference the signal object, not the arrays."""
        old_V = self.batch[0]
        add = new_V - old_V
        fresh = self.clone_batched(add)
        for f in self._host_fields:
            setattr(self, f, np.concatenate([getattr(self, f), getattr(fresh, f)]))
        if self._dev is not None:
            import jax.numpy as jnp

            fresh_dev = fresh._own_device_init()
            self._dev = {
                k: jnp.concatenate([v, fresh_dev[k]]) for k, v in self._dev.items()
            }
        for (k, c), fc in zip(self.children().items(), fresh.children().values()):
            c.grow_batched(new_V)
        self.batch = (new_V,)

    # -- device-resident (dr) mode ---------------------------------------------
    # Sources whose entire state can live on the device implement these; engines
    # then run the whole control plane in-graph, with the host shipping only
    # sparse control deltas.  Round-1 scope: chains that are static after
    # play() (sources + fixed filters).  ``state`` pytrees are batched (V,...).

    #: host-field names a control handle may write while the signal lives in
    #: a device-resident pool; each maps to a same-named leaf of this node's
    #: dr state, updated via sparse control deltas (core/drctrl.py)
    _dr_ctrl_fields = ()

    #: subset of _dr_ctrl_fields whose writes change the interval the
    #: chain's inner nodes see (speed.rs); DR pools watching these
    #: re-derive their AGC bound (host_ema_bound)
    _dr_interval_fields = ()

    def host_ema_bound(self, interval):
        """Upper bound on interval/tau over any Adapt in this chain, given
        the chain's current control mirrors; DR pools use it to gate the
        closed-form AGC (ops/adapt.py::ema_gain_closed) vs the
        associative-scan fallback."""
        return max(
            (c.host_ema_bound(interval) for c in self.children().values()),
            default=0.0,
        )

    def dr_supported(self):
        return False

    def dr_needs_ingest(self):
        """Whether this chain needs a per-block host->device data channel
        while device-resident (Stream PCM ingest)."""
        return any(c.dr_needs_ingest() for c in self.children().values())

    #: True on wrappers whose ``dr_render`` passes (interval, n, count)
    #: UNCHANGED to a single, structurally fixed child — the condition for
    #: routing a pool's ingest channel THROUGH the node (Gain/FixedGain/
    #: Adapt/Reinhard/Tanh/MonoToStereo/Downmix).  False on Speed (warps the
    #: inner timebase, which would desync the host cursor mirrors that back
    #: StreamControl.free()'s backpressure) and Fader (bank swaps change
    #: which subtree the leaf lives in).
    _dr_ingest_transparent = False

    def dr_ingest_ok(self):
        """True when a DR pool may accept this chain WITH its ingest
        channel: at most one ingest-needing subtree, every wrapper on the
        path to it interval-preserving and structurally fixed.  The
        reference composes Stream under any filter (stream.rs:6,
        gain.rs:58-127); chains this predicate rejects (Speed/Fader over a
        Stream) keep the host-pool path."""
        ing = [c for c in self.children().values() if c.dr_needs_ingest()]
        if not ing:
            return True
        return (
            len(ing) == 1
            and self._dr_ingest_transparent
            and ing[0].dr_ingest_ok()
        )

    # Ingest plumbing: pools call these on the BATCHED proto chain; the
    # generic forms route through transparent wrappers to the Stream leaf
    # (which overrides them with the real channel logic).

    def dr_ingest_params(self):
        """Drain producer queues into this block's ingest chunk (or None)."""
        for c in self.children().values():
            if c.dr_needs_ingest():
                return c.dr_ingest_params()
        return None

    def dr_host_tick(self, interval, counts):
        """Advance host cursor mirrors by ``counts`` consumed frames."""
        for c in self.children().values():
            if c.dr_needs_ingest():
                c.dr_host_tick(interval, counts)

    def dr_ingest(self, state, ing):
        """In-graph ingest: scatter the shipped chunk at the leaf's device
        write cursors, routed through the chain's state tree."""
        out = dict(state)
        for k, c in self.children().items():
            if c.dr_needs_ingest():
                out[k] = c.dr_ingest(state[k], ing)
        return out

    def dr_bind_slot(self, i, spec, pool, gen):
        """Adopt a played spec's host mirrors into slot ``i`` of this
        BATCHED proto chain (ingest pools keep a host shadow of the stream
        cursors + producer queues).  Wrappers recurse; the Stream leaf
        overrides with the real mirror adoption."""
        for (k, mine), theirs in zip(
            self.children().items(), spec.children().values()
        ):
            mine.dr_bind_slot(i, theirs, pool, gen)

    def dr_state_init(self, V):
        """Benign default device state for V slots (numpy pytree)."""
        raise NotImplementedError

    def dr_slot_row(self, interval):
        """Row values (numpy pytree, unbatched) encoding THIS spec's current
        host state for a play() into a dr pool sampled at ``interval``.
        May be a strict SUBTREE of ``dr_state_init``'s keys: leaves omitted
        from rows (e.g. a stream's ring buffer) are left in place on the
        device and must be gated by the row's cursor fields."""
        raise NotImplementedError

    def dr_default_row(self, interval):
        """Benign padding row for unfilled play/fade delta lanes — same tree
        structure as ``dr_slot_row``.  Chains recurse per child so leaf
        overrides (e.g. Stream, whose slot rows omit the ring leaf and must
        pad closed=1) keep the row tree stackable with real slot rows."""
        import jax

        kids = self.children()
        row = {
            k: jax.tree.map(lambda x: np.asarray(x[0]), v)
            for k, v in self.dr_state_init(1).items()
            if k not in kids
        }
        for k, c in kids.items():
            row[k] = c.dr_default_row(interval)
        return row

    def dr_render(self, state, ddata, interval, n, count):
        """Batched pure render: (state', samples (V, n)) advancing each voice
        by ``count`` (V,) frames at static ``interval`` seconds/frame."""
        raise NotImplementedError

    def dr_is_finished(self, state):
        import jax.numpy as jnp

        leaf = next(iter(state.values())) if state else None
        V = leaf.shape[0] if leaf is not None else 0
        return jnp.zeros((V,), dtype=bool)

    # -- device-resident Seek mode ----------------------------------------------
    # The spatial seek path (spatial.rs:438-470) samples a deterministic
    # source at per-ear time-shifted, rate-warped positions and then advances
    # it by the block's real elapsed time.  Sources whose samples are a pure
    # function of position implement these; the DR seek pool then needs no
    # delay ring at all — per block it is pure elementwise math.

    def dr_seek_supported(self):
        return False

    def dr_warp_render(self, state, ddata, t0, dt, n):
        """Pure positional render for the DR seek path: sample ``n`` frames at
        source times ``cursor + t0 + j*dt`` seconds, for each of E reads
        (``t0``, ``dt`` shaped (V, E)).  Returns samples (V, E, n).  Does NOT
        advance ``state`` — the seek path's paired seeks (spatial.rs:459-466)
        restore the cursor; only ``dr_advance`` moves it."""
        raise NotImplementedError

    def dr_advance(self, state, seconds):
        """Advance playback cursors by scalar ``seconds`` — the DR analogue of
        the end-of-block ``seek(elapsed)`` (spatial.rs:468)."""
        return state

    # -- device render ---------------------------------------------------------

    def render(self, dstate, ddata, params, n):
        """Pure JAX function: returns ``(dstate', block)`` with block ``(C, n)``
        f32 (channels-first so frames are the minor axis). Must be traceable
        under jit and vmap; ``n`` is static."""
        raise NotImplementedError
