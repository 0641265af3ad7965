"""Block-render drivers.

Reference: /root/reference/src/lib.rs:90-93 — ``run(signal, rate, out)``
computes ``interval = 1/rate`` and pulls one block from the signal graph on
the audio thread.

Batch redesign: a ``Renderer`` owns the jitted step for a signal graph.  Per
block it (1) walks the graph on the host, advancing host state and producing
per-block parameter arrays (the control-plane handoff), then (2) dispatches
one jitted, donated device step.  For offline rendering, ``render_frames``
precomputes many blocks' parameters and runs a single ``lax.scan`` on device,
amortising dispatch overhead — the batch analogue of oddio's tight offline loop
(examples/offline.rs:33-43).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .hostmath import f32

__all__ = ["Renderer", "run"]


def _stack_params(params_list):
    return jax.tree.map(lambda *xs: np.stack(xs), *params_list)


# -- single-buffer parameter upload -------------------------------------------
# The reference's control plane hands the audio thread a handful of atomics
# per block; this harness's analogue is the per-block parameter pytree.  A
# delta block's tree has dozens of small leaves (motion arrays, padded play
# rows, ctrl lanes) and each leaf is a separate host->device transfer whose
# fixed per-transfer overhead dominates the bytes.  The Renderer therefore ships ONE contiguous f32 buffer per dispatch
# and the jitted step unpacks it with static slices/bitcasts (free after XLA
# fusion).  swap.rs:36-48 semantics are preserved: latest value per block,
# bulk-delivered.


def _pack_spec(params):
    """(treedef, ((shape, dtype-str), ...)) for a params pytree, or None
    when a leaf dtype has no f32 bit-packing (falls back to raw leaves)."""
    leaves, treedef = jax.tree.flatten(params)
    spec = []
    for l in leaves:
        a = np.asarray(l)
        if a.dtype == np.float32 or a.dtype == np.bool_:
            pass
        elif a.dtype.kind in "iu" and a.dtype.itemsize <= 8:
            pass
        else:
            return None
        spec.append((a.shape, a.dtype.str))
    return treedef, tuple(spec)


def _pack_row(params):
    """Flatten one block's params into a single f32 vector (bitwise for
    ints, 0/1 for bools)."""
    parts = []
    for l in jax.tree.leaves(params):
        a = np.asarray(l)
        if a.dtype == np.float32:
            parts.append(a.ravel())
        elif a.dtype == np.bool_:
            parts.append(a.astype(np.float32).ravel())
        else:  # integer: 32-bit bit-pattern (indices/counts all fit)
            parts.append(
                np.ascontiguousarray(a.astype(np.int32).ravel()).view(
                    np.float32
                )
            )
    if not parts:
        return np.zeros(0, np.float32)
    return np.concatenate(parts)


def _unpack_row(buf, treedef, spec):
    """Traced inverse of _pack_row: static slices + bitcasts."""
    out = []
    off = 0
    for shape, dstr in spec:
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        x = jax.lax.slice(buf, (off,), (off + size,))
        dt = np.dtype(dstr)
        if dt.kind in "iu":
            x = jax.lax.bitcast_convert_type(x, jnp.int32)
        elif dt == np.bool_:
            x = x > 0.5
        out.append(x.reshape(shape))
        off += size
    return jax.tree.unflatten(treedef, out)


#: minimum idle-run length before the fused multi-block dispatch engages:
#: each distinct group count compiles its own scan program (the length is
#: static), so short runs — warmups, tick remainders — stay on the
#: per-block path and the multi program set tracks the bucket sizes only.
MULTI_MIN_BLOCKS = 16


class Renderer:
    def __init__(self, signal, rate, sync_every=16, scan_unroll=1,
                 scan_buckets=None):
        if signal._moved:
            raise RuntimeError("signal was moved into an engine; render the engine")
        self.signal = signal
        self.rate = int(rate)
        # lib.rs:91: interval = 1.0 / sample_rate as f32
        self.interval = np.float32(1.0) / np.float32(self.rate)
        #: blocks unrolled per on-device scan iteration: >1 amortizes
        #: per-op fixed costs across blocks for small scenes (identical
        #: semantics; XLA unrolls the loop body)
        self.scan_unroll = int(scan_unroll)
        #: optional descending dispatch-size quantization, e.g.
        #: (188, 47, 12, 3, 1): equal-archetype runs split greedily into
        #: these scan lengths so the set of compiled programs stays BOUNDED
        #: when control deltas cut dispatches at arbitrary points (a live
        #: scene otherwise compiles a fresh scan program per remainder
        #: length — minutes each through a remote-compile service).  None =
        #: one scan per run (offline/tests).
        self.scan_buckets = (
            tuple(sorted(scan_buckets, reverse=True)) if scan_buckets else None
        )
        # jitted steps keyed by (archetype, kind); archetype includes any
        # trace-relevant statics updated by host_prepare (e.g. ring write
        # bounds), so steps are resolved AFTER preparing the block.
        self._steps = {}
        #: device-resident engines sync handle-visible state (is_finished,
        #: slot reclamation) every `sync_every` render_block calls — the
        #: block-streaming analogue of the reference's per-sample stop-flag
        #: visibility (mixer.rs:102-105, spatial.rs:241-261).  The copy is
        #: prefetched one block early so the readback overlaps rendering.
        self.sync_every = int(sync_every)
        self._since_sync = 0

    def _get_step(self, kind, arch=None, pack=None):
        """``pack``: (treedef, spec) when params ship as one packed buffer
        (see _pack_row), or None for raw pytree params (fallback for leaf
        dtypes the packer does not cover)."""
        key = (arch if arch is not None else self.signal.archetype(), kind,
               pack)
        step = self._steps.get(key)
        if step is None:
            sig = self.signal
            if isinstance(kind, tuple) and kind[0] == "multi":

                def step_fn(dstate, ddata, n, nb, groups):
                    def body(d, _):
                        return sig.render_multi(d, ddata, n, nb)

                    return jax.lax.scan(body, dstate, None, length=groups)

                step = jax.jit(
                    step_fn, static_argnums=(2, 3, 4), donate_argnums=0
                )
                self._steps[key] = step
                return step
            if kind == "single":

                def step_fn(dstate, ddata, params, n):
                    if pack is not None:
                        params = _unpack_row(params, *pack)
                    return sig.render(dstate, ddata, params, n)

                step = jax.jit(step_fn, static_argnums=3, donate_argnums=0)
                self._steps[key] = step
                return step
            else:

                unroll = self.scan_unroll

                def step_fn(dstate, ddata, stacked, n, nblocks):
                    def body(d, p):
                        if pack is not None:
                            p = _unpack_row(p, *pack)
                        return sig.render(d, ddata, p, n)

                    # length is explicit: an all-idle run of a fully
                    # device-resident graph carries no per-block params
                    return jax.lax.scan(
                        body, dstate, stacked, length=nblocks,
                        unroll=min(unroll, max(nblocks, 1)),
                    )

            step = jax.jit(step_fn, static_argnums=(3, 4), donate_argnums=0)
            self._steps[key] = step
        return step

    def render_block(self, n, interval=None):
        """Render one block of ``n`` frames; returns float32 (n, C)."""
        sig = self.signal
        params = sig.host_prepare(self.interval if interval is None else f32(interval), n)
        pack = _pack_spec(params)
        if pack is not None:
            params = _pack_row(params)
        step = self._get_step("single", sig.archetype(), pack)
        d2, block = step(sig.device_collect(), sig.device_data(), params, n)
        sig.device_store(d2)
        sync = getattr(sig, "sync", None)
        if sync is not None and self.sync_every > 0:
            self._since_sync += 1
            if self._since_sync == self.sync_every - 1:
                prefetch = getattr(sig, "sync_prefetch", None)
                if prefetch is not None:
                    prefetch()
            elif self._since_sync >= self.sync_every:
                sync()
                self._since_sync = 0
        return np.asarray(block).T

    def _run_blocks(self, nblocks, block_size, consume):
        """Prepare + dispatch ``nblocks`` blocks, batching runs of equal
        archetype into on-device scans.  A segment is flushed (dispatched)
        BEFORE any prepare that will mutate the signal graph's python
        structure (``host_structure_event``), so every step is traced
        against the structure that produced its parameters — Faders swap
        children and DR pools bulk-apply plays during host_prepare, and a
        deferred trace would otherwise see the mutated graph."""
        sig = self.signal
        pend = []  # params of the current equal-archetype run
        pend_arch = None

        def flush():
            nonlocal pend, pend_arch
            if not pend:
                return
            if self.scan_buckets and len(pend) > 1:
                segs, i = [], 0
                while i < len(pend):
                    for b in self.scan_buckets:
                        if b <= len(pend) - i:
                            segs.append(pend[i : i + b])
                            i += b
                            break
                    else:  # no bucket fits (buckets lack 1): take the rest
                        segs.append(pend[i:])
                        i = len(pend)
            else:
                segs = [pend]
            arch = pend_arch
            pend, pend_arch = [], None
            for seg in segs:
                _dispatch(seg, arch)

        def _dispatch(pend, pend_arch):
            # fused multi-block groups: an idle (param-free) run on a
            # signal that advertises host_multiblock dispatches as scans
            # whose body renders nb blocks in one traced group; the
            # remainder takes the normal path.  Group counts follow the bucket-quantized segment
            # lengths, so the compiled-program set stays bounded.
            mb = getattr(sig, "host_multiblock", None)
            if (
                mb is not None and len(pend) >= MULTI_MIN_BLOCKS
                and not jax.tree.leaves(pend[0])
            ):
                nb = mb(self.interval, block_size)
                if nb >= 2 and len(pend) >= nb:
                    groups = len(pend) // nb
                    step = self._get_step(("multi", nb), pend_arch, None)
                    d2, blocks = step(
                        sig.device_collect(), sig.device_data(),
                        block_size, nb, groups,
                    )
                    sig.device_store(d2)
                    consume(blocks)  # (groups, C, nb*block_size)
                    pend = pend[groups * nb :]
                    if not pend:
                        return
            pack = _pack_spec(pend[0])
            if len(pend) == 1:
                step = self._get_step("single", pend_arch, pack)
                p = _pack_row(pend[0]) if pack is not None else pend[0]
                d2, block = step(
                    sig.device_collect(), sig.device_data(), p, block_size
                )
                blocks = block[None]
            else:
                step = self._get_step("scan", pend_arch, pack)
                if pack is not None:
                    stacked = np.stack([_pack_row(p) for p in pend])
                else:
                    stacked = _stack_params(pend)
                d2, blocks = step(
                    sig.device_collect(), sig.device_data(),
                    stacked, block_size, len(pend),
                )
            sig.device_store(d2)
            consume(blocks)
            pend, pend_arch = [], None

        event = getattr(sig, "host_structure_event", None)
        bulk = getattr(sig, "host_idle_bulk", None)
        for bi in range(nblocks):
            if pend and event is not None and event():
                flush()
            p = sig.host_prepare(self.interval, block_size)
            a = sig.archetype()
            if pend and a != pend_arch:
                flush()
            pend.append(p)
            pend_arch = a
            # run-length idle fast path: a block that prepared EMPTY params
            # on an engine whose pools all pass the idle gate proves every
            # remaining block of this call is identical (the host is
            # single-threaded: no control traffic can arrive mid-call) —
            # advance them in O(1) instead of per-block Python
            remaining = nblocks - bi - 1
            if (remaining and bulk is not None and not jax.tree.leaves(p)
                    and bulk(self.interval, block_size, remaining)):
                pend.extend([p] * remaining)
                break
        flush()

    def render_frames(self, total, block_size=512):
        """Offline render of ``total`` frames in fixed blocks via on-device
        scans; returns float32 (total, C)."""
        nblocks, rem = divmod(total, block_size)
        pieces = []

        def consume(blocks):
            out = np.asarray(blocks)  # (B, C, n) — n may be a fused
            # multi-block group's nb*block_size
            pieces.append(
                np.moveaxis(out, 1, 2).reshape(
                    out.shape[0] * out.shape[2], out.shape[1]
                )
            )

        if nblocks:
            self._run_blocks(nblocks, block_size, consume)
        if rem:
            pieces.append(self.render_block(rem))
        # device-resident engines sync handle-visible state once per batch
        sync = getattr(self.signal, "sync", None)
        if sync is not None:
            sync()
            self._since_sync = 0
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)

    def render_frames_device(self, total, block_size=512, sync=True):
        """Offline render of ``total`` frames (a multiple of ``block_size``)
        that keeps the audio on device: returns a list of (B, C, n) device
        arrays, one per scan run, without any host transfer or blocking.

        For device-side consumers — digests, further on-device processing,
        throughput measurement — where pulling the full PCM to the host per
        call would serialize the pipeline.  Pass ``sync=False`` to also skip
        the handle-state sync (call ``signal.sync()`` yourself later)."""
        nblocks, rem = divmod(total, block_size)
        if rem:
            raise ValueError("total must be a multiple of block_size")
        out = []
        self._run_blocks(nblocks, block_size, out.append)
        if sync:
            do_sync = getattr(self.signal, "sync", None)
            if do_sync is not None:
                do_sync()
                self._since_sync = 0
        return out


def run(signal, sample_rate, n):
    """Populate and return an (n, C) float32 block from ``signal`` —
    convenience mirroring oddio::run (lib.rs:90-93).  Keeps a Renderer cached
    on the signal so repeated calls stream correctly."""
    key = "_renderer_%d" % int(sample_rate)
    r = getattr(signal, key, None)
    if r is None:
        r = Renderer(signal, sample_rate)
        setattr(signal, key, r)
    return r.render_block(n)
