"""Sharded multi-scene rendering via shard_map over a (scene, voice) mesh.

Design (SURVEY.md §5/§7): every engine pool's host params and device state
carry a leading voice axis, and a pack of same-archetype scenes stacks a
scene axis in front of that.  The jitted step then runs under ``shard_map``
with every leaf partitioned ``P(scene, voice)``; per-voice work (source
render, ring scatter/gather, gain ramps) needs no communication, and the
masked mix reduction finishes with one ``psum`` over the voice axis — the
only collective in the engine.  Scenes are pure data parallelism.

The host control plane stays per-scene: each scene keeps its own handles and
numpy state; per block the pack stacks their parameter pytrees (cheap numpy)
and dispatches one donated device step.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .mesh import SCENE_AXIS, VOICE_AXIS

__all__ = ["ScenePack"]


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


class ScenePack:
    """Renders S structurally identical scenes as one sharded device step.

    ``scenes``: list of Signals with equal archetype (e.g. SpatialScene or
    Mixer instances configured identically).  ``mesh``: a Mesh with
    (SCENE_AXIS, VOICE_AXIS); S must divide by the scene-axis size and every
    pool capacity by the voice-axis size.
    """

    def __init__(self, scenes, rate, mesh, scan_unroll=1):
        archs = {s.archetype() for s in scenes}
        if len(archs) != 1:
            raise ValueError("all scenes in a pack must share an archetype")
        #: blocks unrolled per on-device pack-scan iteration (identical
        #: semantics; XLA unrolls the loop body).  Small-scene packs are
        #: per-iteration fixed-cost bound like small single scenes
        #: (Renderer.scan_unroll): >1 amortizes the per-block op launches.
        self.scan_unroll = int(scan_unroll)
        self.scenes = scenes
        for sc in scenes:
            for pool in getattr(sc, "_all_pools", lambda: [])():
                # singleton (submix) pools pack too: their param/state
                # subtrees replicate over the voice axis (see
                # params_voice_axes) and the scene render gates their
                # contribution to voice-shard 0 before the psum
                if hasattr(pool, "_unpack_hook"):
                    # any out-of-graph pool-state mutation (grow, eager
                    # plays) must first pull the pack's carried device state
                    # back into the scenes, or it would mutate a stale
                    # mirror and the next restack would drop the progress
                    pool._unpack_hook = self._unpack
        self.rate = int(rate)
        self.interval = np.float32(1.0) / np.float32(self.rate)
        self.mesh = mesh
        self._steps = {}
        self._dstate = None  # stacked (S, ...) sharded pytree
        self._arch = None

    def _specs(self, tree, prefix_dims):
        return jax.tree.map(lambda _: P(*prefix_dims), tree)

    def _state_specs(self):
        """Per-leaf partition specs for the stacked device state: voice-axis
        leaves shard P(scene, voice); scene-level leaves (e.g. the listener
        rotation) replicate over the voice axis."""
        proto = self.scenes[0]
        va = getattr(proto, "device_state_voice_axes", None)
        if va is None:
            return self._specs(proto.device_collect(), (SCENE_AXIS, VOICE_AXIS))
        return jax.tree.map(
            lambda v: P(SCENE_AXIS, VOICE_AXIS) if v else P(SCENE_AXIS), va()
        )

    def _ensure_state(self):
        arch = self.scenes[0].archetype()
        if self._dstate is not None and arch == self._arch:
            return
        stacked = _stack([jax.tree.map(np.asarray, s.device_collect())
                          for s in self.scenes])
        if self._dstate is not None:
            # param-side archetype changes (delta variants, block configs)
            # must NOT reset the carried device state — rebuild only when
            # the state tree itself changed shape (e.g. pool growth)
            old_l, old_t = jax.tree.flatten(self._dstate)
            new_l, new_t = jax.tree.flatten(stacked)
            if old_t == new_t and all(
                a.shape == b.shape for a, b in zip(old_l, new_l)
            ):
                self._arch = arch
                return
        self._arch = arch
        specs = self._state_specs()
        self._dstate = jax.tree.map(
            lambda x, sp: jax.device_put(
                x, jax.sharding.NamedSharding(self.mesh, sp)
            ),
            stacked, specs,
        )

    def _get_step(self, n):
        key = (self._arch, n)
        step = self._steps.get(key)
        if step is not None:
            return step
        proto = self.scenes[0]

        def shard_fn(dstate, ddata, params):
            def one_scene(d, p):
                d2, block = proto.render(d, ddata, p, n)
                return d2, block

            d2, blocks = jax.vmap(one_scene)(dstate, params)
            # the only collective: finish the voice-axis mix reduction
            blocks = jax.lax.psum(blocks, VOICE_AXIS)
            return d2, blocks

        # delta/broadcast param leaves replicate over the voice axis;
        # per-voice leaves shard
        vflags = proto.params_voice_axes(self._params_single)
        pspecs = jax.tree.map(
            lambda f: P(SCENE_AXIS, VOICE_AXIS) if f else P(SCENE_AXIS), vflags
        )
        sspecs = self._state_specs()
        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(
                sspecs,
                self._specs(proto.device_data(), ()),
                pspecs,
            ),
            out_specs=(
                sspecs,
                P(SCENE_AXIS),
            ),
            check_vma=False,
        )
        step = jax.jit(mapped, donate_argnums=0)
        self._steps[key] = step
        return step

    def _tier_floors(self, n):
        """One program renders every scene, so aligned pools across the pack
        must agree on any motion-adaptive read tier: give each the max
        PRE-drain walk bound over the pack (each pool's post-drain bound is
        <= its tier_bound, so every scene resolves the same tier)."""
        import numpy as np

        scenes = self.scenes
        if not hasattr(scenes[0], "_all_pools"):
            return
        groups = list(zip(*[list(s._all_pools()) for s in scenes]))
        rot_any = any(
            getattr(s, "_rot_pending", None) is not None for s in scenes
        )
        for grp in groups:
            if not hasattr(grp[0], "tier_bound"):
                continue
            floor = max(p.tier_bound(self.interval, n) for p in grp)
            if rot_any and n > 0:
                from ..ops.geometry import HEAD_RADIUS, SPEED_OF_SOUND

                elapsed = float(np.float32(self.interval) * np.float32(n))
                floor += 2.0 * float(HEAD_RADIUS) / (
                    float(SPEED_OF_SOUND) * elapsed
                )
            for p in grp:
                p._dmax_floor = floor

    def _pack_force(self):
        """Any scene with queued control events forces EVERY scene onto the
        delta step variant this block (stacked param trees must be uniform
        across scenes); all-idle pack blocks ship no delta arrays at all.
        NB: stream INGEST stays per-scene-dirty — scenes in a pack must
        share a write schedule (all write in a block or none), like every
        other structural agreement the pack requires."""
        return any(
            getattr(s, "host_wants_deltas", lambda: False)()
            for s in self.scenes
        )

    def _prepare(self, n):
        force = self._pack_force()
        return [
            s.host_prepare(self.interval, n, force=force)
            if hasattr(s, "host_wants_deltas")
            else s.host_prepare(self.interval, n)
            for s in self.scenes
        ]

    def render_block(self, n):
        """Render one block for every scene; returns float32 (S, n, C)."""
        from .context import voice_axis

        self._tier_floors(n)
        per_scene = self._prepare(n)
        self._params_single = per_scene[0]
        params = _stack(per_scene)
        self._ensure_state()
        step = self._get_step(n)
        ddata = self.scenes[0].device_data()
        with voice_axis(VOICE_AXIS):
            self._dstate, blocks = step(self._dstate, ddata, params)
        return np.moveaxis(np.asarray(blocks), 1, 2)

    def _get_scan_step(self, arch, n, nblocks):
        key = (arch, n, nblocks, "scan", self.scan_unroll)
        step = self._steps.get(key)
        if step is not None:
            return step
        proto = self.scenes[0]
        unroll = min(self.scan_unroll, max(nblocks, 1))

        def shard_fn(dstate, ddata, stacked):
            def body(d, p):
                def one_scene(dd, pp):
                    return proto.render(dd, ddata, pp, n)

                d2, blocks = jax.vmap(one_scene)(d, p)
                return d2, jax.lax.psum(blocks, VOICE_AXIS)

            return jax.lax.scan(body, dstate, stacked, length=nblocks,
                                unroll=unroll)

        vflags = proto.params_voice_axes(self._params_single)
        pspecs = jax.tree.map(
            lambda f: P(None, SCENE_AXIS, VOICE_AXIS) if f
            else P(None, SCENE_AXIS),
            vflags,
        )
        sspecs = self._state_specs()
        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(
                sspecs,
                self._specs(proto.device_data(), ()),
                pspecs,
            ),
            out_specs=(
                sspecs,
                P(None, SCENE_AXIS),
            ),
            check_vma=False,
        )
        step = jax.jit(mapped, donate_argnums=0)
        self._steps[key] = step
        return step

    def render_frames_device(self, total, block_size=512):
        """Offline pack render that keeps audio on device: batches runs of
        equal-archetype blocks into on-device scans (the pack analogue of
        Renderer.render_frames_device) and returns a list of (B, S, C, n)
        device arrays.  With the all-idle fast path above, a control-free
        pack scan ships ~no parameter bytes per block."""
        from .context import voice_axis

        nblocks, rem = divmod(total, block_size)
        if rem:
            raise ValueError("total must be a multiple of block_size")
        out = []
        pend = []
        pend_arch = None
        pend_single = None

        def flush():
            nonlocal pend, pend_arch, pend_single
            if not pend:
                return
            self._ensure_state()
            self._arch = pend_arch
            self._params_single = pend_single
            stacked = _stack(pend)
            step = self._get_scan_step(pend_arch, block_size, len(pend))
            ddata = self.scenes[0].device_data()
            with voice_axis(VOICE_AXIS):
                self._dstate, blocks = step(self._dstate, ddata, stacked)
            out.append(blocks)
            pend, pend_arch, pend_single = [], None, None

        for bi in range(nblocks):
            if pend and any(
                getattr(s, "host_structure_event", lambda: False)()
                for s in self.scenes
            ):
                flush()
            self._tier_floors(block_size)
            per_scene = self._prepare(block_size)
            a = self.scenes[0].archetype()
            if pend and a != pend_arch:
                flush()
            if not pend:
                pend_single = per_scene[0]
            stacked = _stack(per_scene)
            pend.append(stacked)
            pend_arch = a
            # run-length idle fast path (see Renderer._run_blocks): an
            # empty-params block on scenes whose pools all pass the idle
            # gate proves the remaining blocks identical — advance them in
            # O(1) per scene instead of per-block Python over the pack
            remaining = nblocks - bi - 1
            if (remaining and not jax.tree.leaves(stacked) and all(
                getattr(s, "host_idle_bulk_ok", lambda iv: False)(
                    self.interval
                )
                for s in self.scenes
            )):
                for s in self.scenes:
                    s.host_idle_bulk(self.interval, block_size, remaining)
                pend.extend([stacked] * remaining)
                break
        flush()
        return out

    def sync(self):
        """Pull handle-visible device state back into each scene's host
        mirrors (slot reclamation, is_finished)."""
        unstacked = jax.tree.map(np.asarray, self._dstate) if self._dstate else None
        if unstacked is None:
            return
        for si, scene in enumerate(self.scenes):
            scene.device_store(jax.tree.map(lambda x: jnp.asarray(x[si]), unstacked))
            if hasattr(scene, "sync"):
                scene.sync()

    def _unpack(self):
        """Push the authoritative carried state back into the scenes and
        drop the stack; the next render_block restacks from the (now
        current) per-scene pools.  Fired by pool grow()/eager-play hooks so
        out-of-graph mutations never operate on stale mirrors."""
        if self._dstate is None:
            return
        self.sync()
        self._dstate = None
        for s in self.scenes:
            for p in getattr(s, "_all_pools", lambda: ())():
                if hasattr(p, "_dmax_floor"):
                    p._dmax_floor = 0.0
