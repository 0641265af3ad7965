"""Sparse control deltas for filters inside device-resident pools.

The reference's ``Gain``/``Speed`` handles write shared atomics that the
audio thread reads every ``sample`` call (gain.rs:103-108, speed.rs:32-36).
In a device-resident pool the equivalent is a bounded per-block delta
channel per controllable field: handle writes queue ``(slot, value)`` on
the host (last-wins per slot, like the atomics), and the jitted step
scatters them into the pool's state tree before rendering.

The set of controllable fields is static per pool (derived from the
prototype chain at pool creation), so delta arrays keep a fixed structure
and control traffic never retraces the step.
"""

from __future__ import annotations

import jax
import numpy as np

__all__ = ["DRCtrlMixin", "walk_ctrl_keys"]


def _dr_children(node):
    """Children as addressed in the DR state tree (faders expose both
    banks even though the spec only carries one)."""
    f = getattr(node, "dr_ctrl_children", None)
    return f() if f is not None else node.children()


def walk_ctrl_keys(proto):
    """Ordered (path, field) pairs for every controllable host field in the
    chain; ``path`` is the tuple of child keys from the pool root."""
    keys = []

    def walk(node, path):
        for f in getattr(node, "_dr_ctrl_fields", ()):
            keys.append((path, f))
        for k, c in _dr_children(node).items():
            walk(c, path + (k,))

    walk(proto, ())
    return keys


def walk_fade_paths(proto):
    """Paths of fade-capable (Fader) nodes in the chain, outermost first."""
    out = []

    def walk(node, path):
        if getattr(node, "dr_fade_capable", lambda: False)():
            out.append(path)
        for k, c in _dr_children(node).items():
            walk(c, path + (k,))

    walk(proto, ())
    return out


def _at_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _at_path_spec(node, path):
    """Walk a SPEC tree by DR-state path (fader banks both map to .a)."""
    for k in path:
        node = _dr_children(node)[k]
    return node


def _set_path(tree, path, value):
    if not path:
        return value
    t = dict(tree)
    t[path[0]] = _set_path(t[path[0]], path[1:], value)
    return t


def _scatter(tree, path, field, idx, vals):
    t = dict(tree)
    if path:
        t[path[0]] = _scatter(t[path[0]], path[1:], field, idx, vals)
    else:
        t[field] = t[field].at[idx].set(vals, mode="drop")
    return t


def rows_scatter(state, rows, idx, wrote=None):
    """Scatter play/fade rows into a dr state tree.  ``rows`` may be a
    strict SUBTREE of ``state`` (dr_slot_row may omit big in-place leaves
    like stream rings); missing keys are left untouched.  ``wrote``
    optionally masks the write per target row (fade bank selection)."""
    import jax.numpy as jnp

    if isinstance(rows, dict):
        out = dict(state)
        for k, rv in rows.items():
            out[k] = rows_scatter(state[k], rv, idx, wrote)
        return out
    upd = state.at[idx].set(rows, mode="drop")
    if wrote is None:
        return upd
    m = wrote.reshape(wrote.shape + (1,) * (state.ndim - 1))
    return jnp.where(m, upd, state)


@jax.jit
def _sync_digest(mask, stopped):
    """Pack the two handle-visible flag columns into one bit array: the
    device->host sync of a 4096-voice pool shrinks from 8 KB in two
    transfers to 1 KB in one — the readback twin of the packed parameter
    upload (core/run.py)."""
    import jax.numpy as jnp

    return jnp.packbits(jnp.concatenate([mask, stopped]))


class DRCtrlMixin:
    """Shared by device-resident voice pools (spatial + mixer)."""

    #: per-block delta-channel capacity per controllable field
    k_ctrl = 64
    #: per-block fade-start lanes per fader path
    k_fade = 8

    # -- packed handle-state sync ------------------------------------------

    def _sync_start(self):
        """Begin the async device->host copy of the packed (mask, stopped)
        digest for the CURRENT state version."""
        st = self.state
        if st is None:
            return
        key = st["mask"]
        packed = _sync_digest(key, st["stopped"])
        packed.copy_to_host_async()
        self._sync_pack = (key, packed)

    def _sync_read(self):
        """(mask, stopped) numpy bool columns of the current state, via the
        packed digest (reusing a prefetched one when still current)."""
        st = self.state
        pk = getattr(self, "_sync_pack", None)
        if pk is None or pk[0] is not st["mask"]:
            self._sync_start()
            pk = self._sync_pack
        self._sync_pack = None
        bits = np.unpackbits(np.asarray(pk[1]))
        V = st["mask"].shape[0]
        return bits[:V].astype(bool), bits[V : 2 * V].astype(bool)

    def _init_ctrl(self, proto):
        self.ctrl_keys = walk_ctrl_keys(proto)
        self.pending_ctrl = {k: {} for k in self.ctrl_keys}
        self.fade_paths = walk_fade_paths(proto)
        #: path -> slot -> (spec, duration); last-wins per slot while a
        #: fade is in flight (fader.rs:38-47's waiting command)
        self.pending_fades = {p: {} for p in self.fade_paths}
        V = self.capacity
        #: deterministic host mirrors of each fader's device state — the
        #: device never needs to be read to decide when a waiting fade may
        #: start (progress advances by exactly count*inc per block)
        self._fade_prog = {p: np.ones(V, np.float32) for p in self.fade_paths}
        self._fade_inc = {p: np.zeros(V, np.float32) for p in self.fade_paths}
        self._fade_fading = {p: np.zeros(V, bool) for p in self.fade_paths}
        self._fade_flip = {p: np.zeros(V, bool) for p in self.fade_paths}
        #: durations of mid-fade plays whose inc is resolved at the first
        #: tick (the pool interval may be unknown at play time); -1 = none
        self._fade_dur = {
            p: np.full(V, -1.0, np.float32) for p in self.fade_paths
        }
        #: AGC-bound bookkeeping: live slots' spec chains (their control
        #: mirrors stay current — ControlBlock.set always writes the spec's
        #: own field) feed host_ema_bound; recomputed lazily on plays /
        #: interval-class control writes so Adapt can fall back to the
        #: associative scan when a tau fails the closed form's gate
        self._slot_specs = {}
        self._extra_specs = {}  # (slot, fade path, bank) -> fade spec
        self._ema_fields = {
            k for k in self.ctrl_keys
            if k[1] in getattr(_at_path_spec(proto, k[0]), "_dr_interval_fields", ())
        }
        self._ema_dirty = True
        self._ema_fast = False
        #: True when NO fader in the pool has pending, in-flight, or
        #: unresolved-inc fades — _fade_tick is then an exact no-op and the
        #: pool's idle fast path may skip it.  Set False by push_fade /
        #: _fade_mirror_on_play seeding; recomputed at each real tick.
        self._fade_quiet = True

    def _ctrl_grow(self, old, new):
        ext = new - old
        for p in self.fade_paths:
            self._fade_prog[p] = np.concatenate(
                [self._fade_prog[p], np.ones(ext, np.float32)]
            )
            self._fade_inc[p] = np.concatenate(
                [self._fade_inc[p], np.zeros(ext, np.float32)]
            )
            self._fade_fading[p] = np.concatenate(
                [self._fade_fading[p], np.zeros(ext, bool)]
            )
            self._fade_flip[p] = np.concatenate(
                [self._fade_flip[p], np.zeros(ext, bool)]
            )
            self._fade_dur[p] = np.concatenate(
                [self._fade_dur[p], np.full(ext, -1.0, np.float32)]
            )

    def _rebind_ctrl(self, spec, slot, gen, prefix=()):
        """Point every control handle in ``spec``'s chain at this pool."""

        def walk(node, path):
            cb = getattr(node, "_cb", None)
            if cb is not None:
                cb.rebind_dr(self, slot, gen, path)
            for k, c in node.children().items():
                walk(c, path + (k,))

        walk(spec, prefix)

    def push_ctrl(self, path, field, slot, value):
        self.pending_ctrl[(path, field)][slot] = np.float32(value)
        if (path, field) in self._ema_fields:
            self._ema_dirty = True

    def push_fade(self, path, slot, gen, spec, duration):
        """fade_to on a DR voice (fader.rs:86-93): queued per (fader,
        slot), last-wins while a fade is in flight."""
        if self.slot_gen[slot] != gen:
            return
        proto_inner = _at_path_spec(self.proto, path).a
        if spec.archetype() != proto_inner.archetype():
            raise ValueError(
                "pooled fade targets must share the inner archetype"
            )
        stack = [spec]
        while stack:  # Rust move semantics, recursively
            s = stack.pop()
            if s._moved:
                raise RuntimeError(
                    "fade target was already played (moved); construct a new one"
                )
            s._moved = True
            stack.extend(s.children().values())
        self.pending_fades[path][int(slot)] = (spec, float(duration), gen)
        self._fade_quiet = False

    def _fade_claim_reset(self, slot):
        """A reclaimed slot's queued fades and fader mirrors must not leak
        onto the next tenant."""
        for p in self.fade_paths:
            self.pending_fades[p].pop(int(slot), None)
            for bank in ("a", "b"):
                self._extra_specs.pop((int(slot), p, bank), None)

    def _track_spec(self, slot, spec):
        """Retain a played spec for AGC-bound queries (its control mirrors
        stay live through the handles)."""
        self._slot_specs[int(slot)] = spec
        self._ema_dirty = True

    def _ema_flag_sync(self, interval):
        """Resolve whether every live Adapt tau accepts the closed-form AGC
        (ops/adapt.py::ema_gain_closed) and stamp the verdict onto every
        node of the proto chain (Adapt reads it at trace time; it is part
        of the pool archetype, so flipping retraces).  Recomputed only
        after plays or interval-class control writes."""
        interval = float(interval)
        if self._ema_dirty or getattr(self, "_ema_interval", None) != interval:
            from ..ops.adapt import EMA_GATE, EMA_NMAX

            be = 0.0
            for slot, spec in self._slot_specs.items():
                if self.mask_host[slot]:
                    be = max(be, spec.host_ema_bound(interval))
            for (slot, _p, _bank), spec in self._extra_specs.items():
                if self.mask_host[slot]:
                    be = max(be, spec.host_ema_bound(interval))
            self._ema_fast = bool(EMA_NMAX * be <= EMA_GATE)
            self._ema_dirty = False
            self._ema_interval = interval
        fast = self._ema_fast
        if getattr(self.proto, "_pool_ema_fast", None) is not fast:
            stack = [self.proto]
            while stack:
                node = stack.pop()
                node._pool_ema_fast = fast
                stack.extend(_dr_children(node).values())

    def _fade_mirror_on_play(self, slot, spec):
        """Seed the fader mirrors from the played spec's host state."""
        for p in self.fade_paths:
            node = spec
            ok = True
            for k in p:
                kids = node.children()
                if k not in kids:
                    ok = False
                    break
                node = kids[k]
            if ok and node.b is not None:
                self._fade_prog[p][slot] = np.float32(node.progress[()])
                self._fade_fading[p][slot] = True
                self._fade_dur[p][slot] = np.float32(node.duration[()])
                self._fade_quiet = False
            else:
                self._fade_prog[p][slot] = np.float32(1.0)
                self._fade_fading[p][slot] = False
                self._fade_dur[p][slot] = -1.0
            self._fade_inc[p][slot] = np.float32(0.0)
            self._fade_flip[p][slot] = False

    def _fade_pending_any(self):
        return any(self.pending_fades.values())

    def _fade_tick(self, params, interval, count):
        """Per-block fader bookkeeping, mirroring the device exactly:
        release waiting fades on idle voices into padded delta lanes (when
        ``params`` is not None), emulate the start-of-block completion
        flips, and advance the progress mirrors by ``count`` frames."""
        if not self.fade_paths:
            return
        iv = np.float32(interval)
        cf = np.float32(count)
        for j, path in enumerate(self.fade_paths):
            prog = self._fade_prog[path]
            inc = self._fade_inc[path]
            fading = self._fade_fading[path]
            flip = self._fade_flip[path]
            # resolve mid-fade plays' inc now that the interval is known
            dur = self._fade_dur[path]
            pend_dur = dur >= 0.0
            if pend_dur.any():
                inc[pend_dur] = iv / np.maximum(dur[pend_dur], iv)
                dur[pend_dur] = -1.0
            if params is not None:
                idx = np.full(self.k_fade, self.capacity, np.int32)
                incv = np.zeros(self.k_fade, np.float32)
                rows = []
                pend = self.pending_fades[path]
                t = 0
                for slot in sorted(pend):
                    if t >= self.k_fade:
                        break
                    if pend[slot][2] != self.slot_gen[slot]:
                        del pend[slot]  # voice died; command dropped
                        continue
                    if fading[slot] and prog[slot] < 1.0:
                        continue  # waits until idle (fader.rs:38-47)
                    spec, dur, _ = pend.pop(slot)
                    # emulate the device's targeted-slot resolution of a
                    # completed-but-unflipped fade (see _fade_apply)
                    if fading[slot]:
                        flip[slot] = ~flip[slot]
                        fading[slot] = False
                    inc_s = np.float32(iv / max(np.float32(dur), iv))
                    # the incoming signal lands in the INACTIVE bank; its
                    # control handles bind there permanently (banks never
                    # exchange state — completion only flips the bit)
                    bank = "a" if flip[slot] else "b"
                    self._rebind_ctrl(
                        spec, slot, int(self.slot_gen[slot]), path + (bank,)
                    )
                    idx[t] = slot
                    incv[t] = inc_s
                    rows.append(spec.dr_slot_row(interval))
                    # keyed per BANK: the previous tenant of the OTHER bank
                    # (the fade's outgoing signal) keeps rendering with
                    # nonzero weight for the whole crossfade, so it must
                    # stay in the ds-bound sweep; only the bank this spec
                    # replaces drops out
                    self._extra_specs[(slot, path, bank)] = spec
                    self._ema_dirty = True
                    prog[slot] = 0.0
                    inc[slot] = inc_s
                    fading[slot] = True
                    t += 1
                proto_inner = _at_path_spec(self.proto, path).a
                default = proto_inner.dr_default_row(interval)
                rows = rows + [default] * (self.k_fade - len(rows))
                params[f"fade_idx{j}"] = idx
                params[f"fade_inc{j}"] = incv
                params[f"fade_row{j}"] = jax.tree.map(
                    lambda *xs: np.stack(xs), *rows
                )
            # start-of-block completion flips for untargeted slots, then
            # the end-of-block progress advance (matches dr_render)
            done = fading & (prog >= 1.0)
            np.logical_xor(flip, done, out=flip)
            fading &= ~done
            np.minimum(prog + cf * inc, np.float32(1.0), out=prog)
        # quiet = a future tick would be an exact no-op (idle-path gate)
        self._fade_quiet = not any(
            self.pending_fades[p]
            or self._fade_fading[p].any()
            or (self._fade_dur[p] >= 0.0).any()
            for p in self.fade_paths
        )

    def _fade_apply(self, inner_state, params):
        """Scatter queued fade starts into the fader nodes' state subtrees
        (after plays/ctrl deltas; completion for a targeted slot resolves
        first so a new fade never lands on an unflipped finished one)."""
        if not self.fade_paths or "fade_idx0" not in params:
            return inner_state
        import jax.numpy as jnp

        from ..parallel.context import localize_index

        for j, path in enumerate(self.fade_paths):
            sub = dict(_at_path(inner_state, path))
            V = sub["prog"].shape[0]
            lidx = localize_index(params[f"fade_idx{j}"], V)
            tgt = jnp.zeros(V, bool).at[lidx].set(True, mode="drop")
            res = tgt & sub["fading"] & (sub["prog"] >= 1.0)
            flip = jnp.logical_xor(sub["flip"], res)
            rows = params[f"fade_row{j}"]

            def write_bank(bank_state, into_a):
                wrote = tgt & (flip if into_a else ~flip)
                return rows_scatter(bank_state, rows, lidx, wrote)

            sub["a"] = write_bank(sub["a"], True)
            sub["b"] = write_bank(sub["b"], False)
            sub["flip"] = flip
            sub["prog"] = sub["prog"].at[lidx].set(0.0, mode="drop")
            sub["inc"] = sub["inc"].at[lidx].set(
                params[f"fade_inc{j}"], mode="drop"
            )
            sub["fading"] = (sub["fading"] & ~res).at[lidx].set(
                True, mode="drop"
            )
            inner_state = _set_path(inner_state, path, sub)
        return inner_state

    def _ctrl_pending_any(self):
        return any(self.pending_ctrl.values()) or self._fade_pending_any()

    def _ctrl_delta_params(self, params):
        """Pack one (idx, val) pair per controllable field (padded; overflow
        beyond k_ctrl carries to the next block)."""
        for j, key in enumerate(self.ctrl_keys):
            pend = self.pending_ctrl[key]
            items = list(pend.items())[: self.k_ctrl]
            for s, _ in items:
                del pend[s]
            idx = np.full(self.k_ctrl, self.capacity, np.int32)
            val = np.zeros(self.k_ctrl, np.float32)
            for t, (s, v) in enumerate(items):
                idx[t] = s
                val[t] = v
            params[f"ctrl_idx{j}"] = idx
            params[f"ctrl_val{j}"] = val
        return params

    def _ctrl_apply(self, inner_state, params):
        """Scatter queued control writes into the inner state tree (applied
        after plays, so a write always lands on the voice it targeted)."""
        if "ctrl_idx0" not in params or not self.ctrl_keys:
            return inner_state
        from ..parallel.context import localize_index

        V = None
        for j, (path, field) in enumerate(self.ctrl_keys):
            idx = params[f"ctrl_idx{j}"]
            if V is None:
                t = inner_state
                for k in path:
                    t = t[k]
                V = t[field].shape[0]
            lidx = localize_index(idx, V)
            inner_state = _scatter(
                inner_state, path, field, lidx, params[f"ctrl_val{j}"]
            )
        return inner_state
