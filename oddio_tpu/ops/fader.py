"""Constant-power crossfade between dynamically supplied signals.

Reference: /root/reference/src/fader.rs — ``Fader`` wraps an inner signal;
``FaderControl::fade_to(signal, duration)`` delivers a replacement through a
swap channel (fader.rs:86-93).  A fade must complete before the next begins
(a newer waiting command replaces the older, fader.rs:38-47); while fading,
``out = sqrt(1-p)*old + sqrt(p)*new`` per frame (fader.rs:52-65), and on
completion the new signal replaces the old (fader.rs:66-70).

Device forms:

* **standalone** — fades are a *graph-structure event*: idle renders one
  child, fading renders both with the closed-form progress ramp fused in.
  The Renderer keys its jitted step on the archetype, so starting/finishing
  a fade retraces (the analogue of the reference's idle fast path,
  fader.rs:42-45); targets may have any structure.
* **pooled** (a Fader voice inside a Mixer/spatial pool, mixer.rs:18-26) —
  the batched template keeps TWO same-archetype child banks and renders
  both every block; fade starts and completion swaps ride per-block params
  (device rows reset / exchanged in-graph), so fades in pools never change
  the traced structure and never recompile.  The dense-batch contract:
  pooled fade targets must share the current child's archetype.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.hostmath import f32, full
from ..core.signal import ControlBlock, Signal
from ._dev import iota_f32

__all__ = ["Fader", "FaderControl"]


def _host_defaults_into(node, i, fresh):
    """Reset ``node``'s host-state slot ``i`` to the class defaults taken
    from a fresh single-slot template."""
    for f in node._host_fields:
        getattr(node, f)[i] = getattr(fresh, f)[0]
    for c, fc in zip(node.children().values(), fresh.children().values()):
        _host_defaults_into(c, i, fc)


class Fader(Signal):
    _host_fields = ("progress", "duration", "fading")

    def __init__(self, inner):
        super().__init__()
        self.a = inner
        self.channels = inner.channels
        self.b = None  # standalone: active fade target
        self._alloc_host(())
        self.progress[()] = 1.0
        self.duration[()] = 1.0
        self._pending = None  # standalone: (signal, duration), last-wins
        self._swap_next = False
        self._pool_mode = False
        self._cb = ControlBlock(self)
        self.control = FaderControl(self._cb)

    @classmethod
    def new(cls, inner):
        sig = cls(inner)
        return sig.control, sig

    def _alloc_host(self, batch):
        self.progress = full(batch, 1.0)
        self.duration = full(batch, 1.0)
        self.fading = np.zeros(batch, dtype=bool)

    def children(self):
        if self._pool_mode:
            return {"a": self.a, "b": self.b}
        kids = {"a": self.a}
        if self.b is not None:
            kids["b"] = self.b
        return kids

    def _arch_extra(self):
        if self._pool_mode:
            return ("pooled",)
        return ("fading" if self.b is not None else "idle",)

    # -- pooled mode -----------------------------------------------------------

    def clone_batched(self, V):
        new = object.__new__(Fader)
        Signal.__init__(new)
        new.batch = (V,)
        new.channels = self.channels
        new._pool_mode = True
        new._alloc_host((V,))
        new.a = self.a.clone_batched(V)
        new.b = self.a.clone_batched(V)  # same-archetype shadow bank
        new._fresh = self.a.clone_batched(1)  # default-state rows
        new._b_dev_default = None  # lazy (device leaves)
        new._pending_fades = {}  # slot -> (spec, duration); last-wins
        new._pending_breset = set()  # slots whose b bank resets next block
        new._pool = None
        new._slot_gen = np.zeros(V, np.int64)
        new._pending = None
        new._swap_next = False
        new.control = None
        return new

    def write_slot(self, i, spec, pool, gen):
        if spec._moved:
            raise RuntimeError("signal was already played (moved); construct a new one")
        spec._moved = True
        self.progress[i] = spec.progress[()]
        self.duration[i] = spec.duration[()]
        self.fading[i] = spec.b is not None
        self._rebind_controls(spec, i, pool, gen)
        self._pool = pool
        self._slot_gen[i] = gen
        self.a.write_slot(i, spec.a, pool, gen)
        if spec.b is not None:
            if spec.b.archetype() != spec.a.archetype():
                raise ValueError(
                    "pooled fade targets must share the inner archetype"
                )
            self.b.write_slot(i, spec.b, pool, gen)
        else:
            _host_defaults_into(self.b, i, self._fresh)

    def queue_fade(self, idx, signal, duration):
        """Route a control-side fade_to to wherever this fader lives."""
        if self._pool_mode:
            self._pending_fades[idx] = (signal, float(duration))
        else:
            self._pending = (signal, float(duration))

    def host_aux_snapshot(self):
        """Queued control events are engine state: a snapshot taken between
        fade_to() and the next block must not lose the fade (the checkpoint
        analogue of the DR pools' pending_plays handling)."""
        if not self._pool_mode:
            return None
        return {
            "pending_fades": dict(self._pending_fades),
            "pending_breset": set(self._pending_breset),
        }

    def host_aux_restore(self, aux):
        if not self._pool_mode or aux is None:
            return
        self._pending_fades = dict(aux["pending_fades"])
        self._pending_breset = set(aux["pending_breset"])

    def _b_defaults(self):
        """Default per-slot device rows for the b bank (numpy pytree)."""
        if self._b_dev_default is None:
            self._b_dev_default = jax.tree.map(
                lambda x: np.asarray(x[0]), self._fresh.device_collect()
            )
        return self._b_dev_default

    # -- host per-block protocol -------------------------------------------------

    def _host_prepare_pooled(self, interval, n, count):
        # completion swaps from the previous block (fader.rs:66-70): host
        # rows exchange here; device rows exchange in-graph via params
        done = self.fading & (self.progress >= 1.0)
        if done.any():
            self._swap_host_rows(self.a, self.b, done)
            self.fading = self.fading & ~done

        # start pending fades on idle voices (fader.rs:38-47)
        breset = self._pending_breset
        self._pending_breset = set()
        for slot, (spec, dur) in list(self._pending_fades.items()):
            if self.fading[slot]:
                continue  # waits; a newer command replaced any older waiter
            del self._pending_fades[slot]
            if spec.archetype() != self._fresh.archetype():
                raise ValueError(
                    "pooled fade targets must share the inner archetype"
                )
            self.b.write_slot(slot, spec, self._pool, int(self._slot_gen[slot]))
            self.duration[slot] = np.float32(dur)
            self.progress[slot] = np.float32(0.0)
            self.fading[slot] = True
            breset.add(slot)

        # duration <= one interval (incl. 0) completes within the first
        # frame, like the reference's per-frame progress.min(1.0)
        # (fader.rs:52-63); clamping also keeps 0*inf out of the closed-form
        # ramp below (progress0 + j*inc at j=0 would be NaN for inc=inf)
        inc = (interval / np.maximum(self.duration, interval)).astype(np.float32)
        V = self.batch[0]
        breset_mask = np.zeros(V, dtype=bool)
        for s in breset:
            breset_mask[s] = True
        params = {
            "swap": done,
            "breset": breset_mask,
            "fading": self.fading.copy(),
            "progress0": self.progress.copy(),
            "inc": inc,
            "a": self.a.host_prepare(interval, n, count),
            "b": self.b.host_prepare(interval, n, count),
        }
        cnt = np.broadcast_to(f32(n if count is None else count), self.batch)
        self.progress = np.where(
            self.fading,
            np.minimum((self.progress + cnt * inc).astype(np.float32), np.float32(1.0)),
            self.progress,
        ).astype(np.float32)
        return params

    @staticmethod
    def _swap_host_rows(a, b, mask):
        for f in a._host_fields:
            fa, fb = getattr(a, f), getattr(b, f)
            tmp = fa[mask].copy()
            fa[mask] = fb[mask]
            fb[mask] = tmp
        for ca, cb in zip(a.children().values(), b.children().values()):
            Fader._swap_host_rows(ca, cb, mask)

    def host_prepare(self, interval, n, count=None):
        interval = np.broadcast_to(f32(interval), self.batch).astype(np.float32)
        if self._pool_mode:
            return self._host_prepare_pooled(interval, n, count)
        if self._swap_next:
            # fader.rs:66-70, deferred to the block boundary: move the new
            # signal (and its device state, owned by the node) into place.
            self.a, self.b = self.b, None
            self._swap_next = False
        # fader.rs:38-47: a pending fade starts only once idle
        if self.progress >= 1.0 and self._pending is not None:
            sig, dur = self._pending
            self._pending = None
            if sig._moved:
                raise RuntimeError("fade target was already played (moved)")
            sig._moved = True
            self.b = sig
            self.duration[()] = np.float32(dur)
            self.progress[()] = np.float32(0.0)

        if self.b is None:
            return {"a": self.a.host_prepare(interval, n, count)}

        # see _host_prepare_pooled: sub-interval durations clamp to one frame
        inc = (interval / np.maximum(self.duration, interval)).astype(np.float32)
        params = {
            "progress0": np.asarray(self.progress, np.float32),
            "inc": inc,
            "a": self.a.host_prepare(interval, n, count),
            "b": self.b.host_prepare(interval, n, count),
        }
        cnt = np.broadcast_to(f32(n if count is None else count), self.batch)
        self.progress = np.asarray(
            np.minimum((self.progress + cnt * inc).astype(np.float32), np.float32(1.0)),
            dtype=np.float32,
        )
        if self.progress >= 1.0:
            self._swap_next = True
        return params

    def host_is_finished(self):
        return np.zeros(self.batch, dtype=bool)  # fader.rs:74-77

    def host_structure_event(self):
        if not self._pool_mode:
            # the next prepare will swap children or start a structural fade
            if self._swap_next or (
                self._pending is not None and float(self.progress) >= 1.0
            ):
                return True
        # pooled fades are parameter events, not structure events
        return any(c.host_structure_event() for c in self.children().values())

    def render(self, dstate, ddata, params, n):
        if self._pool_mode:
            return self._render_pooled(dstate, ddata, params, n)
        d2a, old = self.a.render(
            dstate.get("a", {}), ddata.get("a", {}), params["a"], n
        )
        out = dict(dstate)
        out["a"] = d2a
        if self.b is None:
            return out, old
        d2b, new = self.b.render(
            dstate.get("b", {}), ddata.get("b", {}), params["b"], n
        )
        out["b"] = d2b
        # fader.rs:57-63: constant-power ramp, progress clamped at 1
        p = jnp.minimum(params["progress0"] + iota_f32(n) * params["inc"], 1.0)
        fade_out = jnp.sqrt(1.0 - p)
        fade_in = jnp.sqrt(p)
        return out, old * fade_out[None, :] + new * fade_in[None, :]

    def _render_pooled(self, dstate, ddata, params, n):
        # runs unbatched under the pool's vmap: every leaf is one voice's row
        da, db = dstate["a"], dstate["b"]
        swap = params["swap"]
        da, db = (
            jax.tree.map(lambda x, y: jnp.where(swap, y, x), da, db),
            jax.tree.map(lambda x, y: jnp.where(swap, y, x), db, da),
        )
        # fade starts: the b bank's device rows reset to defaults in-graph
        # (defaults are small trace-time constants, not shipped per block)
        db = jax.tree.map(
            lambda x, d: jnp.where(params["breset"], jnp.asarray(d, x.dtype), x),
            db, self._b_defaults(),
        )
        dda = ddata.get("a", {})
        d2a, old = self.a.render(da, dda, params["a"], n)
        d2b, new = self.b.render(db, dda, params["b"], n)
        p = jnp.minimum(params["progress0"] + iota_f32(n) * params["inc"], 1.0)
        wa = jnp.where(params["fading"], jnp.sqrt(1.0 - p), 1.0)
        wb = jnp.where(params["fading"], jnp.sqrt(p), 0.0)
        out = dict(dstate)
        out["a"], out["b"] = d2a, d2b
        return out, old * wa[None, :] + new * wb[None, :]

    def device_data(self):
        # both banks share the a-side read-only arrays (same archetype)
        d = dict(self._own_device_data())
        sub = self.a.device_data()
        if sub:
            d["a"] = sub
        return d

    # -- device-resident mode ------------------------------------------------
    # The DR fader keeps TWO same-archetype banks plus a per-voice
    # ACTIVE-BANK BIT (``flip``): a fade writes the incoming signal into the
    # per-voice INACTIVE bank, and completion (fader.rs:66-70) just flips
    # the bit — no state ever moves between banks, so control handles bound
    # into either bank stay valid across any number of fades.  Fade starts
    # arrive as sparse pool deltas (core/drctrl.py::_fade_apply); the fade
    # ramp itself (fader.rs:52-63) is the closed-form constant-power curve.

    def dr_fade_capable(self):
        return True

    def dr_ctrl_children(self):
        """Both banks' control fields are addressable in the DR state tree
        (the incoming signal's handles bind to whichever bank it lands in)."""
        return {"a": self.a, "b": self.a}

    def dr_supported(self):
        return (
            not self._pool_mode
            and self.a.dr_supported()
            and (self.b is None or self.b.dr_supported())
        )

    def dr_state_init(self, V):
        sub = self.a.dr_state_init(V)
        return {
            "prog": np.ones(V, np.float32),
            "inc": np.zeros(V, np.float32),
            "fading": np.zeros(V, bool),
            "flip": np.zeros(V, bool),
            "a": sub,
            "b": jax.tree.map(np.copy, sub),
        }

    def dr_slot_row(self, interval):
        fading = self.b is not None
        iv = np.float32(interval)
        if fading:
            if self.b.archetype() != self.a.archetype():
                raise ValueError(
                    "pooled fade targets must share the inner archetype"
                )
            inc = np.float32(iv / max(np.float32(self.duration[()]), iv))
            brow = self.b.dr_slot_row(interval)
            prog = np.float32(self.progress[()])
        else:
            inc = np.float32(0.0)
            brow = jax.tree.map(
                lambda x: np.asarray(x[0]), self.a.dr_state_init(1)
            )
            prog = np.float32(1.0)
        return {
            "prog": prog, "inc": inc, "fading": bool(fading), "flip": False,
            "a": self.a.dr_slot_row(interval), "b": brow,
        }

    def dr_render(self, state, ddata, interval, n, count):
        # completion check first (fader.rs:66-70 deferred to block start,
        # mirroring _host_prepare_pooled): the bit flips, nothing moves
        done = state["fading"] & (state["prog"] >= 1.0)
        flip = jnp.logical_xor(state["flip"], done)
        fading = state["fading"] & ~done
        dda = ddata.get("a", {})
        a2, sa = self.a.dr_render(state["a"], dda, interval, n, count)
        b2, sb = self.a.dr_render(state["b"], dda, interval, n, count)

        def ex(m):  # per-voice mask against (V[, C], n) samples
            return m.reshape(m.shape + (1,) * (sa.ndim - 1))

        old = jnp.where(ex(flip), sb, sa)
        new = jnp.where(ex(flip), sa, sb)
        p = jnp.minimum(
            state["prog"][:, None] + iota_f32(n) * state["inc"][:, None], 1.0
        )
        if sa.ndim == 3:
            p = p[:, None, :]
        f2 = ex(fading)
        wa = jnp.where(f2, jnp.sqrt(1.0 - p), 1.0)
        wb = jnp.where(f2, jnp.sqrt(p), 0.0)
        prog2 = jnp.minimum(
            state["prog"] + count.astype(jnp.float32) * state["inc"], 1.0
        )
        out_state = {
            "prog": prog2, "inc": state["inc"], "fading": fading,
            "flip": flip, "a": a2, "b": b2,
        }
        return out_state, old * wa + new * wb

    def dr_is_finished(self, state):
        # a fader never finishes on its own (fader.rs:74-77)
        return jnp.zeros(state["prog"].shape, dtype=bool)


class FaderControl:
    """fader.rs:81-93: crossfade to ``signal`` over ``duration`` seconds; if a
    fade is in progress the new command waits (and replaces any waiter)."""

    def __init__(self, cb):
        self._cb = cb

    def fade_to(self, signal, duration):
        fader = self._cb.sig
        if signal.channels != fader.channels:
            raise ValueError("fade target must match channel count")
        if self._cb._dr is not None:
            # device-resident voice: the fade rides the pool's sparse
            # delta channel (core/drctrl.py::push_fade)
            pool, slot, gen, path = self._cb._dr
            if pool.slot_gen[slot] == gen:
                pool.push_fade(path, slot, gen, signal, duration)
            return
        if self._cb.live():
            fader.queue_fade(self._cb.idx, signal, duration)
