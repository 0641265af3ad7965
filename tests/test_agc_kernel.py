"""Closed-form AGC (ops/adapt.py::ema_gain_closed) vs the associative-scan
EMA.

The closed form replaces the scan when the pool-tracked tau bound holds
(EMA_NMAX * interval/tau_min <= EMA_GATE); pathological taus keep the
associative path (adapt.rs:69-88 semantics must hold either way)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oddio_tpu as ot
from oddio_tpu.ops.adapt import _ema_gain, ema_gain_closed


@pytest.mark.parametrize("V,n", [(7, 512), (32, 512), (5, 128), (48, 384)])
def test_closed_form_matches_associative_scan(V, n):
    rng = np.random.default_rng(V * 1000 + n)
    s = jnp.asarray(rng.standard_normal((V, n)) * 0.4, jnp.float32)
    alpha = jnp.asarray(rng.uniform(1e-5, 0.06, V), jnp.float32)
    count = jnp.asarray(rng.integers(0, n + 1, V), jnp.int32)
    low = jnp.full((V,), np.float32(0.1 / np.sqrt(2)))
    high = jnp.full((V,), np.float32(0.5 / np.sqrt(2)))
    mg = jnp.asarray(rng.uniform(1, 8, V), jnp.float32)
    avg0 = jnp.asarray(rng.uniform(1e-4, 1.0, V), jnp.float32)
    g1, c1 = _ema_gain(avg0, s, alpha, count, low, high, mg, n)
    g2, c2 = ema_gain_closed(avg0, s, alpha, count, low, high, mg, n)
    assert float(jnp.max(jnp.abs(g1 - g2))) < 5e-6
    crel = jnp.max(jnp.abs(c1 - c2) / jnp.maximum(jnp.abs(c1), 1e-20))
    assert float(crel) < 1e-4


def test_closed_form_under_scene_vmap():
    """The ScenePack form: the closed form vmapped over a scene axis."""
    rng = np.random.default_rng(3)
    S, V, n = 3, 16, 512
    s = jnp.asarray(rng.standard_normal((S, V, n)) * 0.4, jnp.float32)
    alpha = jnp.full((S, V), np.float32(2.1e-4))
    count = jnp.full((S, V), n, jnp.int32)
    low = jnp.full((S, V), np.float32(0.1 / np.sqrt(2)))
    high = jnp.full((S, V), np.float32(0.5 / np.sqrt(2)))
    mg = jnp.full((S, V), np.float32(4.0))
    avg0 = jnp.full((S, V), np.float32(0.01))
    g1, c1 = jax.vmap(lambda a, b, al, c, l, h, m: _ema_gain(
        a, b, al, c, l, h, m, n))(avg0, s, alpha, count, low, high, mg)
    g2, c2 = jax.vmap(lambda a, b, al, c, l, h, m: ema_gain_closed(
        a, b, al, c, l, h, m, n))(avg0, s, alpha, count, low, high, mg)
    assert float(jnp.max(jnp.abs(g1 - g2))) < 5e-6
    assert float(jnp.max(jnp.abs(c1 - c2))) < 1e-5


def _adapt_scene(taus, freqs):
    control, mixer = ot.Mixer.new(channels=1)
    for tau, f in zip(taus, freqs):
        control.play(ot.Adapt(
            ot.Sine(0.3, f), 0.1,
            ot.AdaptOptions(tau=tau, low=0.1, high=0.4, max_gain=4.0),
        ))
    return mixer


def test_dr_pool_fast_path_matches_scan_path():
    """Same scene rendered with the closed-form gate open vs forced shut —
    audio must agree (the closed form is <= ~1e-6 of the scan)."""
    rng = np.random.default_rng(7)
    freqs = rng.uniform(50, 2000, 24)

    def run(gate):
        import oddio_tpu.ops.adapt as pagc

        old = pagc.EMA_GATE
        pagc.EMA_GATE = gate
        try:
            mixer = _adapt_scene([0.1] * 24, freqs)
            r = ot.Renderer(mixer, 48000)
            out = np.concatenate([r.render_block(512) for _ in range(4)])
            pool = next(iter(mixer._pools.values()))
            assert pool.is_dr
            expect_fast = gate > 0
            assert pool._ema_fast == expect_fast
            assert getattr(pool.proto, "_pool_ema_fast", False) == expect_fast
        finally:
            pagc.EMA_GATE = old
        return out

    fast = run(32.0)
    slow = run(-1.0)
    assert np.isfinite(fast).all()
    # both paths sit within ~1e-6/block of the sequential oracle (unit
    # tests above); against EACH OTHER the carry reassociation compounds
    # across blocks, so the cross-path bound is looser than the per-block
    # contract
    err = np.abs(fast - slow).max()
    assert err < 1e-4, err


def test_pathological_tau_falls_back_and_flips_pool():
    """A tiny-tau voice must force the associative path (the closed form
    would overflow), including when played into a live fast-path pool."""
    mixer = _adapt_scene([0.1] * 4, [200.0, 300.0, 400.0, 500.0])
    r = ot.Renderer(mixer, 48000)
    r.render_block(512)
    pool = next(iter(mixer._pools.values()))
    assert pool._ema_fast
    # play a pathological tau mid-run: flag flips, render stays finite
    ctl = ot.MixerControl(mixer)
    ctl.play(ot.Adapt(
        ot.Sine(0.0, 440.0), 0.1,
        ot.AdaptOptions(tau=1e-6, low=0.1, high=0.4, max_gain=4.0),
    ))
    out = np.concatenate([r.render_block(512) for _ in range(3)])
    assert not pool._ema_fast
    assert not getattr(pool.proto, "_pool_ema_fast", True)
    assert np.isfinite(out).all()
