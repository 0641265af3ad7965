"""Device-resident control deltas: Gain/Speed handles writing into DR pools
(gain.rs:103-108, speed.rs:32-36 semantics on the device control plane)."""

import numpy as np

import oddio_tpu as ot


class _HostGain(ot.Gain):
    """Forces the host pool path (the golden-matched baseline)."""

    def dr_supported(self):
        return False


class _HostSpeed(ot.Speed):
    def dr_supported(self):
        return False


def test_mixer_gain_dr_matches_host():
    """Gain-wrapped chains ride the DR mixer pool; a mid-stream set_gain
    ramps identically to the host path (the only divergence is the Sine DR
    phase quantization, ~2e-5/voice/block)."""
    outs = []
    for G in (ot.Gain, _HostGain):
        control, mixer = ot.Mixer.new(channels=1)
        gcs = []
        for i in range(6):
            gc, g = G.new(ot.Sine(0.1 * i, 200.0 + 50 * i))
            gcs.append(gc)
            control.play(g)
        pool = list(mixer._pools.values())[0]
        assert pool.is_dr == (G is ot.Gain)
        r = ot.Renderer(mixer, 8000)
        a = r.render_frames(1024)
        for gc in gcs[::2]:
            gc.set_gain(-12.0)
        gcs[1].set_amplitude_ratio(2.0)
        b = r.render_frames(2048)
        # handle getters read the mirror regardless of pool kind
        assert abs(gcs[0].gain() - (-12.0)) < 1e-4
        assert abs(gcs[1].amplitude_ratio() - 2.0) < 1e-6
        outs.append(np.concatenate([a, b]))
    err = np.abs(outs[0] - outs[1]).max()
    assert err < 5e-4, err


def test_mixer_speed_dr_matches_host():
    """Speed-wrapped FramesSignal chains: the DR pool re-derives the warped
    per-voice step in-graph; output matches the host pool's f32 parameter
    flow except cursor-split rounding (<= ~1e-5)."""
    frames_data = np.sin(np.linspace(0, 300, 4000)).astype(np.float32)
    outs = []
    for S in (ot.Speed, _HostSpeed):
        frames = ot.Frames.from_slice(8000, frames_data)
        control, mixer = ot.Mixer.new(channels=1)
        scs = []
        for j in range(4):
            sc, s = S.new(ot.FramesSignal(frames, 0.0))
            scs.append(sc)
            control.play(s)
        pool = list(mixer._pools.values())[0]
        assert pool.is_dr == (S is ot.Speed)
        r = ot.Renderer(mixer, 8000)
        a = r.render_frames(1024)
        for j, sc in enumerate(scs):
            sc.set_speed(0.5 + 0.5 * j)
        b = r.render_frames(1024)
        assert abs(scs[2].speed() - 1.5) < 1e-6
        outs.append(np.concatenate([a, b]))
    err = np.abs(outs[0] - outs[1]).max()
    assert err < 1e-4, err


def test_spatial_buffered_gain_dr():
    """Gain chains inside the buffered spatial DR pool: set_gain mid-flight
    scales the spatialized output with the 0.1 s ramp."""
    control, scene = ot.SpatialScene.new()
    gc, g = ot.Gain.new(ot.Sine(0.0, 250.0))
    h = control.play_buffered(
        g, ot.SpatialOptions(position=[0.0, 0.0, -2.0]),
        max_distance=10.0, rate=8000, buffer_duration=0.05,
    )
    pool = list(scene._buffered_pools.values())[0]
    assert pool.is_dr
    r = ot.Renderer(scene, 8000)
    loud = r.render_frames(2048)
    gc.set_amplitude_ratio(0.0)
    r.render_frames(1024)  # 0.1 s ramp (800 frames) completes
    quiet = r.render_frames(1024)
    assert np.sqrt((quiet**2).mean()) < 1e-3 * np.sqrt((loud**2).mean())


def test_ctrl_retrace_containment():
    """set_gain traffic reuses the existing delta step variant."""
    control, mixer = ot.Mixer.new(channels=1)
    gcs = []
    for i in range(4):
        gc, g = ot.Gain.new(ot.Sine(0.0, 300.0 + i))
        gcs.append(gc)
        control.play(g)
    r = ot.Renderer(mixer, 8000)
    r.render_block(256)  # delta variant
    r.render_block(256)  # idle variant
    warm = set(r._steps.keys())
    assert len(warm) == 2
    for i in range(6):
        if i % 2:
            gcs[i % 4].set_gain(-6.0 * i)
        r.render_block(256)
    assert set(r._steps.keys()) == warm


def test_ctrl_stale_handle_noop():
    """Writes through a handle of a reclaimed voice are dropped (slot
    generations), like the reference's orphaned atomics."""
    frames = ot.Frames.from_slice(8000, np.ones(64, np.float32))
    control, mixer = ot.Mixer.new(channels=1)
    gc, g = ot.Gain.new(ot.FramesSignal(frames, 0.0))
    h = control.play(g)
    pool = list(mixer._pools.values())[0]
    assert pool.is_dr
    r = ot.Renderer(mixer, 8000, sync_every=1)
    for _ in range(4):  # source finishes, voice reclaimed
        r.render_block(256)
    assert h.is_stopped()
    gc2, g2 = ot.Gain.new(ot.FramesSignal(ot.Frames.from_slice(8000, np.full(2048, 0.5, np.float32)), 0.0))
    h2 = control.play(g2)  # reuses the slot
    gc.set_amplitude_ratio(0.0)  # stale: must not touch the new voice
    out = r.render_frames(512)
    assert np.abs(out).max() > 0.4


def test_adapt_limit_dr_matches_host():
    """Adapt (AGC) and Reinhard/Tanh chains ride DR mixer pools and match
    the host-pool path."""
    class _HostAdapt(ot.Adapt):
        def dr_supported(self):
            return False

    outs = []
    for A in (ot.Adapt, _HostAdapt):
        control, mixer = ot.Mixer.new(channels=1)
        for i in range(4):
            chain = ot.Tanh(ot.Reinhard(A(
                ot.FixedGain(ot.Sine(0.2 * i, 150.0 + 80 * i), 12.0),
                0.05, ot.AdaptOptions(tau=0.05, max_gain=4.0),
            )))
            control.play(chain)
        pool = list(mixer._pools.values())[0]
        assert pool.is_dr == (A is ot.Adapt)
        r = ot.Renderer(mixer, 8000)
        outs.append(r.render_frames(2048))
    err = np.abs(outs[0] - outs[1]).max()
    assert err < 2e-5, err


def test_frames_control_readout_in_dr_pool():
    """playback_position()/is_finished() on a FramesSignal handle keep
    working when the voice lives in a device-resident pool
    (frames.rs:238-247 getters are API surface)."""
    frames = ot.Frames.from_slice(8000, np.ones(2000, np.float32))
    fc, f = ot.FramesSignal.new(frames, 0.0)
    control, mixer = ot.Mixer.new(channels=1)
    control.play(f)
    pool = list(mixer._pools.values())[0]
    assert pool.is_dr
    assert fc.playback_position() == 0.0  # queued play: mirror is current
    r = ot.Renderer(mixer, 8000)
    r.render_frames(1024)
    pos = fc.playback_position()
    assert abs(pos - 1024 / 8000) < 1e-6, pos
    assert not fc.is_finished()
    r.render_frames(1024)
    assert fc.is_finished()


class _HostFrames(ot.FramesSignal):
    """Forces the host pool for comparison."""

    def dr_supported(self):
        return False


def test_stereo_dr_mixer_pool_matches_host():
    """Frame-generic DR chains (frame.rs:67-79, stream.rs:6): stereo
    FramesSignal (per-channel guarded planes at a derivable stride) under
    Gain in a DR mixer pool matches the host pool, including a smoothed
    set_gain mid-flight."""
    rng = np.random.default_rng(9)
    data = (rng.standard_normal((3000, 2)) * 0.3).astype(np.float32)
    snd = ot.Frames.from_slice(8000, data)

    def build(cls):
        mc, mixer = ot.Mixer.new(channels=2)
        gcs = []
        for i in range(5):
            gc, g = ot.Gain.new(cls(snd, -0.01 * i))
            gcs.append(gc)
            mc.play(g)
        return mixer, gcs

    outs = []
    for cls in (ot.FramesSignal, _HostFrames):
        mixer, gcs = build(cls)
        pool = next(iter(mixer._pools.values()))
        assert pool.is_dr == (cls is ot.FramesSignal)
        r = ot.Renderer(mixer, 8000)
        blocks = [r.render_frames(512)]
        gcs[0].set_gain(-6.0)
        blocks.append(r.render_frames(1024))
        outs.append(np.concatenate(blocks))
    # tolerance: the host pool re-derives block starts from the f64 cursor
    # (frames.rs:198 accumulates the f32 interval), giving fractional
    # positions ~1e-4 samples off the DR path's snapped exact-unit step;
    # on white noise (slope ~0.4/sample) that is ~1e-4 amplitude.  A
    # channel-routing bug would be O(1).
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-3)


def test_stereo_dr_constant_and_channel_adapters():
    """Stereo Constant, MonoToStereo and Downmix run device-resident in
    mixer pools."""
    mc, mixer = ot.Mixer.new(channels=2)
    mc.play(ot.Constant((0.25, -0.5)))
    mc.play(ot.MonoToStereo(ot.Sine(0.0, 100.0)))
    assert all(p.is_dr for p in mixer._pools.values())
    out = ot.Renderer(mixer, 8000).render_block(256)
    t = np.arange(256) / 8000
    exp = np.sin(2 * np.pi * 100.0 * t)
    np.testing.assert_allclose(out[:, 0], 0.25 + exp, atol=1e-4)
    np.testing.assert_allclose(out[:, 1], -0.5 + exp, atol=1e-4)

    mc2, mono = ot.Mixer.new(channels=1)
    mc2.play(ot.Downmix(ot.Constant((0.25, -0.5))))
    assert all(p.is_dr for p in mono._pools.values())
    out2 = ot.Renderer(mono, 8000).render_block(64)
    np.testing.assert_allclose(out2[:, 0], -0.25, atol=1e-6)


def test_stereo_dr_adapt_matches_host():
    """Frame-generic DR Adapt (adapt.rs:63-88 is generic over Frame):
    stereo Adapt(FramesSignal) rides the DR mixer pool and matches the
    host pool — the summed-channel level drives one gain per frame that
    scales both channels."""
    rng = np.random.default_rng(11)
    data = (rng.standard_normal((4000, 2)) * 0.4).astype(np.float32)
    # make the AGC actually move: a loud then quiet section
    data[:1500] *= 2.0
    data[1500:] *= 0.1
    snd = ot.Frames.from_slice(8000, data)

    def build(cls):
        mc, mixer = ot.Mixer.new(channels=2)
        for i in range(3):
            mc.play(ot.Adapt(
                cls(snd, -0.01 * i), 0.2,
                ot.AdaptOptions(tau=0.05, low=0.1, high=0.3, max_gain=3.0),
            ))
        return mixer

    outs = []
    for cls in (ot.FramesSignal, _HostFrames):
        mixer = build(cls)
        pool = next(iter(mixer._pools.values()))
        assert pool.is_dr == (cls is ot.FramesSignal)
        r = ot.Renderer(mixer, 8000)
        outs.append(np.concatenate([r.render_frames(512),
                                    r.render_frames(1024)]))
    assert np.abs(outs[0]).max() > 0.01
    # same tolerance rationale as test_stereo_dr_mixer_pool_matches_host
    # (f64-cursor vs snapped device-cursor fractional positions on noise)
    np.testing.assert_allclose(outs[0], outs[1], atol=2e-3)


def test_buffered_spatial_retrace_containment():
    """A live buffered DR scene alternates between exactly two step
    variants (idle + control-delta): plays, set_motion, set_gain and
    fade_to after warmup never trigger a fresh compile (the reference's
    'no glitches' wait-free contract, README.md:11)."""
    rng = np.random.default_rng(4)
    control, scene = ot.SpatialScene.new(initial_capacity=16)
    handles, gcs, fcs = [], [], []
    for _ in range(6):
        gc, g = ot.Gain.new(ot.Sine(rng.uniform(0, 6), rng.uniform(100, 900)))
        fc, f = ot.Fader.new(g)
        gcs.append(gc)
        fcs.append(fc)
        handles.append(control.play_buffered(
            f, ot.SpatialOptions(position=rng.uniform(-10, 10, 3),
                                 velocity=rng.uniform(-3, 3, 3)),
            max_distance=30.0, rate=8000, buffer_duration=0.05,
        ))
    pool = list(scene._buffered_pools.values())[0]
    assert pool.is_dr
    r = ot.Renderer(scene, 8000)
    r.render_block(512)  # delta variant (the queued plays)
    r.render_block(512)  # idle variant
    warm = set(r._steps.keys())
    assert len(warm) == 2
    for i in range(8):
        if i == 1:
            handles[0].set_motion([3.0, 0.0, -2.0], [1.0, 0.0, 0.0], False)
        if i == 2:
            gcs[1].set_gain(-9.0)
        if i == 3:
            fcs[2].fade_to(
                ot.Gain.new(ot.Sine(0.2, 500.0))[1], 0.05
            )
        if i == 5:  # one more play within capacity
            handles.append(control.play_buffered(
                ot.Fader.new(ot.Gain.new(ot.Sine(0.3, 700.0))[1])[1],
                ot.SpatialOptions(position=[1.0, 0.0, -1.0]),
                max_distance=30.0, rate=8000, buffer_duration=0.05,
            ))
        out = r.render_block(512)
        assert np.isfinite(out).all()
    assert set(r._steps.keys()) == warm, "control traffic caused a retrace"


def test_idle_slot_cursors_hold():
    """Dead/unplayed slots must not advance their inner cursors
    (an idle slot's int32 sample cursor would wrap after ~12 h at 48 kHz,
    corrupting lingering is_finished readbacks)."""
    control, scene = ot.SpatialScene.new()
    frames = ot.Frames.from_slice(8000, np.ones(64, np.float32))
    h = control.play_buffered(
        ot.FramesSignal(frames, 0.0),
        ot.SpatialOptions(position=[0.5, 0.0, -0.5]),
        max_distance=5.0, rate=8000, buffer_duration=0.02,
    )
    pool = list(scene._buffered_pools.values())[0]
    assert pool.is_dr
    r = ot.Renderer(scene, 8000, sync_every=1)
    for _ in range(8):  # source (64 frames) finishes and reclaims
        r.render_block(256)
    assert h.is_finished()
    base1 = int(np.asarray(pool.state["inner"]["base"])[0])
    for _ in range(6):
        r.render_block(256)
    base2 = int(np.asarray(pool.state["inner"]["base"])[0])
    assert base1 == base2, (base1, base2)


def test_stale_handle_mirror_still_readable():
    """Set-after-death still updates what get() reads back
    (gain.rs:130-139 — the reference's orphaned atomics stay writable);
    only the device delta is dropped."""
    frames = ot.Frames.from_slice(8000, np.ones(32, np.float32))
    control, mixer = ot.Mixer.new(channels=1)
    gc, g = ot.Gain.new(ot.FramesSignal(frames, 0.0))
    h = control.play(g)
    r = ot.Renderer(mixer, 8000, sync_every=1)
    for _ in range(4):
        r.render_block(256)
    assert h.is_stopped()
    gc.set_gain(-18.0)  # voice dead: mirror updates, no device write
    assert abs(float(gc.gain()) - (-18.0)) < 1e-4
