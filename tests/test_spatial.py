"""SpatialScene tests: the reference's reclamation test plus physical sanity
checks (panning, attenuation, propagation delay, doppler)."""

import numpy as np
import pytest

import oddio_tpu as ot
from oddio_tpu.core.hostmath import quat_rotate


def sample(scene, interval, n, renderer_rate=1):
    r = getattr(scene, "_test_renderer", None)
    if r is None:
        r = ot.Renderer(scene, renderer_rate)
        scene._test_renderer = r
    return r.render_block(n, interval=np.float32(interval))


class FinishedSignal(ot.Constant):
    """spatial.rs:611-627: a signal that is immediately finished."""

    def __init__(self):
        super().__init__(0.0)

    def host_is_finished(self):
        return np.ones(self.batch, dtype=bool)


def test_signal_finished_lingers_for_propagation():
    """spatial.rs:629-665: a finished source is dropped only after its
    propagation delay has elapsed."""
    control, scene = ot.SpatialScene.new()
    handle = control.play(
        FinishedSignal(),
        ot.SpatialOptions(position=[float(ot.SPEED_OF_SOUND), 0.0, 0.0]),
    )
    pool = list(scene._seek_pools.values())[0]

    sample(scene, 0.0, 1)
    assert pool.mask.sum() == 1, "signal remains after no time has passed"
    sample(scene, 0.6, 1)
    assert pool.mask.sum() == 1, "signal remains partway through propagation"
    sample(scene, 0.6, 1)
    assert pool.mask.sum() == 1, "signal remains immediately after delay expires"
    assert not handle.is_finished()
    sample(scene, 0.0, 1)
    assert pool.mask.sum() == 0, "signal dropped on first pass after delay expires"
    assert handle.is_finished()


def test_render_block_auto_sync():
    """Handle state syncs periodically in render_block-only streaming
    (mixer.rs:102-105 visibility in the DR pool): is_finished() flips and
    the slot is reclaimed without ever calling render_frames/sync()."""
    control, scene = ot.SpatialScene.new()
    frames = ot.Frames.from_slice(8000, np.ones(100, np.float32))
    h = control.play_buffered(
        ot.FramesSignal(frames, 0.0),
        ot.SpatialOptions(position=[1.0, 0.0, 0.0]),
        max_distance=10.0,
        rate=8000,
        buffer_duration=0.05,
    )
    pool = list(scene._buffered_pools.values())[0]
    assert pool.is_dr
    r = ot.Renderer(scene, 8000, sync_every=4)
    for _ in range(40):  # 100 frames of source + linger + sync cadence
        r.render_block(256)
    assert h.is_finished()
    assert pool.mask_host.sum() == 0
    assert len(pool._free) == pool.capacity


def render_position(position, seek=True, frames_hz=200.0, rate=8000, blocks=8):
    """Render a sine at a fixed position; returns (nblocks*512, 2)."""
    control, scene = ot.SpatialScene.new()
    sig = ot.Sine(0.0, frames_hz)
    opts = ot.SpatialOptions(position=position)
    if seek:
        control.play(sig, opts)
    else:
        control.play_buffered(sig, opts, max_distance=50.0, rate=rate,
                              buffer_duration=0.1)
    r = ot.Renderer(scene, rate)
    return np.concatenate([r.render_block(512) for _ in range(blocks)])


@pytest.mark.parametrize("seek", [True, False])
def test_panning(seek):
    """A source on the right is louder in the right ear."""
    out = render_position([5.0, 0.0, 0.0], seek=seek)
    tail = out[2048:]  # skip propagation-delay onset
    rms = np.sqrt((tail**2).mean(axis=0))
    assert rms[1] > 3.0 * rms[0], rms


@pytest.mark.parametrize("seek", [True, False])
def test_distance_attenuation(seek):
    near = render_position([0.0, 0.0, -2.0], seek=seek)
    far = render_position([0.0, 0.0, -20.0], seek=seek)
    rms_near = np.sqrt((near[4000:] ** 2).mean())
    rms_far = np.sqrt((far[4000:] ** 2).mean())
    # gain = radius / distance => 10x farther = 10x quieter
    assert rms_near / rms_far == pytest.approx(10.0, rel=0.05)


def test_propagation_delay_buffered():
    """A buffered source at 34.3 m starts 0.1 s late."""
    out = render_position([0.0, 0.0, -34.3], seek=False, rate=8000, blocks=4)
    onset = np.argmax(np.abs(out[:, 0]) > 1e-4)
    assert onset == pytest.approx(800, abs=16), onset  # 0.1 s at 8 kHz


def test_listener_rotation():
    """Rotating the listener 180 deg about +Y swaps the ears."""
    control, scene = ot.SpatialScene.new()
    control.play(ot.Sine(0.0, 200.0), ot.SpatialOptions(position=[5.0, 0.0, 0.0]))
    # quaternion for 180 deg about Y: (cos90, 0, sin90, 0) = (0, 0, 1, 0)
    control.set_listener_rotation([0.0, 0.0, 1.0, 0.0])
    r = ot.Renderer(scene, 8000)
    out = np.concatenate([r.render_block(512) for _ in range(8)])
    tail = out[2048:]
    rms = np.sqrt((tail**2).mean(axis=0))
    assert rms[0] > 3.0 * rms[1], rms  # now louder in the LEFT ear


@pytest.mark.parametrize("seek", [True, False])
def test_doppler_shift(seek):
    """A source approaching at 34.3 m/s reads ~10% sharp (f' = f/(1 - v/c))."""
    control, scene = ot.SpatialScene.new()
    sig = ot.Sine(0.0, 400.0)
    # stays >= 45 m in front of the listener for the whole ~3 s of motion
    # (t runs 1.0 -> ~3.0, so z reaches z0 + ~103 m)
    z0 = -150.0
    opts = ot.SpatialOptions(position=[0.0, 0.0, z0], velocity=[0.0, 0.0, 34.3])
    if seek:
        h = control.play(sig, opts)
    else:
        h = control.play_buffered(sig, opts, max_distance=100.0, rate=8000,
                                  buffer_duration=0.1)
    rate = 8000
    r = ot.Renderer(scene, rate)
    # prime 1 s so smoothing settles, then give fresh motion every block
    t = 1.0
    chunks = []
    for i in range(2 * rate // 512):
        pos = [0.0, 0.0, z0 + 34.3 * t]
        h.set_motion(pos, [0.0, 0.0, 34.3], False)
        blk = r.render_block(512)
        t += 512 / rate
        if i >= rate // 512:
            chunks.append(blk)
    out = np.concatenate(chunks)[:, 0] + np.concatenate(chunks)[:, 1]
    spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
    peak_hz = np.argmax(spec) * rate / len(out)
    expected = 400.0 / (1.0 - 34.3 / 343.0)  # about 444 Hz
    assert peak_hz == pytest.approx(expected, abs=6.0), peak_hz


def test_buffered_voice_reuse_and_growth():
    control, scene = ot.SpatialScene.new()
    handles = [
        control.play_buffered(
            ot.Sine(0.0, 100.0 + 10 * i),
            ot.SpatialOptions(position=[0.0, 0.0, -1.0]),
            max_distance=10.0,
            rate=8000,
            buffer_duration=0.1,
        )
        for i in range(20)  # > initial capacity -> grow
    ]
    r = ot.Renderer(scene, 8000)
    out = r.render_block(512)
    assert np.abs(out).max() > 0
    assert not handles[0].is_finished()


def test_motion_smoothing_no_click():
    """A position jump without discontinuity glides (0.5 s smoothing) —
    output stays continuous."""
    control, scene = ot.SpatialScene.new()
    h = control.play(ot.Sine(0.0, 50.0), ot.SpatialOptions(position=[0.0, 0.0, -2.0]))
    r = ot.Renderer(scene, 8000)
    r.render_block(512)
    h.set_motion([0.0, 0.0, -40.0], [0.0, 0.0, 0.0], False)
    blocks = np.concatenate([r.render_block(512) for _ in range(8)])
    diffs = np.abs(np.diff(blocks[:, 0]))
    assert diffs.max() < 0.05, diffs.max()  # no step discontinuity


def test_quat_rotate_axes():
    """math/mod.rs:101-129: quaternion rotation sanity on all three axes."""

    def axis_angle(axis, angle):
        half = angle * 0.5
        return np.float32([np.cos(half)] + [a * np.sin(half) for a in axis])

    p = np.float32([[0.0, 0.0, -1.0]])
    q = axis_angle([1.0, 0.0, 0.0], np.pi / 2)
    rp = quat_rotate(q[None], p)[0]
    assert rp[0] == 0.0 and abs(rp[1] - 1.0) < 1e-3

    p = np.float32([[1.0, 0.0, 0.0]])
    q = axis_angle([0.0, 1.0, 0.0], np.pi / 2)
    rp = quat_rotate(q[None], p)[0]
    assert abs(rp[2] + 1.0) < 1e-3

    p = np.float32([[0.0, 1.0, 0.0]])
    q = axis_angle([0.0, 0.0, 1.0], np.pi / 2)
    rp = quat_rotate(q[None], p)[0]
    assert abs(rp[0] + 1.0) < 1e-3


def test_stream_as_buffered_spatial_source():
    """play_buffered accepts arbitrary (non-deterministic) signals — here a
    Stream — via the device-resident pool (spatial.rs:304-340): the ring
    AND its cursors live on device, PCM ships as per-block ingest."""
    control, scene = ot.SpatialScene.new()
    sc, stream = ot.Stream.new(8000, 4096)
    h = control.play_buffered(
        stream, ot.SpatialOptions(position=[0.0, 0.0, -2.0]),
        max_distance=10.0, rate=8000, buffer_duration=0.1,
    )
    pool = list(scene._buffered_pools.values())[0]
    assert getattr(pool, "is_dr", False)  # bare streams ride the DR pool
    sc.write(np.sin(np.arange(4000) * 0.3).astype(np.float32))
    r = ot.Renderer(scene, 8000)
    out = np.concatenate([r.render_block(512) for _ in range(4)])
    assert np.abs(out).max() > 0.01
    # both ears hear the centered source roughly equally
    rms = np.sqrt((out[1024:] ** 2).mean(axis=0))
    assert abs(rms[0] - rms[1]) < 0.3 * rms.max()


def test_filters_wrap_scene():
    """Scenes compose like any Signal: SpatialScene -> Reinhard -> Tanh."""
    control, scene = ot.SpatialScene.new()
    control.play(ot.FixedGain(ot.Sine(0.0, 200.0), 24.0),
                 ot.SpatialOptions(position=[0.0, 0.0, -0.05]))
    chain = ot.Tanh(ot.Reinhard(scene))
    r = ot.Renderer(chain, 8000)
    out = r.render_block(512)
    assert np.abs(out).max() <= np.tanh(1.0) + 1e-6  # limited
    assert np.abs(out).max() > 0.4


def _static_dr_scene(buffered, V=12):
    rng = np.random.default_rng(5)
    control, scene = ot.SpatialScene.new()
    for _ in range(V):
        sig = ot.Sine(rng.uniform(0, 6), rng.uniform(100, 2000))
        opts = ot.SpatialOptions(position=rng.uniform(-20, 20, 3))
        if buffered:
            # buffer deep enough that a whole 2048-frame block's look-back
            # stays unclamped (spatial.rs:414-415 clamps reads at
            # -max_delay, which legitimately makes audio depend on block
            # size once elapsed + distance/c exceeds it)
            control.play_buffered(sig, opts, max_distance=40.0, rate=8000,
                                  buffer_duration=0.4)
        else:
            control.play(sig, opts)
    return scene


@pytest.mark.parametrize("buffered", [False, True])
def test_large_blocks_match_chunked(buffered):
    """Blocks beyond one read chunk (n > 640) render via internal
    <=512-frame chunking (signal.rs:19 takes any output length).  With
    static geometry the per-block walk is the identity, so one 2048-frame
    block must equal four 512-frame blocks (up to the ~1-ulp cursor
    re-baseline between chunks)."""
    a = ot.Renderer(_static_dr_scene(buffered), 8000).render_block(2048)
    r = ot.Renderer(_static_dr_scene(buffered), 8000)
    b = np.concatenate([r.render_block(512) for _ in range(4)])
    np.testing.assert_allclose(a, b, atol=2e-5)


class _HostSeekSine(ot.Sine):
    """Forces the host seek pool (the golden-matched path) for comparison."""

    def dr_seek_supported(self):
        return False


def _build_seek_scene(cls, V=24, rng_seed=7):
    rng = np.random.default_rng(rng_seed)
    control, scene = ot.SpatialScene.new()
    handles = []
    for _ in range(V):
        h = control.play(
            cls(rng.uniform(0, 6), rng.uniform(50, 2000)),
            ot.SpatialOptions(
                position=rng.uniform(-20, 20, 3), velocity=rng.uniform(-5, 5, 3)
            ),
        )
        handles.append(h)
    return control, scene, handles


def test_seek_pool_dr_matches_host():
    """The device-resident seek pool reproduces the host seek pool
    (spatial.rs:438-470 semantics) within f32 seek-phase rounding: the host
    path shifts sine phase in f64, the reference and the DR path in f32
    (sine.rs:25-28), bounded by ~eps*|t*freq| per block."""
    rate = 8000
    outs = []
    for cls in (ot.Sine, _HostSeekSine):
        rng = np.random.default_rng(3)
        control, scene, handles = _build_seek_scene(cls)
        pool = list(scene._seek_pools.values())[0]
        assert getattr(pool, "is_dr", False) == (cls is ot.Sine)
        r = ot.Renderer(scene, rate)
        pieces = [r.render_frames(512 * 2)]
        # motion updates + listener rotation mid-stream
        for h in handles[::3]:
            h.set_motion(rng.uniform(-20, 20, 3), rng.uniform(-5, 5, 3), False)
        handles[1].set_motion([1.0, 0.0, -2.0], [0.0, 0.0, 0.0], True)
        control.set_listener_rotation([0.96592583, 0.0, 0.25881905, 0.0])
        pieces.append(r.render_frames(512 * 2))
        outs.append(np.concatenate(pieces))
    err = np.abs(outs[0] - outs[1]).max()
    assert err < 5e-4, err


def test_seek_pool_dr_lifecycle():
    """Growth, slot reuse and handle liveness on the DR seek pool."""
    control, scene = ot.SpatialScene.new(initial_capacity=2)
    hs = []
    for i in range(5):  # force two growths
        hs.append(
            control.play(ot.Sine(0.0, 100.0 + i), ot.SpatialOptions(position=[1.0, 0.0, 0.0]))
        )
    pool = list(scene._seek_pools.values())[0]
    assert pool.is_dr and pool.capacity == 8
    r = ot.Renderer(scene, 8000)
    out = r.render_frames(512)
    assert np.isfinite(out).all() and np.abs(out).max() > 0
    assert not hs[0].is_finished()
    # motion through a stale handle is a no-op after reclamation
    hs[0].set_motion([2.0, 0.0, 0.0], [0.0, 0.0, 0.0], False)
    out2 = r.render_frames(512)
    assert np.isfinite(out2).all()


def test_seek_pool_dr_fixedgain_chain():
    """FixedGain(Sine) chains ride the DR seek pool (gain.rs:44-51 forwards
    Seek) and scale output exactly."""
    def build(db):
        control, scene = ot.SpatialScene.new()
        control.play(
            ot.FixedGain(ot.Sine(0.25, 330.0), db),
            ot.SpatialOptions(position=[0.0, 0.0, -2.0]),
        )
        return scene

    base = ot.Renderer(build(0.0), 8000).render_frames(1024)
    loud = ot.Renderer(build(6.0), 8000).render_frames(1024)
    pool_arch_is_dr = True
    ratio = np.float32(10.0) ** np.float32(6.0 / 20.0)
    np.testing.assert_allclose(loud, base * ratio, rtol=1e-5, atol=1e-7)


class _HostSeekFrames(ot.FramesSignal):
    def dr_seek_supported(self):
        return False


class _HostSeekCycle(ot.Cycle):
    def dr_seek_supported(self):
        return False


def test_seek_pool_dr_frames_cycle_matches_host():
    """Sampler voices (FramesSignal, Cycle) on the device-resident seek
    path: per-ear warped resampling through the exact arena gather matches the
    host seek pool (f32 shift products vs host f64, <= ~2e-5)."""
    rng = np.random.default_rng(9)
    snd = ot.Frames.from_slice(
        8000, (np.sin(np.linspace(0, 700, 12000)) * 0.7).astype(np.float32)
    )
    tbl = ot.Frames.from_slice(8000, rng.standard_normal(997).astype(np.float32))

    def build(host, rng):
        FS = _HostSeekFrames if host else ot.FramesSignal
        CY = _HostSeekCycle if host else ot.Cycle
        control, scene = ot.SpatialScene.new()
        hs = []
        for i in range(5):
            hs.append(control.play(FS(snd, -0.02 * i), ot.SpatialOptions(
                position=rng.uniform(-15, 15, 3), velocity=rng.uniform(-4, 4, 3))))
        for i in range(4):
            c = CY(tbl)
            c.seek(0.01 * i)
            hs.append(control.play(c, ot.SpatialOptions(
                position=rng.uniform(-15, 15, 3), velocity=rng.uniform(-4, 4, 3))))
        return scene, hs

    outs = []
    for host in (False, True):
        rng = np.random.default_rng(9)
        scene, hs = build(host, rng)
        assert all(
            getattr(p, "is_dr", False) != host
            for p in scene._seek_pools.values()
        )
        r = ot.Renderer(scene, 8000)
        a = r.render_frames(1024)
        for h in hs[::2]:
            h.set_motion(rng.uniform(-15, 15, 3), rng.uniform(-4, 4, 3), False)
        b = r.render_frames(2048)
        outs.append(np.concatenate([a, b]))
    err = np.abs(outs[0] - outs[1]).max()
    assert err < 5e-5, err


def test_seek_pool_dr_frames_finish_lingers():
    """A FramesSignal seek-DR voice finishes on device, lingers for its
    propagation delay, then frees the slot (spatial.rs:241-261)."""
    frames = ot.Frames.from_slice(8000, np.ones(400, np.float32))
    control, scene = ot.SpatialScene.new()
    h = control.play(
        ot.FramesSignal(frames, 0.0),
        ot.SpatialOptions(position=[3.0, 0.0, 0.0]),
    )
    pool = list(scene._seek_pools.values())[0]
    assert pool.is_dr
    r = ot.Renderer(scene, 8000, sync_every=1)
    for _ in range(6):  # 400 frames source + linger + sync cadence
        r.render_block(256)
    assert h.is_finished()
    assert pool.mask_host.sum() == 0


def test_seek_pool_dr_voice_churn():
    """Sustained play/finish churn on the DR seek pool: finite sampler
    voices finish on device, slots recycle across generations, stale
    handles stay inert, and the mix stays finite."""
    rng = np.random.default_rng(21)
    frames = ot.Frames.from_slice(8000, np.ones(300, np.float32) * 0.1)
    control, scene = ot.SpatialScene.new(initial_capacity=8)
    r = ot.Renderer(scene, 8000, sync_every=2)
    handles = []
    for step in range(30):
        if step % 2 == 0:
            handles.append(control.play(
                ot.FramesSignal(frames, 0.0),
                ot.SpatialOptions(position=rng.uniform(-5, 5, 3)),
            ))
        if handles and step % 5 == 0:
            handles[rng.integers(len(handles))].set_motion(
                rng.uniform(-5, 5, 3), [0.0, 0.0, 0.0], False)
        out = r.render_block(256)
        assert np.isfinite(out).all()
    pool = list(scene._seek_pools.values())[0]
    assert pool.is_dr
    scene.sync()
    # every voice (300 frames + linger) has finished and been reclaimed
    for _ in range(8):
        r.render_block(256)
    scene.sync()
    assert pool.mask_host.sum() == 0
    assert len(pool._free) == pool.capacity
    assert all(h.is_finished() for h in handles)
    assert pool.slot_gen.sum() >= len(handles) - pool.capacity


def test_submix_play_buffered():
    """play_buffered accepts NON-BATCHABLE signals — a whole Mixer played
    as one spatial voice (spatial.rs:314-340 boxes any Signal): the submix
    renders unbatched in a singleton pool, is spatialized/panned, honors
    inner-voice control, and checkpoints through the aux hook."""
    from oddio_tpu.utils.checkpoint import restore, snapshot

    mc, mixer = ot.Mixer.new(channels=1)
    mc.play(ot.Sine(0.0, 300.0))
    h_inner = mc.play(ot.Sine(0.0, 520.0))
    sc, scene = ot.SpatialScene.new()
    h = sc.play_buffered(
        mixer, ot.SpatialOptions(position=[2.0, 0.0, -1.0]),
        max_distance=20.0, rate=8000,
    )
    pool = next(iter(scene._buffered_pools.values()))
    assert getattr(pool, "is_singleton", False)
    r = ot.Renderer(scene, 8000)
    out = r.render_frames(4096)
    spec = np.abs(np.fft.rfft(out[2048:, 0]))
    peaks = set((np.argsort(spec)[-2:] * 8000 // 2048).tolist())
    assert any(abs(p - 300) < 16 for p in peaks)
    assert any(abs(p - 520) < 16 for p in peaks)
    # source to the right -> right ear louder
    assert np.sqrt((out[:, 1] ** 2).mean()) > np.sqrt((out[:, 0] ** 2).mean())
    assert not h.is_finished()  # a mixer voice never finishes on its own

    snap = snapshot(scene)
    h_inner.stop()
    a = np.asarray(r.render_frames(2048))
    spec2 = np.abs(np.fft.rfft(a[1024:, 0]))
    assert abs(np.argmax(spec2) * 8000 / 1024 - 300) < 16  # 520 gone

    restore(scene, snap)
    b = np.asarray(r.render_frames(2048))
    spec3 = np.abs(np.fft.rfft(b[1024:, 0]))
    top2 = set((np.argsort(spec3)[-2:] * 8000 // 1024).tolist())
    assert any(abs(p - 520) < 16 for p in top2)  # restored pre-stop state


def test_tier_observability_getters():
    """SpatialSceneControl.read_tiers()/tier_events(): the active read
    plan (tier, sub-pass occupancy, frozen/band counts, demotion flag) is
    user-visible, and tier transitions are logged — a demoted pool must be
    diagnosable without reading bench stderr."""
    RATE = 8000
    control, scene = ot.SpatialScene.new()
    control.play_buffered(
        ot.Sine(0.0, 440.0), ot.SpatialOptions(position=[5.0, 0.0, 0.0]),
        max_distance=10.0, rate=RATE, buffer_duration=0.1,
    )
    # beyond (10/343 + 0.1)*343 = 44.3 m: certainly frozen (ds = 0)
    control.play_buffered(
        ot.Sine(0.0, 300.0), ot.SpatialOptions(position=[100.0, 0.0, 0.0]),
        max_distance=10.0, rate=RATE, buffer_duration=0.1,
    )
    r = ot.Renderer(scene, RATE)
    r.render_frames(512 * 2)
    (info,) = control.read_tiers().values()
    assert info["kind"] == "dr"
    assert info["read_cfg"] is not None and info["read_cfg"][0] == 512
    assert not info["demoted"]
    assert info["frozen"] == 1 and info["band"] == 0
    assert info["listed"] == 0 and info["sub_cfg"] is None
    ev = control.tier_events()
    assert ev and all(len(e) == 4 for log in ev.values() for e in log)
    assert control.tier_events() == {}  # drained

    # a ~100 m/s mover joins the family sub-pass; the pool stays tight
    # and the transition lands in the event log
    control.play_buffered(
        ot.Sine(0.0, 200.0),
        ot.SpatialOptions(position=[4.0, 0.0, 0.0], velocity=[100.0, 0.0, 0.0]),
        max_distance=10.0, rate=RATE, buffer_duration=0.1,
    )
    r.render_frames(512 * 2)
    (info,) = control.read_tiers().values()
    assert info["read_cfg"][0] == 512 and not info["demoted"]
    assert info["listed"] == 1 and info["sub_cfg"] is not None
    ev = control.tier_events()
    assert ev, "sub-pass engagement must log a tier event"
