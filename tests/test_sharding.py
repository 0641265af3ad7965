"""Multi-device sharding tests on the virtual 8-CPU-device mesh: the sharded
ScenePack must produce the same audio as per-scene single-device Renderers."""

import numpy as np
import pytest

import jax

import oddio_tpu as ot
from oddio_tpu.parallel.mesh import make_mesh
from oddio_tpu.parallel.sharded import ScenePack


def need_devices(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def build_spatial_scene(seed):
    rng = np.random.default_rng(seed)
    control, scene = ot.SpatialScene.new()
    handles = []
    for i in range(8):
        opts = ot.SpatialOptions(
            position=rng.uniform(-20, 20, 3), velocity=rng.uniform(-5, 5, 3)
        )
        h = control.play_buffered(
            ot.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
            opts, max_distance=50.0, rate=8000, buffer_duration=0.1,
        )
        handles.append(h)
    for i in range(8):
        h = control.play(
            ot.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
            ot.SpatialOptions(position=rng.uniform(-20, 20, 3)),
        )
        handles.append(h)
    return scene, handles


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 4), (4, 2), (1, 8)])
def test_scenepack_matches_single_device(mesh_shape):
    need_devices(mesh_shape[0] * mesh_shape[1])
    S = 4
    # reference: unsharded per-scene renderers
    singles = [build_spatial_scene(seed) for seed in range(S)]
    expected = []
    for scene, _ in singles:
        r = ot.Renderer(scene, 8000)
        expected.append(np.concatenate([r.render_block(512) for _ in range(3)]))
    expected = np.stack(expected)

    packed = [build_spatial_scene(seed)[0] for seed in range(S)]
    mesh = make_mesh(*mesh_shape)
    pack = ScenePack(packed, 8000, mesh)
    got = np.concatenate([pack.render_block(512) for _ in range(3)], axis=1)

    np.testing.assert_allclose(got, expected, atol=2e-6)


def test_scenepack_clamped_voice_disables_subpass():
    """A scene with a WIDE-walk voice (a ~100 m/s mover, genuinely inside
    the transition band's walk regime) rides the family sub-pass on
    single-device renderers, but under a ScenePack the pack-wide tier
    floor disables the split (every scene must share one program) and the
    pack demotes to the wide tier — both paths are exact, so the audio
    must still match.  A fully offset-clamped voice (60 m > 44.3 m) rides
    along too: it reads ds = 0 exactly inside whatever tier is active,
    with NO listing and NO demotion of its own."""
    need_devices(4)

    def build(seed):
        rng = np.random.default_rng(seed)
        control, scene = ot.SpatialScene.new()
        for _ in range(6):
            control.play_buffered(
                ot.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
                ot.SpatialOptions(position=rng.uniform(-10, 10, 3),
                                  velocity=rng.uniform(-2, 2, 3)),
                max_distance=10.0, rate=8000, buffer_duration=0.1,
            )
        if seed == 1:
            # a frozen far voice (never listed, never demotes) ...
            control.play_buffered(
                ot.Sine(0.0, 700.0),
                ot.SpatialOptions(position=[60.0, 0.0, 0.0]),
                max_distance=10.0, rate=8000, buffer_duration=0.1,
            )
            # ... and a fast mover that needs the wide walk
            control.play_buffered(
                ot.Sine(0.5, 520.0),
                ot.SpatialOptions(position=[4.0, 0.0, 0.0],
                                  velocity=[100.0, 0.0, 0.0]),
                max_distance=10.0, rate=8000, buffer_duration=0.1,
            )
        return scene

    S = 2
    singles = [build(seed) for seed in range(S)]
    expected = []
    for scene in singles:
        r = ot.Renderer(scene, 8000)
        expected.append(np.concatenate([r.render_block(512) for _ in range(3)]))
    expected = np.stack(expected)
    sp = list(singles[1]._buffered_pools.values())[0]
    assert sp._sub_cfg is not None and sp._read_cfg[0] == 512
    assert 6 not in sp._sub_list, "the frozen voice must not be listed"

    packed = [build(seed) for seed in range(S)]
    mesh = make_mesh(2, 2)
    pack = ScenePack(packed, 8000, mesh)
    got = np.concatenate([pack.render_block(512) for _ in range(3)], axis=1)
    pp = list(packed[1]._buffered_pools.values())[0]
    assert pp._sub_cfg is None and pp._read_cfg[0] < 512

    np.testing.assert_allclose(got, expected, atol=2e-6)


def test_scenepack_singleton_submix_voices():
    """Scenes containing NON-BATCHABLE (submix) voices pack too: the
    singleton pool's param/state subtrees replicate over the voice mesh
    axis and its contribution is counted once (voice-shard 0) before the
    closing psum.  Parity vs per-scene single-device renderers.  Matches
    the reference, where any boxed signal mixes (mixer.rs:18-26,
    spatial.rs:314-340)."""
    need_devices(8)

    def build(seed):
        rng = np.random.default_rng(seed)
        control, scene = ot.SpatialScene.new()
        for _ in range(6):
            control.play_buffered(
                ot.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
                ot.SpatialOptions(position=rng.uniform(-10, 10, 3),
                                  velocity=rng.uniform(-2, 2, 3)),
                max_distance=20.0, rate=8000, buffer_duration=0.1,
            )
        mc, mixer = ot.Mixer.new(channels=1)
        mc.play(ot.Sine(0.0, 300.0 + 40 * seed))
        mc.play(ot.Sine(0.0, 520.0 + 40 * seed))
        control.play_buffered(
            mixer, ot.SpatialOptions(position=[2.0, 0.0, -1.0]),
            max_distance=20.0, rate=8000,
        )
        return scene

    S = 2
    expected = []
    for seed in range(S):
        r = ot.Renderer(build(seed), 8000)
        expected.append(np.concatenate([r.render_block(512) for _ in range(3)]))
    expected = np.stack(expected)

    packed = [build(seed) for seed in range(S)]
    pack = ScenePack(packed, 8000, make_mesh(2, 4))
    assert any(
        getattr(p, "is_singleton", False)
        for p in packed[0]._all_pools()
    )
    got = np.concatenate([pack.render_block(512) for _ in range(3)], axis=1)
    np.testing.assert_allclose(got, expected, atol=2e-6)


def test_mixer_pack_singleton_submix():
    """Mixer packs with a submix (Mixer-in-Mixer singleton pool) voice:
    replicated over the voice axis, counted once."""
    need_devices(8)

    def build(seed):
        rng = np.random.default_rng(seed)
        control, mixer = ot.Mixer.new(channels=1)
        for _ in range(8):
            control.play(ot.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)))
        ic, inner = ot.Mixer.new(channels=1)
        ic.play(ot.Sine(0.0, 640.0 + 80 * seed))
        control.play(inner)
        return mixer

    S = 2
    expected = []
    for s in range(S):
        r = ot.Renderer(build(s), 8000)
        expected.append(np.concatenate([r.render_block(512) for _ in range(2)]))
    expected = np.stack(expected)
    pack = ScenePack([build(s) for s in range(S)], 8000, make_mesh(2, 4))
    got = np.concatenate([pack.render_block(512) for _ in range(2)], axis=1)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_scenepack_grow_and_eager_plays_mid_pack():
    """Plays past pool capacity (growth) and bulk plays (> k_play, the
    eager-apply path) landing BETWEEN packed blocks must not reset carried
    device state: the pack pulls the authoritative carry back through the
    unpack hook before any out-of-graph pool mutation (set.rs:57-63 realloc
    preserves live voices)."""
    need_devices(8)
    S = 2

    def play_wave(control, rng, k):
        hs = []
        for _ in range(k):
            hs.append(control.play(
                ot.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
                ot.SpatialOptions(position=rng.uniform(-20, 20, 3),
                                  velocity=rng.uniform(-3, 3, 3)),
            ))
        return hs

    def build(seed):
        rng = np.random.default_rng(seed)
        control, scene = ot.SpatialScene.new(initial_capacity=16)
        play_wave(control, rng, 8)
        return control, scene, rng

    # reference: unsharded per-scene renderers with the same play schedule
    expected = []
    for seed in range(S):
        control, scene, rng = build(seed)
        r = ot.Renderer(scene, 8000)
        blocks = [r.render_block(512) for _ in range(2)]
        # 12 > k_play forces the eager-apply path; 8+12 > 16 forces growth
        play_wave(control, rng, 12)
        blocks += [r.render_block(512) for _ in range(3)]
        expected.append(np.concatenate(blocks))
    expected = np.stack(expected)

    built = [build(seed) for seed in range(S)]
    pack = ScenePack([b[1] for b in built], 8000, make_mesh(2, 4))
    got = [pack.render_block(512) for _ in range(2)]
    for control, _, rng in built:
        play_wave(control, rng, 12)
    got += [pack.render_block(512) for _ in range(3)]
    got = np.concatenate(got, axis=1)

    np.testing.assert_allclose(got, expected, atol=2e-6)


def test_mixer_pack():
    need_devices(8)
    S = 2

    def build(seed):
        rng = np.random.default_rng(seed)
        control, mixer = ot.Mixer.new(channels=1)
        for _ in range(16):
            control.play(ot.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)))
        return mixer

    expected = []
    for s in range(S):
        r = ot.Renderer(build(s), 48000)
        expected.append(np.concatenate([r.render_block(512) for _ in range(2)]))
    expected = np.stack(expected)
    mesh = make_mesh(2, 4)
    pack = ScenePack([build(s) for s in range(S)], 48000, mesh)
    got = np.concatenate([pack.render_block(512) for _ in range(2)], axis=1)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_scenepack_device_scan_matches_render_block():
    """ScenePack.render_frames_device (on-device scans with the all-idle
    no-delta fast path) matches per-block render_block exactly, across the
    play-delta -> idle archetype boundary."""
    need_devices(8)
    S = 2

    def build(seed):
        rng = np.random.default_rng(seed)
        control, mixer = ot.Mixer.new(channels=1)
        for _ in range(8):
            gc, g = ot.Gain.new(
                ot.Sine(rng.uniform(0, 6), rng.uniform(100, 900))
            )
            gc.set_gain(-3.0)
            control.play(g)
        return mixer

    pack = ScenePack([build(s) for s in range(S)], 8000, make_mesh(2, 4))
    a = np.concatenate([pack.render_block(512) for _ in range(3)], axis=1)

    pack2 = ScenePack([build(s) for s in range(S)], 8000, make_mesh(2, 4))
    outs = pack2.render_frames_device(3 * 512)
    b = np.concatenate([np.asarray(x) for x in outs], axis=0)  # (B, S, C, n)
    b = b.transpose(1, 0, 3, 2).reshape(S, -1, b.shape[2])
    assert np.abs(a).max() > 0.01
    # scan-fused vs per-block programs reassociate the gain ramp (~1e-6)
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_streaming_agc_scene_pack():
    """BASELINE config 5 (scaled): scenes x stream voices with adapt AGC,
    block-pipelined through a sharded pack."""
    need_devices(8)
    S, VOICES = 2, 8

    def build(seed):
        rng = np.random.default_rng(seed)
        control, mixer = ot.Mixer.new(channels=1)
        senders = []
        for _ in range(VOICES):
            sc, stream = ot.Stream.new(8000, 2048)
            control.play(
                ot.Adapt(stream, 0.1, ot.AdaptOptions(tau=0.1, max_gain=4.0))
            )
            senders.append(sc)
        return mixer, senders

    scenes, senders = zip(*[build(s) for s in range(S)])
    mesh = make_mesh(2, 4)
    pack = ScenePack(list(scenes), 8000, mesh)
    rng = np.random.default_rng(42)
    outs = []
    for _ in range(4):
        for group in senders:
            for sc in group:
                sc.write(rng.standard_normal(700).astype(np.float32) * 0.2)
        outs.append(pack.render_block(512))
    out = np.concatenate(outs, axis=1)
    assert out.shape == (S, 2048, 1)
    assert np.isfinite(out).all()
    assert np.abs(out[:, 512:]).max() > 0.05  # audio flows after ingest


def test_scenepack_dr_stream_ingest():
    """BARE streams ride DR pools: the per-block ingest chunk is a dense
    per-voice payload that must shard with the voices under the mesh.
    Mid-run writes through a pack must match single-device renderers."""
    need_devices(8)
    S, VOICES = 2, 6

    def build(seed):
        rng = np.random.default_rng(seed)
        control, mixer = ot.Mixer.new(channels=1)
        senders = []
        for _ in range(VOICES):
            sc, stream = ot.Stream.new(8000, 2048)
            control.play(stream)
            senders.append(sc)
        return mixer, senders

    def feed(senders, rng):
        for group in senders:
            for sc in group:
                sc.write(rng.standard_normal(600).astype(np.float32) * 0.2)

    # reference: unsharded per-scene renderers with the same write schedule
    scenes, senders = zip(*[build(s) for s in range(S)])
    rs = [ot.Renderer(m, 8000) for m in scenes]
    rng = np.random.default_rng(9)
    ref = []
    for _ in range(4):
        feed(senders, rng)
        ref.append(np.stack([np.asarray(r.render_block(512)) for r in rs]))
    ref = np.concatenate(ref, axis=1)

    scenes, senders = zip(*[build(s) for s in range(S)])
    pack = ScenePack(list(scenes), 8000, make_mesh(2, 4))
    rng = np.random.default_rng(9)
    outs = []
    for _ in range(4):
        feed(senders, rng)
        outs.append(pack.render_block(512))
    out = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_scenepack_walk_tier_uniform():
    """ScenePack renders every scene with ONE program, so the motion-
    adaptive read tier must agree across the pack: scene 0 is slow/near
    while scene 1 holds a voice beyond max_delay*c.  A fully
    clamped voice reads ds = 0 exactly inside the tight tier — it does
    not escalate the pack-wide floor, so BOTH scenes keep (512, 32) and
    the audio must still match per-scene renderers."""
    need_devices(8)

    def build(far):
        control, scene = ot.SpatialScene.new()
        control.play_buffered(
            ot.Sine(0.0, 440.0),
            ot.SpatialOptions(position=[3.0, 0.0, -1.0], velocity=[4.0, 0.0, 0.0]),
            max_distance=10.0, rate=8000, buffer_duration=0.1,
        )
        if far:
            # 60 m > (10/343 + 0.1)*343 = 44.3 m: offsets clamp, reads freeze
            control.play_buffered(
                ot.Sine(1.0, 620.0),
                ot.SpatialOptions(position=[60.0, 5.0, 0.0]),
                max_distance=10.0, rate=8000, buffer_duration=0.1,
            )
        return scene

    ref_out = []
    scenes = [build(False), build(True)]
    rs = [ot.Renderer(s, 8000) for s in scenes]
    for _ in range(4):
        ref_out.append(np.stack([np.asarray(r.render_block(512)) for r in rs]))
    ref_out = np.concatenate(ref_out, axis=1)

    scenes = [build(False), build(True)]
    pack = ScenePack(scenes, 8000, make_mesh(2, 4))
    outs = [pack.render_block(512) for _ in range(4)]
    out = np.concatenate(outs, axis=1)
    tiers = {
        p._read_cfg
        for s in scenes
        for p in s._all_pools()
        if hasattr(p, "_read_cfg")
    }
    assert tiers == {(512, 32)}, tiers  # frozen voices demote nothing
    np.testing.assert_allclose(out, ref_out, atol=2e-5)


def test_scenepack_sampler_seek_voices():
    """Sampler (FramesSignal) voices on the DR seek path under shard_map:
    the arena gather runs per shard with replicated ddata; pack output
    matches single-device renderers."""
    need_devices(8)
    snd = ot.Frames.from_slice(
        8000, np.sin(np.linspace(0, 900, 16000)).astype(np.float32)
    )

    def build(seed):
        r2 = np.random.default_rng(seed)
        c, s = ot.SpatialScene.new()
        for i in range(8):
            c.play(ot.FramesSignal(snd, -0.01 * i), ot.SpatialOptions(
                position=r2.uniform(-15, 15, 3), velocity=r2.uniform(-3, 3, 3)))
        return s

    exp = []
    for s in [build(k) for k in range(2)]:
        r = ot.Renderer(s, 8000)
        exp.append(np.concatenate([r.render_block(512) for _ in range(3)]))
    exp = np.stack(exp)
    pack = ScenePack([build(k) for k in range(2)], 8000, make_mesh(2, 4))
    got = np.concatenate([pack.render_block(512) for _ in range(3)], axis=1)
    np.testing.assert_allclose(got, exp, atol=1e-5)


def test_scenepack_dr_fades_under_mesh():
    """Fade deltas (flip-bit DR fader) localize correctly under the
    (scene, voice) mesh: a packed mixer with mid-run fade_to matches
    per-scene single-device renderers."""
    need_devices(8)
    S = 2

    def build(seed):
        rng = np.random.default_rng(seed)
        mc, mixer = ot.Mixer.new(channels=1)
        fcs = []
        for _ in range(8):
            fc, f = ot.Fader.new(ot.Sine(rng.uniform(0, 6), rng.uniform(100, 900)))
            fcs.append(fc)
            mc.play(f)
        return mixer, fcs

    expected = []
    for seed in range(S):
        mixer, fcs = build(seed)
        r = ot.Renderer(mixer, 8000)
        blocks = [r.render_block(512)]
        fcs[0].fade_to(ot.Sine(0.5, 620.0), 0.05)
        fcs[3].fade_to(ot.Sine(0.1, 340.0), 0.02)
        blocks += [r.render_block(512) for _ in range(3)]
        expected.append(np.concatenate(blocks))
    expected = np.stack(expected)

    built = [build(seed) for seed in range(S)]
    pack = ScenePack([b[0] for b in built], 8000, make_mesh(2, 4))
    got = [pack.render_block(512)]
    for _, fcs in built:
        fcs[0].fade_to(ot.Sine(0.5, 620.0), 0.05)
        fcs[3].fade_to(ot.Sine(0.1, 340.0), 0.02)
    got += [pack.render_block(512) for _ in range(3)]
    got = np.concatenate(got, axis=1)
    np.testing.assert_allclose(got, expected, atol=2e-6)


def test_scenepack_scan_unroll_parity():
    """ScenePack(scan_unroll=8) — the bench's scenepack configuration —
    must render the same audio as the rolled pack scan, including across
    a mid-run control event (a partial trailing segment shorter than the
    unroll factor) and Stream ingest."""

    def build(seed):
        rng = np.random.default_rng(seed)
        mc = ot.MixerControl(mixer := ot.Mixer(1, initial_capacity=2))
        sctls = []
        for i in range(8):
            opt = ot.AdaptOptions(tau=0.1, max_gain=4.0)
            if i < 2:
                stream = ot.Stream(8000, 1024 + 128, max_write_per_block=1024)
                sctls.append(stream.control)
                mc.play(ot.Adapt(stream, 0.1, opt))
            else:
                mc.play(ot.Adapt(
                    ot.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)),
                    0.1, opt))
        return mixer, sctls

    def drain(batches):
        # list of (B, S, C, n) device arrays -> (S, C, total_n)
        chunks = []
        for a in batches:
            a = np.asarray(a)
            b, s, c, n = a.shape
            chunks.append(np.moveaxis(a, 0, 2).reshape(s, c, b * n))
        return np.concatenate(chunks, axis=-1)

    rng = np.random.default_rng(7)
    pcm = rng.standard_normal((4, 1024)).astype(np.float32) * 0.1
    outs = {}
    for unroll in (1, 8):
        scenes, ctls = zip(*[build(s) for s in range(2)])
        pack = ScenePack(list(scenes), 8000, make_mesh(1, 1),
                         scan_unroll=unroll)
        flat = [c for group in ctls for c in group]
        for j, ctl in enumerate(flat):
            ctl.write(pcm[j])
        parts = [drain(pack.render_frames_device(512 * 5))]
        for j, ctl in enumerate(flat):  # mid-run ingest = control event
            ctl.write(pcm[j, :512])
        parts.append(drain(pack.render_frames_device(512 * 3)))
        outs[unroll] = np.concatenate(parts, axis=-1)
    assert np.isfinite(outs[8]).all()
    assert np.abs(outs[1] - outs[8]).max() <= 1e-6
