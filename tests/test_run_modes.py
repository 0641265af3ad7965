"""Renderer mode equivalence: single blocks, scans, and mixed/remainder
paths must produce identical audio streams."""

import numpy as np

import oddio_tpu as ot


def build():
    control, mixer = ot.Mixer.new(channels=2)
    control.play(ot.MonoToStereo(ot.Sine(0.2, 313.0)))
    g, gain = ot.Gain.new(ot.MonoToStereo(ot.Sine(1.2, 551.0)))
    control.play(gain)
    return control, g, mixer


def test_block_vs_scan_vs_remainder():
    _, _, m1 = build()
    r1 = ot.Renderer(m1, 8000)
    a = np.concatenate([r1.render_block(512) for _ in range(5)])

    _, _, m2 = build()
    r2 = ot.Renderer(m2, 8000)
    b = r2.render_frames(512 * 5)

    _, _, m3 = build()
    r3 = ot.Renderer(m3, 8000)
    c = np.concatenate([r3.render_frames(512 * 2), r3.render_frames(512 * 3)])

    _, _, m4 = build()
    r4 = ot.Renderer(m4, 8000)
    d = r4.render_frames(2560 - 512 + 200 + 312)  # scan + remainder block

    # cross-block state is exact (48-bit phase accumulators), but the modes
    # compile to DIFFERENT XLA programs (single-step vs scan body) whose
    # fusion choices round the in-block closed forms by <=1 ulp, and the
    # mixed-remainder run (d) additionally splits blocks differently; near-
    # exact equality is the contract (core/frames.py precision notes)
    np.testing.assert_allclose(a, b, atol=2e-6)
    np.testing.assert_allclose(a, c, atol=2e-6)
    np.testing.assert_allclose(a, d, atol=2e-6)


def test_run_convenience():
    _, _, m = build()
    out1 = ot.run(m, 8000, 256)
    out2 = ot.run(m, 8000, 256)  # streams on, state persists
    assert out1.shape == (256, 2)
    assert not np.array_equal(out1, out2)


def test_control_mid_scan_boundary():
    """Controls set between render_frames calls land exactly on the chunk
    boundary (block-granular semantics)."""
    control, g, m = build()
    r = ot.Renderer(m, 8000)
    r.render_frames(1024)
    g.set_amplitude_ratio(0.0)  # hard-reset ramp: silence the second voice
    out = r.render_frames(1024)
    # only the 313 Hz voice remains
    spec = np.abs(np.fft.rfft(out[:, 0] * np.hanning(len(out))))
    assert np.argmax(spec) * 8000 / len(out) < 400


def test_no_retrace_after_warmup():
    """Retrace containment (README.md:11 "no glitches"): after one idle and
    one control-event block, live play/set_motion/stop traffic reuses the
    two existing jitted step variants — no new compiles, ever."""
    rng = np.random.default_rng(11)
    control, scene = ot.SpatialScene.new(initial_capacity=64)
    handles = []
    for _ in range(8):
        handles.append(control.play(
            ot.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
            ot.SpatialOptions(position=rng.uniform(-10, 10, 3)),
        ))
        handles.append(control.play_buffered(
            ot.Sine(rng.uniform(0, 6), rng.uniform(100, 1000)),
            ot.SpatialOptions(position=rng.uniform(-10, 10, 3)),
            max_distance=20.0, rate=8000, buffer_duration=0.05,
        ))
    r = ot.Renderer(scene, 8000)
    r.render_block(256)  # delta variant (queued plays)
    r.render_block(256)  # idle variant
    warm = set(r._steps.keys())
    assert len(warm) == 2
    for i in range(12):
        if i % 3 == 0:
            handles.append(control.play(
                ot.Sine(0.0, 440.0), ot.SpatialOptions(position=[1.0, 0.0, 0.0])
            ))
        if i % 3 == 1:
            for h in handles[:4]:
                h.set_motion(rng.uniform(-10, 10, 3), rng.uniform(-2, 2, 3), False)
        r.render_block(256)
    assert set(r._steps.keys()) == warm, "control events caused a retrace"


def test_scan_unroll_parity():
    """scan_unroll unrolls the on-device block scan (core/run.py); the
    audio must match the rolled scan to ULP-scale tolerance (XLA fuses
    the unrolled body differently, so exact bitwise equality is not the
    contract), including across control events (segments shorter than
    the unroll factor) and a spatialized buffered voice with mid-run
    motion."""
    def build_scene():
        rng = np.random.default_rng(5)
        control, scene = ot.SpatialScene.new(initial_capacity=16)
        hs = []
        for _ in range(4):
            hs.append(control.play(
                ot.Sine(rng.uniform(0, 6), rng.uniform(100, 900)),
                ot.SpatialOptions(position=rng.uniform(-5, 5, 3)),
            ))
            hs.append(control.play_buffered(
                ot.Sine(rng.uniform(0, 6), rng.uniform(100, 900)),
                ot.SpatialOptions(position=rng.uniform(-5, 5, 3)),
                max_distance=20.0, rate=8000, buffer_duration=0.05,
            ))
        return control, scene, hs

    def run(unroll):
        rng2 = np.random.default_rng(9)
        control, scene, hs = build_scene()
        r = ot.Renderer(scene, 8000, scan_unroll=unroll)
        parts = [r.render_frames(256 * 6, block_size=256)]
        hs[1].set_motion(rng2.uniform(-5, 5, 3), rng2.uniform(-1, 1, 3),
                         False)
        parts.append(r.render_frames(256 * 5, block_size=256))
        return np.concatenate(parts)

    a = run(1)
    b = run(4)
    assert a.shape == b.shape and np.isfinite(b).all()
    assert np.abs(a - b).max() <= 1e-6


def _build_buffered_multi(seed=7):
    rng = np.random.default_rng(seed)
    control, scene = ot.SpatialScene.new()
    for _ in range(5):
        control.play_buffered(
            ot.Sine(rng.uniform(0, 6), rng.uniform(100, 900)),
            ot.SpatialOptions(
                position=rng.uniform(-8, 8, 3),
                velocity=rng.uniform(-2, 2, 3),
            ),
            max_distance=10.0, rate=8000, buffer_duration=0.5,
        )
    return control, scene


def test_multiblock_idle_groups_match_per_block():
    """Fused multi-block idle dispatch (SpatialScene.render_multi: nb
    blocks in one traced group) computes the SAME arithmetic as the
    per-block path: same cursor scalars, same ring values, same per-block
    mix order — eager evaluation from a shared state is bit-identical.
    Across two
    different COMPILED programs XLA's fusion/FMA choices may differ by
    ~1 ulp per op (the PARITY.md reduction-order class), so the
    cross-program assertion is a tight epsilon, with the oracle goldens
    (<= 1e-5) as the semantic contract."""
    _, s1 = _build_buffered_multi()
    r1 = ot.Renderer(s1, 8000)
    a = r1.render_frames(512 * 19)  # 4 groups of 4 + remainder 3
    assert any(
        isinstance(k[1], tuple) and k[1][0] == "multi"
        for k in r1._steps
    ), "the multi-block step must have engaged"

    _, s2 = _build_buffered_multi()
    pool2 = list(s2._buffered_pools.values())[0]
    pool2.MULTI_NB = 0  # instance override disables the fused path
    r2 = ot.Renderer(s2, 8000)
    b = r2.render_frames(512 * 19)
    assert not any(
        isinstance(k[1], tuple) and k[1][0] == "multi"
        for k in r2._steps
    )
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 2e-7, np.abs(a - b).max()


def test_multiblock_gate_rejects_tight_rings():
    """host_multiblock must refuse when the ring lacks slack for the
    group's batched appends (later appends would overwrite samples an
    earlier block still reads)."""
    rng = np.random.default_rng(3)
    control, scene = ot.SpatialScene.new()
    control.play_buffered(
        ot.Sine(0.0, 440.0),
        ot.SpatialOptions(position=rng.uniform(-5, 5, 3)),
        max_distance=10.0, rate=8000, buffer_duration=0.1,  # cap 2048
    )
    r = ot.Renderer(scene, 8000)
    a = r.render_frames(512 * 8)
    assert np.isfinite(a).all() and np.abs(a).max() > 0
    assert not any(
        isinstance(k[1], tuple) and k[1][0] == "multi"
        for k in r._steps
    ), "tight ring must stay on the per-block path"
