"""Golden numerical parity: the engine vs the scalar oracle
(tests/reference_impl.py) on the BASELINE.json workload configs (scaled down
for the Python-loop oracle).

Two comparison modes:

* **exact oracle** (``exact=True``): the reference's semantics with per-frame
  cursor offsets computed in f64 — mathematically exact.  The engine (which
  computes near-exact positions on device via the split trick in
  ops/_dev.py) must match within **1e-5**.
* **faithful oracle** (default): bit-faithful emulation of the reference's
  sequential f32 accumulation (``offset += ds`` per frame).  The reference's
  own intra-block rounding wobble relative to exact math grows with the
  resampling ratio and ring size (up to ~n*eps*|offset| per block, transient
  and non-accumulating because the f64 cursor is re-derived each block).
  Engine-vs-faithful assertions use bounds sized to that wobble and exist to
  catch regressions, not to claim bit equality.
"""

import numpy as np
import pytest

import oddio_tpu as ot
import reference_impl as ref

F = np.float32


def render_engine(sig, rate, total, block=512):
    return ot.Renderer(sig, rate).render_frames(total, block_size=block)


def render_oracle(osig, rate, total, block=512, channels=1):
    shape = (block,) if channels == 1 else (block, channels)
    chunks = []
    for _ in range(total // block):
        buf = np.zeros(shape, F)
        ref.oddio_run(osig, rate, buf)
        chunks.append(buf.copy())
    out = np.concatenate(chunks)
    return out[:, None] if channels == 1 else out


def test_golden_sine_gain_mixer():
    """BASELINE config 1: Sine -> Gain -> Mixer offline render."""
    RATE, TOTAL = 44100, 44032
    control, mixer = ot.Mixer.new(channels=1)
    gctl, g = ot.Gain.new(ot.Sine(0.1, 500.0))
    control.play(g)
    r = ot.Renderer(mixer, RATE)
    eng1 = r.render_frames(TOTAL // 2)
    gctl.set_amplitude_ratio(0.25)  # mid-render ramp
    eng2 = r.render_frames(TOTAL // 2)
    eng = np.concatenate([eng1, eng2])

    om = ref.OMixer()
    og = ref.OGain(ref.OSine(0.1, 500.0, exact=True), exact=True)
    om.play(og)
    orc1 = render_oracle(om, RATE, TOTAL // 2)
    og.set_amplitude_ratio(0.25)
    orc2 = render_oracle(om, RATE, TOTAL // 2)
    orc = np.concatenate([orc1, orc2])

    err = np.abs(eng - orc).max()
    assert err <= 1e-5, err
    # the faithful-f32 oracle's phase wrap drifts ~eps*phase per block; the
    # engine's f64-wrapped phase stays within that envelope
    om2 = ref.OMixer()
    og2 = ref.OGain(ref.OSine(0.1, 500.0), exact=True)
    om2.play(og2)
    orc1 = render_oracle(om2, RATE, TOTAL // 2)
    og2.set_amplitude_ratio(0.25)
    orc2 = render_oracle(om2, RATE, TOTAL // 2)
    err_f = np.abs(eng - np.concatenate([orc1, orc2])).max()
    assert err_f <= 1e-4, err_f


def test_golden_frames_speed_resample():
    """BASELINE config 2: FramesSignal + Speed resampling 44.1k->48k."""
    rng = np.random.default_rng(7)
    data = rng.uniform(-1, 1, 44100).astype(F)
    RATE, TOTAL = 48000, 16384

    def engine():
        sctl, sp = ot.Speed.new(
            ot.FramesSignal(ot.Frames.from_slice(44100, data), 0.0)
        )
        sctl.set_speed(1.2)
        return render_engine(sp, RATE, TOTAL)

    eng = engine()
    exact = render_oracle(
        ref.OSpeed(ref.OFramesSignal(ref.OFrames(44100, data), 0.0, exact=True), 1.2),
        RATE, TOTAL,
    )
    err = np.abs(eng - exact).max()
    assert err <= 1e-5, err

    # vs the faithful f32-accumulating reference: bounded by its own wobble
    faithful = render_oracle(
        ref.OSpeed(ref.OFramesSignal(ref.OFrames(44100, data), 0.0), 1.2),
        RATE, TOTAL,
    )
    err_f = np.abs(eng - faithful).max()
    assert err_f <= 5e-3, err_f


def test_golden_dense_mix_chain():
    """BASELINE config 4 (scaled): voices with per-voice gains, Reinhard +
    Tanh + Downmix over a stereo mixer.  Tolerance includes the reduction-
    order difference of summing 24 voices (~V*eps per unit amplitude)."""
    RATE, TOTAL, V = 44100, 8192, 24
    rng = np.random.default_rng(3)
    freqs = rng.uniform(100, 2000, V)
    phases = rng.uniform(0, 6, V)
    gains = rng.uniform(-12, 3, V)

    control, mixer = ot.Mixer.new(channels=2)
    for f, p, db in zip(freqs, phases, gains):
        control.play(ot.MonoToStereo(ot.FixedGain(ot.Sine(p, f), db)))
    chain = ot.Downmix(ot.Tanh(ot.Reinhard(mixer)))
    eng = render_engine(chain, RATE, TOTAL)

    def oracle(exact):
        om = ref.OMixer(channels=2)
        for f, p, db in zip(freqs, phases, gains):
            om.play(ref.OMonoToStereo(ref.OFixedGain(ref.OSine(p, f, exact=exact), db)))
        ochain = ref.ODownmix(ref.OTanh(ref.OReinhard(om)), channels=2)
        return render_oracle(ochain, RATE, TOTAL)

    err = np.abs(eng - oracle(True)).max()
    assert err <= 2e-5, err  # XLA tanh + 24-voice reduction order
    # faithful f32 phase wrap drifts with render length (the reference's own
    # chunked-fmod accumulation); bound sized to this config
    err_f = np.abs(eng - oracle(False)).max()
    assert err_f <= 1e-3, err_f


def test_golden_adapt():
    """Adapt AGC over a mixed scene (BASELINE config 5's AGC component)."""
    RATE, TOTAL = 44100, 4096
    control, mixer = ot.Mixer.new(channels=1)
    control.play(ot.FixedGain(ot.Sine(0.0, 500.0), -30.0))
    sig = ot.Adapt(mixer, 1e-3 / np.sqrt(2),
                   ot.AdaptOptions(tau=0.1, max_gain=1e6,
                                   low=0.1 / np.sqrt(2), high=0.5 / np.sqrt(2)))
    eng = render_engine(sig, RATE, TOTAL)

    om = ref.OMixer()
    om.play(ref.OFixedGain(ref.OSine(0.0, 500.0), -30.0))
    osig = ref.OAdapt(om, F(1e-3) / np.sqrt(F(2.0), dtype=F), 0.1, 1e6,
                      F(0.1) / np.sqrt(F(2.0), dtype=F),
                      F(0.5) / np.sqrt(F(2.0), dtype=F))
    orc = render_oracle(osig, RATE, TOTAL)

    err = np.abs(eng - orc).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("buffered", [False, True])
@pytest.mark.parametrize("exact", [True, False])
def test_golden_spatial_flyby(buffered, exact):
    """BASELINE config 3 (scaled): one source flying past the listener with
    motion updates (including a discontinuity jump), both spatialization
    paths, rotated listener."""
    RATE, BLOCK, NBLK = 8000, 512, 12
    tt = np.arange(RATE, dtype=F) / F(RATE)
    boop = np.sin(tt * F(500 * 2 * np.pi), dtype=F)

    control, scene = ot.SpatialScene.new()
    opts = ot.SpatialOptions(position=[-20.0, 5.0, 0.0], velocity=[30.0, 0.0, 0.0])
    sig = ot.FramesSignal(ot.Frames.from_slice(RATE, boop), 0.0)
    if buffered:
        h = control.play_buffered(sig, opts, max_distance=60.0, rate=RATE,
                                  buffer_duration=0.1)
    else:
        h = control.play(sig, opts)
    control.set_listener_rotation([np.cos(0.15), 0.0, np.sin(0.15), 0.0])
    r = ot.Renderer(scene, RATE)

    oscene = ref.OSpatialScene(exact=exact)
    osig = ref.OFramesSignal(ref.OFrames(RATE, boop), 0.0, exact=exact)
    if buffered:
        ov = oscene.play_buffered(osig, [-20.0, 5.0, 0.0], [30.0, 0.0, 0.0], 0.1,
                                  max_distance=60.0, rate=RATE, buffer_duration=0.1)
    else:
        ov = oscene.play(osig, [-20.0, 5.0, 0.0], [30.0, 0.0, 0.0], 0.1)
    oscene.set_listener_rotation([np.cos(0.15), 0.0, np.sin(0.15), 0.0])

    t = 0.0
    errs = []
    for i in range(NBLK):
        if i == 4:
            h.set_motion([-20.0 + 30.0 * t, 5.0, 0.0], [30.0, 0.0, 0.0], False)
            ov.set_motion([-20.0 + 30.0 * t, 5.0, 0.0], [30.0, 0.0, 0.0], False)
        if i == 8:  # discontinuity jump
            h.set_motion([10.0, 2.0, -3.0], [5.0, 0.0, 0.0], True)
            ov.set_motion([10.0, 2.0, -3.0], [5.0, 0.0, 0.0], True)
        eng = r.render_block(BLOCK)
        buf = np.zeros((BLOCK, 2), F)
        ref.oddio_run(oscene, RATE, buf)
        errs.append(np.abs(eng - buf).max())
        t += BLOCK / RATE
    err = max(errs)
    bound = 1e-5 if exact else 1e-3
    assert err <= bound, (err, errs)


@pytest.mark.parametrize("buffered", [False, True])
def test_golden_spatial_flyby_large_blocks(buffered):
    """The flyby scene rendered in 1664-frame blocks (3 internal 512-frame
    chunks + a 128-frame tail): the reference's walk runs once per *block*
    whatever its size (signal.rs:19), so the oracle driven at the same
    block size must match — this pins the chunked cursor re-baselining,
    not just the static-geometry case."""
    RATE, BLOCK, NBLK = 8000, 1664, 4
    tt = np.arange(RATE, dtype=F) / F(RATE)
    boop = np.sin(tt * F(500 * 2 * np.pi), dtype=F)

    control, scene = ot.SpatialScene.new()
    opts = ot.SpatialOptions(position=[-20.0, 5.0, 0.0], velocity=[30.0, 0.0, 0.0])
    sig = ot.FramesSignal(ot.Frames.from_slice(RATE, boop), 0.0)
    if buffered:
        h = control.play_buffered(sig, opts, max_distance=60.0, rate=RATE,
                                  buffer_duration=0.1)
    else:
        h = control.play(sig, opts)
    r = ot.Renderer(scene, RATE)

    oscene = ref.OSpatialScene(exact=True)
    osig = ref.OFramesSignal(ref.OFrames(RATE, boop), 0.0, exact=True)
    if buffered:
        ov = oscene.play_buffered(osig, [-20.0, 5.0, 0.0], [30.0, 0.0, 0.0], 0.1,
                                  max_distance=60.0, rate=RATE, buffer_duration=0.1)
    else:
        ov = oscene.play(osig, [-20.0, 5.0, 0.0], [30.0, 0.0, 0.0], 0.1)

    errs = []
    for i in range(NBLK):
        if i == 2:
            h.set_motion([5.0, 2.0, -3.0], [5.0, 0.0, 0.0], False)
            ov.set_motion([5.0, 2.0, -3.0], [5.0, 0.0, 0.0], False)
        eng = r.render_block(BLOCK)
        buf = np.zeros((BLOCK, 2), F)
        ref.oddio_run(oscene, RATE, buf)
        errs.append(np.abs(eng - buf).max())
    err = max(errs)
    assert err <= 1e-5, (err, errs)


def test_golden_buffered_huge_blocks_wrapped_reads():
    """2048-frame blocks on the DR buffered pool: the second block's append
    starts at start_i = 2048 >= M_PAD with n_write = 2048 > W_CHUNK, so it
    lands as two chunked slab pairs (a too-wide dump leg would overflow
    the per-voice ring rows and corrupt the mirror).  The source sits at
    25 m so its reads WRAP past the ring end into the mirror whenever the
    write cursor is near 0 — exactly the reads a corrupted mirror breaks."""
    RATE, BLOCK, NBLK = 8000, 2048, 6
    tt = np.arange(2 * RATE, dtype=F) / F(RATE)
    boop = np.sin(tt * F(500 * 2 * np.pi), dtype=F)
    pos = [25.0, 2.0, 0.0]

    control, scene = ot.SpatialScene.new()
    sig = ot.FramesSignal(ot.Frames.from_slice(RATE, boop), 0.0)
    h = control.play_buffered(
        sig, ot.SpatialOptions(position=pos, velocity=[-3.0, 0.0, 0.0]),
        max_distance=60.0, rate=RATE, buffer_duration=0.1)
    r = ot.Renderer(scene, RATE)

    oscene = ref.OSpatialScene(exact=True)
    osig = ref.OFramesSignal(ref.OFrames(RATE, boop), 0.0, exact=True)
    ov = oscene.play_buffered(osig, pos, [-3.0, 0.0, 0.0], 0.1,
                              max_distance=60.0, rate=RATE,
                              buffer_duration=0.1)

    pool = list(scene._buffered_pools.values())[0]
    assert pool.cap_pool == 4096 and pool.M_PAD == 1024  # scenario holds
    errs = []
    for i in range(NBLK):
        if i == 3:
            h.set_motion([20.0, 2.0, 0.0], [2.0, 0.0, 0.0], False)
            ov.set_motion([20.0, 2.0, 0.0], [2.0, 0.0, 0.0], False)
        eng = r.render_block(BLOCK)
        buf = np.zeros((BLOCK, 2), F)
        ref.oddio_run(oscene, RATE, buf)
        errs.append(np.abs(eng - buf).max())
    err = max(errs)
    assert err <= 1e-5, (err, errs)


@pytest.mark.parametrize("dr", [True, False])
def test_golden_buffered_beyond_max_delay(dr):
    """A voice farther than max_delay*c has BOTH ear offsets clamped at
    -max_delay (spatial.rs:414-415): the read freezes (ds = 0) inside each
    block, beyond the standard read tiers' walk windows.  The DR pool's
    host walk bound must keep it on the tight tier (ds = 0 reads one
    constant position exactly); audio must stay golden on both pools."""
    RATE, BLOCK, NBLK = 8000, 512, 8
    tt = np.arange(RATE, dtype=F) / F(RATE)
    boop = np.sin(tt * F(500 * 2 * np.pi), dtype=F)
    # 60 m > (10/343 + 0.1)*343 = 44.3 m -> frozen reads
    pos = [60.0, 5.0, 0.0]

    control, scene = ot.SpatialScene.new()
    sig = ot.FramesSignal(ot.Frames.from_slice(RATE, boop), 0.0)
    if not dr:
        sig.dr_supported = lambda: False  # force the host pool
    control.play_buffered(sig, ot.SpatialOptions(position=pos),
                          max_distance=10.0, rate=RATE, buffer_duration=0.1)
    r = ot.Renderer(scene, RATE)

    oscene = ref.OSpatialScene(exact=True)
    osig = ref.OFramesSignal(ref.OFrames(RATE, boop), 0.0, exact=True)
    oscene.play_buffered(osig, pos, [0.0, 0.0, 0.0], 0.1,
                         max_distance=10.0, rate=RATE, buffer_duration=0.1)

    errs = []
    for _ in range(NBLK):
        eng = r.render_block(BLOCK)
        buf = np.zeros((BLOCK, 2), F)
        ref.oddio_run(oscene, RATE, buf)
        errs.append(np.abs(eng - buf).max())
    pool = list(scene._buffered_pools.values())[0]
    assert max(errs) <= 1e-5, errs
    assert np.abs(buf).max() > 1e-4  # the frozen read carries audio
    if dr:
        # the clamped voice is CERTAINLY FROZEN (ds = 0 exactly): it reads
        # on the tight tier — no sub-pass listing, no demotion
        assert pool._sub_cfg is None, pool._sub_cfg
        assert list(pool._sub_list) == []
        assert pool._read_cfg == (512, 32), pool._read_cfg


def test_golden_family_subpass_mixed_scene():
    """A few wide-walk voices (offset-clamped beyond max_delay*c, or
    moving at ~100 m/s) ride the family sub-pass on a wide read tier
    while the rest of the pool keeps its 512-frame tight tier — one
    distant voice no longer demotes the whole pool.  Membership changes
    mid-run three ways: a motion delta pulls a clamped voice back inside
    (delta-block ship), a delta pushes a near voice out, and one voice
    drifts across the clamp boundary on its own velocity (the idle-block
    path: one demoted block, then the list ships on the forced delta
    program).  Audio stays golden throughout and the warmed program set
    stops growing."""
    RATE, BLOCK, NBLK = 8000, 512, 16
    tt = np.arange(RATE, dtype=F) / F(RATE)
    boop = np.sin(tt * F(500 * 2 * np.pi), dtype=F)
    # max_distance 10 -> clamp boundary at (10/343 + 0.1)*343 = 44.3 m
    voices = [
        # (position, velocity): 3 near/slow (tight), 2 clamped, 1 fast,
        # 1 drifting across the boundary mid-run
        ([5.0, 2.0, 0.0], [2.0, 0.0, 0.0]),
        ([-8.0, 1.0, 3.0], [0.0, 1.5, 0.0]),
        ([0.0, -6.0, 2.0], [0.0, 0.0, 0.0]),
        ([60.0, 5.0, 0.0], [0.0, 0.0, 0.0]),
        ([-70.0, 0.0, 10.0], [0.0, 0.0, 0.0]),
        ([4.0, 0.0, 0.0], [100.0, 0.0, 0.0]),
        ([43.8, 0.0, 0.0], [2.0, 0.0, 0.0]),
    ]
    control, scene = ot.SpatialScene.new()
    hs = []
    oscene = ref.OSpatialScene(exact=True)
    ovs = []
    for pos, vel in voices:
        sig = ot.FramesSignal(ot.Frames.from_slice(RATE, boop), 0.0)
        hs.append(control.play_buffered(
            sig, ot.SpatialOptions(position=pos, velocity=vel),
            max_distance=10.0, rate=RATE, buffer_duration=0.1,
        ))
        osig = ref.OFramesSignal(ref.OFrames(RATE, boop), 0.0, exact=True)
        ovs.append(oscene.play_buffered(
            osig, pos, vel, 0.1,
            max_distance=10.0, rate=RATE, buffer_duration=0.1,
        ))
    r = ot.Renderer(scene, RATE)
    pool = list(scene._buffered_pools.values())[0]

    errs, subs, mains = [], [], []
    nsteps_mid = None
    for i in range(NBLK):
        if i == 4:
            # clamped voice 3 jumps back inside (discontinuous: no
            # smoothing transition) -> leaves the wide list
            for t in (hs[3], ovs[3]):
                t.set_motion([6.0, 1.0, 0.0], [0.0, 0.0, 0.0], True)
        if i == 7:
            # near voice 0 jumps beyond the boundary -> joins the list
            for t in (hs[0], ovs[0]):
                t.set_motion([80.0, 0.0, 0.0], [0.0, 0.0, 0.0], True)
        eng = r.render_block(BLOCK)
        buf = np.zeros((BLOCK, 2), F)
        ref.oddio_run(oscene, RATE, buf)
        errs.append(np.abs(eng - buf).max())
        subs.append((pool._sub_cfg, tuple(pool._sub_list)))
        mains.append(pool._read_cfg)
        if i == 12:
            nsteps_mid = len(r._steps)
    assert max(errs) <= 1e-5, (errs, subs, mains)
    assert np.abs(buf).max() > 1e-4
    # the main pool held a 512 tier on every block
    assert all(m is not None and m[0] == 512 for m in mains), mains
    # CERTAINLY-FROZEN voices (both offsets clamped, ds = 0 exactly) read
    # on the tight tier and never occupy sub-pass slots: the far statics
    # 3 and 4 are unlisted from
    # the start; the fast mover (5) and the band voice 6 (inside the
    # p_off-clamp transition band) engage the sub-pass initially
    assert 5 in subs[0][1] and 6 in subs[0][1], subs[0]
    assert all(3 not in s[1] and 4 not in s[1] for s in subs), subs
    assert subs[0][0] is not None
    # voice 0's jump beyond the boundary freezes it deep outside (never
    # listed); voices 5 and 6 end up frozen but NEAR the boundary, so the
    # pre-list horizon keeps them listed (membership ships in batches
    # instead of per crossing) — the list may only hold near-boundary
    # voices and must be stable at the end (no churn)
    assert all(0 not in s[1] for s in subs[8:]), subs[8:]
    assert set(subs[-1][1]) <= {5, 6}, subs[-1]
    assert subs[-2] == subs[-1], (subs[-2], subs[-1])
    # no new programs compile after every transition has been seen
    assert len(r._steps) == nsteps_mid, (len(r._steps), nsteps_mid)


def test_golden_slow_scene_tight_walk_tier():
    """A scene whose voices all move slowly (|v| <= ~10 m/s) renders reads
    on the tight K=32 tier (3-column select tables) chosen from the host
    geometry mirrors; a motion refresh mid-run re-bounds the walk through
    the smoothing transition and audio stays golden across every tier
    switch."""
    RATE, BLOCK, NBLK = 8000, 512, 16  # smoothing decays ~8 blocks after the delta
    tt = np.arange(RATE, dtype=F) / F(RATE)
    boop = np.sin(tt * F(500 * 2 * np.pi), dtype=F)

    control, scene = ot.SpatialScene.new()
    opts = ot.SpatialOptions(position=[-8.0, 2.0, 0.0], velocity=[4.0, 0.0, 0.0])
    sig = ot.FramesSignal(ot.Frames.from_slice(RATE, boop), 0.0)
    h = control.play_buffered(sig, opts, max_distance=60.0, rate=RATE,
                              buffer_duration=0.1)
    r = ot.Renderer(scene, RATE)

    oscene = ref.OSpatialScene(exact=True)
    osig = ref.OFramesSignal(ref.OFrames(RATE, boop), 0.0, exact=True)
    ov = oscene.play_buffered(osig, [-8.0, 2.0, 0.0], [4.0, 0.0, 0.0], 0.1,
                              max_distance=60.0, rate=RATE, buffer_duration=0.1)

    pool = list(scene._buffered_pools.values())[0]
    errs, tiers = [], []
    for i in range(NBLK):
        if i == 5:
            # a 12 m jump smooths over 0.5 s: apparent speed ~24 m/s + |v|
            # exceeds the K=32 budget until the transition decays
            h.set_motion([4.0, 2.0, 0.0], [4.0, 0.0, 0.0], False)
            ov.set_motion([4.0, 2.0, 0.0], [4.0, 0.0, 0.0], False)
        eng = r.render_block(BLOCK)
        buf = np.zeros((BLOCK, 2), F)
        ref.oddio_run(oscene, RATE, buf)
        errs.append(np.abs(eng - buf).max())
        tiers.append(pool._read_cfg)
    assert tiers[1] == (512, 32), tiers  # idle blocks ride the tight tier
    assert tiers[5][1] > 32  # the transition re-bounds the walk
    assert tiers[-1] == (512, 32), tiers  # and it decays back
    assert max(errs) <= 1e-5, (errs, tiers)


def test_golden_heavy_downsample():
    """ds = 8 resampling: DR pools read with the exact whole-arena gather
    (frames.rs:176-201 resamples at any ratio, aliasing included), keep
    matching the oracle when a set_speed brings the step back to 1."""
    # BLOCK=256 keeps the reference's f32 ``offset += ds`` accumulation
    # wobble (positions reach n*ds = 2048, frames.rs:189-196) under the
    # 1e-5 bound; the engine's closed-form positions are near-exact
    RATE, BLOCK = 8000, 256
    data = np.sin(np.linspace(0, 700.0, 48000), dtype=F)
    hi = ot.Frames.from_slice(8 * RATE, data)  # 64 kHz source -> ds = 8
    table = np.sin(
        np.linspace(0, 2 * np.pi, 1024, endpoint=False), dtype=F
    ).astype(F)
    cyc_frames = ot.Frames.from_slice(RATE, table)

    mc, mixer = ot.Mixer.new(channels=1)
    mc.play(ot.FramesSignal(hi, 0.0))
    spc, sp = ot.Speed.new(ot.Cycle(cyc_frames))
    spc.set_speed(8.0)
    mc.play(sp)
    pool_flags = [p for p in mixer._pools.values() if p.is_dr]
    assert pool_flags, "expected DR pools"
    r = ot.Renderer(mixer, RATE)

    om = ref.OMixer(channels=1)
    om.play(ref.OFramesSignal(ref.OFrames(8 * RATE, data), 0.0, exact=True))
    osp = ref.OSpeed(ref.OCycle(ref.OFrames(RATE, table)), 8.0)
    om.play(osp)

    errs = []
    for i in range(8):
        if i == 4:
            spc.set_speed(1.0)
            osp.speed = np.float32(1.0)
        eng = r.render_block(BLOCK)
        buf = np.zeros(BLOCK, F)
        ref.oddio_run(om, RATE, buf)
        errs.append(np.abs(eng[:, 0] - buf).max())
    assert max(errs) <= 1e-5, errs


@pytest.mark.parametrize("rring,force_host", [
    (12000, False),  # ratio 1.5: tiered read (shorter chunk, wider K)
    (4000, False),   # ratio 0.5
    (24000, False),  # ratio 3.0: beyond every tier -> one untiered read
    (12000, True),   # host pool
    (24000, True),
])
def test_golden_buffered_rate_mismatch(rring, force_host):
    """play_buffered with ring rate != scene rate: Ring::sample resamples at
    ANY ratio (ring.rs:51-79), so reads step at ds = ratio x doppler.  The
    read tiers (and the exact fallbacks past them) must track the oracle —
    round 3 found the fixed-K walk silently clamping at ratio 1.5 (0.14 abs
    error); this pins every tier boundary on both pool kinds."""
    RATE, BLOCK, NBLK = 8000, 512, 8
    tt = np.arange(rring, dtype=F) / F(rring)
    boop = np.sin(tt * F(300 * 2 * np.pi), dtype=F)

    control, scene = ot.SpatialScene.new()
    sig = ot.FramesSignal(ot.Frames.from_slice(rring, boop), 0.0)
    if force_host:
        sig.dr_supported = lambda: False  # force the host pool
    opts = ot.SpatialOptions(position=[-10.0, 5.0, 0.0],
                             velocity=[20.0, 0.0, 0.0])
    h = control.play_buffered(sig, opts, max_distance=60.0, rate=rring,
                              buffer_duration=0.1)
    r = ot.Renderer(scene, RATE)

    oscene = ref.OSpatialScene(exact=True)
    osig = ref.OFramesSignal(ref.OFrames(rring, boop), 0.0, exact=True)
    ov = oscene.play_buffered(osig, [-10.0, 5.0, 0.0], [20.0, 0.0, 0.0], 0.1,
                              max_distance=60.0, rate=rring,
                              buffer_duration=0.1)
    errs = []
    for i in range(NBLK):
        if i == 4:
            h.set_motion([0.0, 5.0, 0.0], [20.0, 0.0, 0.0], False)
            ov.set_motion([0.0, 5.0, 0.0], [20.0, 0.0, 0.0], False)
        eng = r.render_block(BLOCK)
        buf = np.zeros((BLOCK, 2), F)
        ref.oddio_run(oscene, RATE, buf)
        errs.append(np.abs(eng - buf).max())
    pool = list(scene._buffered_pools.values())[0]
    if not force_host:
        expect_none = rring == 24000
        assert (pool._read_cfg is None) == expect_none, pool._read_cfg
    assert max(errs) <= 1e-5, errs
