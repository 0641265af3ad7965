"""Unit tests porting the reference's inline test vectors.

Each test cites the reference test it mirrors; expected values are the exact
arrays from oddio's `#[cfg(test)]` modules (dyadic rationals, so f32 math is
bit-exact and `==` comparisons are meaningful).
"""

import numpy as np
import pytest

import oddio_tpu as ot


def sample(sig, interval, n):
    """Drive a signal like oddio's tests drive `Signal::sample`."""
    r = getattr(sig, "_test_renderer", None)
    if r is None:
        r = ot.Renderer(sig, 1)
        sig._test_renderer = r
    return r.render_block(n, interval=np.float32(interval))


def mono(block):
    assert block.shape[1] == 1
    return block[:, 0]


# --- FramesSignal (frames.rs:250-304) --------------------------------------


def test_frames_from_slice():
    data = [1.0, 2.0, 3.0]
    f = ot.Frames.from_slice(1, data)
    assert len(f) == 3
    np.testing.assert_array_equal(f.data, np.float32(data))


def test_frames_sample():
    """frames.rs:269-275: resampling and out-of-range zero padding."""
    sig = ot.FramesSignal(ot.Frames.from_slice(1, [1.0, 2.0, 3.0, 4.0]), -2.0)
    np.testing.assert_array_equal(mono(sample(sig, 0.25, 4)), [0.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(mono(sample(sig, 0.5, 3)), [0.0, 0.5, 1.0])
    np.testing.assert_array_equal(
        mono(sample(sig, 1.0, 5)), [1.5, 2.5, 3.5, 2.0, 0.0]
    )


def test_frames_playback_position():
    """frames.rs:277-303."""
    control, sig = ot.FramesSignal.new(ot.Frames.from_slice(1, [1.0, 2.0, 3.0]), -2.0)
    assert control.playback_position() == -2.0
    assert not control.is_finished()

    sample(sig, 0.2, 10)
    assert control.playback_position() == 0.0
    assert not control.is_finished()

    sample(sig, 0.1, 10)
    assert control.playback_position() == 1.0
    sample(sig, 0.1, 10)
    assert control.playback_position() == 2.0
    sample(sig, 0.2, 10)
    assert control.is_finished()
    assert control.playback_position() == 4.0
    sample(sig, 0.5, 10)
    assert control.playback_position() == 9.0


def test_frames_interpolate():
    f = ot.Frames.from_slice(1, [1.0, 2.0, 3.0])
    assert f.interpolate(0.5) == 1.5
    assert f.interpolate(-1.0) == 0.0
    assert f.interpolate(2.5) == pytest.approx(1.5)  # (3.0, 0.0) pair
    assert f.interpolate(5.0) == 0.0


# --- Sine -------------------------------------------------------------------


def test_sine_values():
    sig = ot.Sine(0.0, 1.0)  # 1 Hz
    out = mono(sample(sig, 0.25, 4))
    expected = np.sin(np.float32(2 * np.pi) * np.float32([0.0, 0.25, 0.5, 0.75]))
    np.testing.assert_allclose(out, expected, atol=1e-6)


def test_sine_phase_continuity():
    a = ot.Sine(0.3, 440.0)
    b = ot.Sine(0.3, 440.0)
    whole = mono(sample(a, 1.0 / 48000.0, 256))
    first = mono(sample(b, 1.0 / 48000.0, 128))
    second = mono(sample(b, 1.0 / 48000.0, 128))
    np.testing.assert_allclose(np.concatenate([first, second]), whole, atol=1e-5)


def test_sine_seek():
    a = ot.Sine(0.0, 2.0)
    a.host_seek(0.25)
    out = mono(sample(a, 0.125, 2))
    expected = np.sin(np.float32(2 * np.pi) * np.float32(2.0) * np.float32([0.25, 0.375]))
    np.testing.assert_allclose(out, expected, atol=1e-6)


# --- Gain (gain.rs:165-180) --------------------------------------------------


def test_gain_smoothing():
    """gain.rs:170-179: exact ramp values over the 0.1 s smoothing period."""
    control, sig = ot.Gain.new(ot.Constant(1.0))
    control.set_amplitude_ratio(5.0)
    out = mono(sample(sig, 0.025, 6))
    np.testing.assert_array_equal(out, [1.0, 2.0, 3.0, 4.0, 5.0, 5.0])
    out = mono(sample(sig, 0.025, 6))
    np.testing.assert_array_equal(out, [5.0] * 6)


def test_fixed_gain_db():
    sig = ot.FixedGain(ot.Constant(1.0), -6.0)
    out = mono(sample(sig, 1.0, 4))
    np.testing.assert_allclose(out, 10.0 ** (-6.0 / 20.0), rtol=1e-6)


def test_gain_control_getters():
    control, sig = ot.Gain.new(ot.Constant(1.0))
    control.set_gain(-20.0)
    assert control.amplitude_ratio() == pytest.approx(0.1)
    assert control.gain() == pytest.approx(-20.0, abs=1e-4)


# --- Speed -------------------------------------------------------------------


def test_speed_scales_interval():
    control, sig = ot.Speed.new(ot.FramesSignal(ot.Frames.from_slice(1, [0.0, 1.0, 2.0, 3.0]), 0.0))
    control.set_speed(2.0)
    out = mono(sample(sig, 0.5, 3))
    np.testing.assert_array_equal(out, [0.0, 1.0, 2.0])


# --- MonoToStereo (signal.rs:110-116) ----------------------------------------


def test_mono_to_stereo():
    sig = ot.MonoToStereo(ot.FramesSignal(ot.Frames.from_slice(1, [0.0, 1.0, 2.0, 3.0]), 0.0))
    out = sample(sig, 1.0, 4)
    np.testing.assert_array_equal(
        out, [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]
    )


# --- Downmix (downmix.rs:50-61) ----------------------------------------------


def test_downmix_smoke():
    sig = ot.Downmix(ot.Constant([1.0, 2.0]))
    out = mono(sample(sig, 1.0, 384))
    np.testing.assert_array_equal(out, np.full(384, 3.0, np.float32))


# --- Reinhard / Tanh -----------------------------------------------------------


def test_reinhard():
    sig = ot.Reinhard(ot.Constant(3.0))
    out = mono(sample(sig, 1.0, 8))
    np.testing.assert_allclose(out, 3.0 / 4.0, rtol=1e-7)


def test_tanh():
    sig = ot.Tanh(ot.Constant(0.5))
    out = mono(sample(sig, 1.0, 8))
    # XLA's f32 tanh differs from numpy's correctly-rounded one by ~1e-5 rel.
    np.testing.assert_allclose(out, np.tanh(0.5), atol=1e-5)


# --- Cycle (cycle.rs:64-122) ---------------------------------------------------


def make_cycle():
    return ot.Cycle(ot.Frames.from_slice(1, [1.0, 2.0, 3.0]))


def test_cycle_wrap_single():
    s = make_cycle()
    np.testing.assert_array_equal(mono(sample(s, 1.0, 5)), [1.0, 2.0, 3.0, 1.0, 2.0])


def test_cycle_wrap_multi():
    s = make_cycle()
    np.testing.assert_array_equal(mono(sample(s, 1.0, 2)), [1.0, 2.0])
    np.testing.assert_array_equal(mono(sample(s, 1.0, 3)), [3.0, 1.0, 2.0])


def test_cycle_wrap_fract():
    s = make_cycle()
    np.testing.assert_array_equal(mono(sample(s, 0.5, 2)), [1.0, 1.5])
    np.testing.assert_array_equal(
        mono(sample(s, 0.5, 6)), [2.0, 2.5, 3.0, 2.0, 1.0, 1.5]
    )


def test_cycle_wrap_fract_offset():
    s = make_cycle()
    s.host_seek(0.25)
    np.testing.assert_array_equal(mono(sample(s, 0.5, 2)), [1.25, 1.75])
    np.testing.assert_array_equal(
        mono(sample(s, 0.5, 5)), [2.25, 2.75, 2.5, 1.5, 1.25]
    )


def test_cycle_wrap_single_frame():
    s = ot.Cycle(ot.Frames.from_slice(1, [1.0]))
    s.host_seek(0.25)
    np.testing.assert_array_equal(mono(sample(s, 1.0, 2)), [1.0, 1.0])
    np.testing.assert_array_equal(mono(sample(s, 1.0, 1)), [1.0])


def test_cycle_wrap_large_interval():
    s = make_cycle()
    np.testing.assert_array_equal(mono(sample(s, 10.0, 2)), [1.0, 2.0])
    np.testing.assert_array_equal(mono(sample(s, 10.0, 1)), [3.0])


# --- Smoothed (smooth.rs doctest) -----------------------------------------------


def test_smoothed():
    v = ot.Smoothed(0.0)
    assert v.get() == 0.0
    v.set(1.0)
    assert v.get() == 0.0
    v.advance(0.5)
    assert v.get() == 0.5
    v.set(1.5)
    v.advance(0.5)
    assert v.get() == 1.0
    v.advance(0.5)
    assert v.get() == 1.5
    v.advance(0.5)
    assert v.get() == 1.5


# --- Mixer (mixer.rs:124-148) ------------------------------------------------


def test_mixer_is_stopped():
    """mixer.rs:129-147: finished voices are noticed one scan late."""
    control, mixer = ot.Mixer.new(channels=1)
    sig = ot.FramesSignal(ot.Frames.from_slice(1, [0.0, 0.0]), 0.0)
    handle = control.play(sig)
    assert not handle.is_stopped()

    sample(mixer, 0.6, 1)
    assert not handle.is_stopped()

    sample(mixer, 0.6, 1)
    # Signal is finished, but we won't actually notice until the next scan
    assert not handle.is_stopped()

    sample(mixer, 0.0, 1)
    assert handle.is_stopped()


def test_mixer_sums_voices():
    control, mixer = ot.Mixer.new(channels=1)
    control.play(ot.Constant(1.0))
    control.play(ot.Constant(2.0))
    out = mono(sample(mixer, 1.0, 4))
    np.testing.assert_array_equal(out, [3.0, 3.0, 3.0, 3.0])
    # different archetype joins a second pool
    control.play(ot.Sine(np.pi / 2, 0.0))  # constant 1.0 via sine
    out = mono(sample(mixer, 1.0, 4))
    np.testing.assert_allclose(out, [4.0] * 4, atol=1e-6)


def test_mixer_stop_and_reuse():
    control, mixer = ot.Mixer.new(channels=1)
    h1 = control.play(ot.Constant(1.0))
    sample(mixer, 1.0, 2)
    h1.stop()
    out = mono(sample(mixer, 1.0, 2))
    np.testing.assert_array_equal(out, [0.0, 0.0])
    assert h1.is_stopped()
    h2 = control.play(ot.Constant(5.0))
    out = mono(sample(mixer, 1.0, 2))
    np.testing.assert_array_equal(out, [5.0, 5.0])
    assert not h2.is_stopped()
    assert h1.is_stopped()  # stale handle stays stopped


def test_mixer_growth():
    control, mixer = ot.Mixer.new(channels=1)
    handles = [control.play(ot.Constant(1.0)) for _ in range(40)]
    out = mono(sample(mixer, 1.0, 2))
    np.testing.assert_array_equal(out, [40.0, 40.0])
    for h in handles[:39]:
        h.stop()
    out = mono(sample(mixer, 1.0, 2))
    np.testing.assert_array_equal(out, [1.0, 1.0])


def test_mixer_masked_equals_naive():
    """Property: the masked dense mixer equals a naive per-voice loop."""
    rng = np.random.default_rng(0)
    control, mixer = ot.Mixer.new(channels=1)
    freqs = rng.uniform(50, 1000, size=8)
    for f in freqs:
        control.play(ot.Sine(0.0, f))
    out = mono(sample(mixer, 1.0 / 48000.0, 256))
    t = np.arange(256, dtype=np.float32) * np.float32(1.0 / 48000.0)
    naive = sum(
        np.sin(t * np.float32(np.float32(f) * np.float32(2 * np.pi)))
        for f in freqs
    )
    np.testing.assert_allclose(out, naive, atol=1e-5)


def test_mixer_dr_pool_matches_host_pool():
    """The device-resident mixer pool (mask/finish tracking on device,
    sparse play/stop deltas) produces bit-identical audio to the host pool
    machinery for the same voices (mixer.rs:92-118 semantics)."""
    rng = np.random.default_rng(3)
    freqs = rng.uniform(50, 800, 6)

    def build(dr):
        control, mixer = ot.Mixer.new(channels=1)
        hs = []
        for f in freqs:
            sig = ot.FixedGain(ot.Sine(0.1, f), -3.0)
            if not dr:
                sig.dr_supported = lambda: False  # force the host pool
            hs.append(control.play(sig))
        return control, mixer, hs

    c1, m1, h1 = build(True)
    c2, m2, h2 = build(False)
    pool1 = next(iter(m1._pools.values()))
    pool2 = next(iter(m2._pools.values()))
    assert pool1.is_dr and not pool2.is_dr
    r1, r2 = ot.Renderer(m1, 48000), ot.Renderer(m2, 48000)
    # the DR sine carries its phase as wrapped f32 cycles vs the host path's
    # f64 phase (sine.py dr docstring): ~eps/block representation wobble,
    # both inside the 1e-5 golden contract vs the reference
    np.testing.assert_allclose(
        r1.render_frames(1024, 256), r2.render_frames(1024, 256), atol=1e-5
    )
    # stop one voice: applies at the next block in both
    h1[2].stop()
    h2[2].stop()
    np.testing.assert_allclose(
        r1.render_frames(512, 256), r2.render_frames(512, 256), atol=1e-5
    )
    assert h1[2].is_stopped() and h2[2].is_stopped()
    assert not h1[0].is_stopped()


def test_mixer_dr_growth_and_finish():
    """DR pool growth (play beyond capacity) and natural finish reclamation
    through a render_block-only loop."""
    control, mixer = ot.Mixer.new(channels=1)
    frames = ot.Frames.from_slice(8000, np.ones(400, np.float32))
    handles = [
        control.play(ot.FramesSignal(ot.Frames.from_slice(8000, np.ones(400, np.float32)), 0.0))
        for _ in range(40)
    ]
    pool = next(iter(mixer._pools.values()))
    assert pool.is_dr and pool.capacity >= 40
    r = ot.Renderer(mixer, 8000)
    out = r.render_block(256)
    np.testing.assert_array_equal(out[:, 0], np.full(256, 40.0))
    out = r.render_block(256)  # sources end at frame 400
    np.testing.assert_array_equal(out[144:, 0], np.zeros(112))
    r.render_block(256)
    r.render_block(256)
    assert all(h.is_stopped() for h in handles)
    assert len(pool._free) == pool.capacity


@pytest.mark.parametrize("start,width", [
    (0, 512),      # flagship aligned slab, mirror leg into the mirror
    (700, 513),    # unaligned, slab straddles the mirror boundary
    (1536, 512),   # past the mirror: second leg goes to the dump slack
    (1900, 513),   # wraps past cap: tail lands on its home at ring [0, ..)
    (300, 1500),   # wider than one write chunk: two slab pairs
])
def test_ring_append_legs_and_wrap(start, width):
    """The DR ring append writes every sample at (start + k) mod cap and
    keeps the mirror region equal to ring [0, M) (ring.rs:18-41)."""
    import jax.numpy as jnp

    from oddio_tpu.spatial import _ring_append

    rng = np.random.default_rng(start + width)
    V, cap, FP, M = 3, 2048, 1024, 1024
    rowlen = FP + cap + M + FP
    ring = rng.standard_normal((V, rowlen)).astype(np.float32)
    ring[:, FP + cap : FP + cap + M] = ring[:, FP : FP + M]  # invariant
    samples = rng.standard_normal((V, width)).astype(np.float32)
    out = np.asarray(_ring_append(
        jnp.asarray(ring), jnp.asarray(samples), jnp.int32(start), cap, FP, M
    ))
    home = ring[:, FP : FP + cap].copy()
    home[:, (start + np.arange(width)) % cap] = samples
    np.testing.assert_array_equal(out[:, FP : FP + cap], home)
    np.testing.assert_array_equal(out[:, FP + cap : FP + cap + M], home[:, :M])


def _ring_read_oracle(ring, vidx, base, frac, ds, g0, dg, n, cap):
    """Per-voice f64 loop: lerp(ring[x], ring[x+1], fr) at base + frac +
    j*ds (mod cap), gain-ramped and summed (ring.rs:51-79)."""
    out = np.zeros((2, n))
    for r, v in enumerate(vidx):
        for e in range(2):
            pos = base[e][r] + np.float64(frac[e][r]) + np.arange(n) * ds[e][r]
            x = np.floor(pos).astype(np.int64)
            fr = pos - x
            a = ring[v, x % cap]
            b = ring[v, (x + 1) % cap]
            g = np.float64(g0[e][r]) + np.arange(n) * np.float64(dg[e][r])
            out[e] += (a + fr * (b - a)) * g
    return out


@pytest.mark.parametrize("V", [1, 3, 64])
def test_ring_read_matches_positions_oracle(V):
    """The plain DR ring read (gather + lerp + gain ramp + voice sum)
    against a float64 positions oracle, with frozen (ds = 0, offset
    clamped, spatial.rs:414-416) and masked voices and ring wrap."""
    import jax.numpy as jnp

    from oddio_tpu.ops._dev import split_ds
    from oddio_tpu.spatial import _ring_read

    rng = np.random.default_rng(V)
    cap, n, rowlen, front = 2048, 512, 4096, 1024
    ring = rng.standard_normal((V + 2, rowlen)).astype(np.float32)
    vidx = rng.permutation(V + 2)[:V].astype(np.int32)  # a voice subset
    base = [rng.integers(0, cap, V).astype(np.int32) for _ in range(2)]
    base[0][0] = cap - 7  # reads wrap past the end of the ring
    frac = [rng.uniform(0, 1, V).astype(np.float32) for _ in range(2)]
    ds = [rng.uniform(0.97, 1.03, V).astype(np.float32) for _ in range(2)]
    if V > 1:
        ds[0][1] = ds[1][1] = np.float32(0.0)  # frozen voice
    mask = (np.arange(V) % 5 != 4).astype(np.float32)
    g0 = [rng.uniform(0, 1, V).astype(np.float32) * mask for _ in range(2)]
    dg = [rng.uniform(-1e-3, 1e-3, V).astype(np.float32) * mask
          for _ in range(2)]
    split = [tuple(jnp.asarray(x) for x in split_ds(d)) for d in ds]
    got = np.asarray(_ring_read(
        jnp.asarray(ring.reshape(-1)),
        jnp.asarray(vidx * rowlen + front),
        [jnp.asarray(b) for b in base], [jnp.asarray(f) for f in frac],
        split, [jnp.asarray(g) for g in g0], [jnp.asarray(g) for g in dg],
        n, cap,
    ))
    ref = _ring_read_oracle(
        ring[:, front : front + cap], vidx, base, frac,
        [d.astype(np.float64) for d in ds], g0, dg, n, cap,
    )
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("C,wpos,wcount", [
    (1, 0, 300),
    (1, 700, 1),       # single-sample write
    (2, 900, 200),     # wraps past the ring end, stereo frames
])
def test_stream_ingest_write_extents(C, wpos, wcount):
    """Stream ingest (Receiver::update, stream.rs:24-69) writes exactly
    ``wcount`` frames at the write cursor (mod the ring size) and keeps
    every other lane's history, for a pool of voices."""
    import jax
    import jax.numpy as jnp

    stream = ot.Stream(8000, 1000, channels=C)
    size, V = stream.size_pad, 4
    rng = np.random.default_rng(wpos + wcount)
    ring = rng.standard_normal((V, C * stream._rows, 128)).astype(np.float32)
    chunk = rng.standard_normal((V, C, 400)).astype(np.float32)
    counts = np.array([wcount, 0, wcount // 2, wcount], np.int32)
    pos = (wpos + np.arange(V) * 37) % size
    out = np.asarray(jax.vmap(stream._write_one)(jnp.asarray(ring), {
        "chunk": jnp.asarray(chunk), "wcount": jnp.asarray(counts),
        "wpos": jnp.asarray(pos, jnp.int32),
    }))
    exp = ring.reshape(V, C, size).copy()
    for v in range(V):
        exp[v][:, (pos[v] + np.arange(counts[v])) % size] = chunk[v, :, : counts[v]]
    np.testing.assert_array_equal(out.reshape(V, C, size), exp)


def _resample_voice(kind, data):
    """(engine signal, scalar-oracle twin or None) of one sampler kind."""
    import reference_impl as ref

    if kind == "frames":
        sig = ot.FramesSignal(ot.Frames.from_slice(8000, data), 0.0)
        return sig, ref.OFramesSignal(ref.OFrames(8000, data), 0.0, exact=True)
    if kind == "cycle":
        table = data[:1024]
        return (ot.Cycle(ot.Frames.from_slice(8000, table)),
                ref.OCycle(ref.OFrames(8000, table)))
    sig = ot.Stream(8000, 4000)
    sig.control.write(data)
    return sig, None


@pytest.mark.parametrize("kind", ["frames", "cycle", "stream"])
@pytest.mark.parametrize("ratio", [1.0, 0.92, 3.0])
def test_dr_resample_matches_reference(kind, ratio):
    """Device-resident sampler reads (FramesSignal, Cycle, Stream in a DR
    mixer pool) at source/output rate ratios 1, 0.92 and 3, over blocks
    longer than one position-walk chunk where the oracle allows: Frames and Cycle against
    the scalar oracle (frames.rs:176-201, cycle.rs:26-53), Stream against
    the host pool's per-voice render (stream.rs:37-61)."""
    import reference_impl as ref

    data = np.sin(np.linspace(0, 2 * np.pi * 4, 4097)[:-1]).astype(np.float32)
    rate = int(round(8000 / ratio))
    # the oracle's Cycle accumulates its f32 offset per frame (cycle.rs:
    # 40-47), so its drift stays inside 1e-5 only over shorter blocks
    n, nblk = (128, 12) if kind == "cycle" else (600, 3)
    outs = []
    for dr in (True, False):
        sig, osig = _resample_voice(kind, data)
        if not dr:
            if osig is not None:
                om = ref.OMixer(channels=1)
                om.play(osig)
                bufs = [np.zeros(n, np.float32) for _ in range(nblk)]
                for b in bufs:
                    ref.oddio_run(om, rate, b)
                outs.append(np.concatenate(bufs)[:, None])
                break
            sig.dr_supported = lambda: False  # force the host pool
        control, mixer = ot.Mixer.new(channels=1)
        control.play(sig)
        assert next(iter(mixer._pools.values())).is_dr == dr
        r = ot.Renderer(mixer, rate)
        outs.append(np.concatenate([r.render_block(n) for _ in range(nblk)]))
    assert np.abs(outs[0]).max() > 0.1
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)


def test_submix_in_mixer():
    """A Mixer played into another Mixer (mixer.rs:18-26 boxes any
    Signal) renders through a singleton pool and can be stopped."""
    import oddio_tpu as ot

    mc_sub, sub = ot.Mixer.new(channels=1)
    mc_sub.play(ot.Sine(0.0, 440.0))
    mc_top, top = ot.Mixer.new(channels=1)
    h_sub = mc_top.play(sub)
    mc_top.play(ot.Sine(0.0, 100.0))
    pool_kinds = [getattr(p, "is_singleton", False)
                  for p in top._pools.values()]
    assert True in pool_kinds and False in pool_kinds
    r = ot.Renderer(top, 8000)
    out = r.render_frames(2048)
    s = np.abs(np.fft.rfft(out[:, 0]))
    peaks = set((np.argsort(s)[-2:] * 8000 // 2048).tolist())
    assert any(abs(p - 440) < 16 for p in peaks)
    assert any(abs(p - 100) < 16 for p in peaks)
    h_sub.stop()
    r.render_block(256)
    out2 = r.render_frames(2048)
    s2 = np.abs(np.fft.rfft(out2[:, 0]))
    assert abs(np.argmax(s2) * 8000 / 2048 - 100) < 16


def test_submix_singleton_pool_reuse():
    """Replaying a SAME-ARCHETYPE submix after the previous one stopped
    rebinds the freed singleton pool in place (PoolSingleton.rebind): no
    pool leak, no new compiled programs — the reference replays boxed
    signals freely (mixer.rs:18-26) and so must we."""
    import oddio_tpu as ot

    def make_sub(freq):
        c, m = ot.Mixer.new(channels=1)
        c.play(ot.Sine(0.0, freq))
        return m

    mc_top, top = ot.Mixer.new(channels=1)
    h1 = mc_top.play(make_sub(300.0))
    r = ot.Renderer(top, 8000)
    r.render_frames(1024)
    npools = len(top._pools)
    h1.stop()
    r.render_frames(1024)  # reap frees the singleton slot
    nsteps = len(r._steps)
    h2 = mc_top.play(make_sub(500.0))
    out = r.render_frames(4096)
    assert len(top._pools) == npools, "replay must reuse the freed pool"
    assert len(r._steps) == nsteps, "replay must not compile new programs"
    s = np.abs(np.fft.rfft(out[2048:, 0]))
    assert abs(np.argmax(s) * 8000 / 2048 - 500) < 16
    assert not h2.is_stopped()
    # a DIFFERENT-archetype submix still gets its own pool
    c3, sub3 = ot.Mixer.new(channels=1)
    c3.play(ot.Sine(0.0, 200.0))
    c3.play(ot.Sine(0.0, 700.0))
    mc_top.play(sub3)
    assert len(top._pools) == npools + 1
