"""Headline benchmark: spatialized voices per GPU in real time.

North star (BASELINE.json): render 4096 spatialized voices per device at
>=100x real time, 48 kHz stereo, 512-frame blocks.  Needs an NVIDIA GPU;
exits nonzero when JAX's default device is anything else.

Prints ONE JSON line with the flagship metric plus named secondary paths
(every number is regression-visible to the driver):

  value                 median sustained render rate of the 4096-voice
                        seek-path scene (play(); velocity-driven motion)
  seek_trials           per-trial array for the flagship number
  live_control_*        the same scene with 64 set_motion deltas per 0.5 s
                        game tick
  buffered_xrt          4096-voice play_buffered() scene (delay rings —
                        the only path for streams/arbitrary sources)
  buffered_mixed_xrt    the same with seek-scene motion (±5 m/s, ±30 m):
                        voices cross the max_delay*c clamp boundary
                        mid-run — the tier ladder + family sub-pass under
                        realistic game motion
  subpass_xrt           4096 buffered voices with 64 offset-clamped ones
                        (family sub-pass: wide-walk voices render on a
                        side wide-tier pass; the pool keeps its tight
                        tier)
  densemix_xrt          1024 gain-controlled voices -> Reinhard -> Tanh
  wavetable_xrt         1024 Cycle+Speed wavetable voices
  agc_xrt               256 Adapt (per-frame EMA scan) voices
  scenepack_xrt         16-scene ScenePack x 256 voices (Adapt(Stream)
                        prefilled + Adapt(Sine)), one-device (1,1) mesh,
                        on-device pack scans — BASELINE config 5 scaled
                        to one device; xrt is per-scene audio over wall
  scenes_per_chip_realtime
                        largest MEASURED N where N such scenes sustain
                        >= 1x real time per scene on one device (affine
                        fit through S=16/64 picks the candidate, which
                        is then measured; scenes64_xrt is the S=64 point)
  streams_mixer_xrt     64 prefilled Stream voices in a Mixer (drain)
  streams_spatial_xrt   64 prefilled Stream voices spatialized (drain)

Audio stays on device; each metric fetches only a digest scalar (the
end-to-end rate with bulk PCM egress goes to stderr).
"""

import json
import sys
import time

import numpy as np

VOICES = 4096
RATE = 48000
BLOCK = 512
CHUNK = 47  # blocks per live-tick dispatch (~0.5 s)
#: blocks per velocity-trial dispatch (~16 s of audio each; idle blocks
#: ship zero params, so width costs no upload)
VCHUNK = 1504
#: dispatches per velocity trial, pipelined (sync=False): the fixed
#: per-dispatch enqueue + digest-fetch cost amortizes over 2x the audio
#: with the same compiled program
NVCHUNKS = 2
#: dispatch-size quantization (core/run.py): keeps the compiled scan set
#: bounded when mid-run control deltas (sub-pass membership) split runs
BUCKETS = (VCHUNK, CHUNK, CHUNK - 1, 12, 3, 1)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_spatial(buffered):
    import oddio_tpu as ot

    rng = np.random.default_rng(0)
    control, scene = ot.SpatialScene.new(initial_capacity=VOICES)
    handles = []
    for _ in range(VOICES):
        sig = ot.Sine(rng.uniform(0, 6), rng.uniform(100, 2000))
        if buffered:
            # bounded motion keeps every voice inside max_delay*c for the
            # whole run (drifted voices clamp at -max_delay and demote the
            # pool to a small-chunk read tier).  ±0.2 m/s over the ~112 s
            # of audio the warmup+trials cover keeps the worst-case voice
            # at ~52 m norm, inside the 84.3 m clamp with margin
            opts = ot.SpatialOptions(
                position=rng.uniform(-15, 15, 3),
                velocity=rng.uniform(-0.2, 0.2, 3),
            )
        else:
            opts = ot.SpatialOptions(
                position=rng.uniform(-30, 30, 3), velocity=rng.uniform(-5, 5, 3)
            )
        if buffered:
            h = control.play_buffered(
                sig, opts, max_distance=50.0, rate=RATE, buffer_duration=0.1
            )
        else:
            h = control.play(sig, opts)
        handles.append(h)
    return control, scene, handles


def velocity_trials(r, scene, label, ntrials=3, nchunks=NVCHUNKS):
    """Sustained pipelined render rate, motion velocity-driven on device
    (reference semantics, spatial.rs:501-511): no per-tick control uploads
    in the loop."""
    import jax.numpy as jnp

    audio = nchunks * VCHUNK * BLOCK / RATE
    trials = []
    for _ in range(ntrials):
        t0 = time.time()
        for _ in range(nchunks):
            blocks = r.render_frames_device(BLOCK * VCHUNK, sync=False)
        total = float(np.asarray(jnp.sum(blocks[-1][-1] ** 2)))
        assert np.isfinite(total)
        trials.append(round(audio / (time.time() - t0), 2))
    if scene is not None and hasattr(scene, "sync"):
        scene.sync()
    log(f"[{label}] velocity-driven x{ntrials} -> "
        + ", ".join(f"{x:.1f}" for x in trials) + "x RT")
    return trials


def warmup(r, scene, handles, rng, label, p_lim=30.0, v_lim=5.0,
           live=False, buckets=False):
    import jax.numpy as jnp

    t0 = time.time()
    first = r.render_frames(BLOCK * 8)
    assert np.isfinite(first).all() and np.abs(first).max() > 0
    # warm every variant the timed loops use: a motion-delta block followed
    # by zero-delta scan blocks (audio kept on device) plus the digest op
    if live and handles:
        for h in handles[:64]:
            h.set_motion(rng.uniform(-p_lim, p_lim, 3),
                         rng.uniform(-v_lim, v_lim, 3), False)
        r.render_frames_device(BLOCK * CHUNK)  # delta single + bucket scans
        r.render_frames_device(BLOCK * CHUNK)  # idle tick-width scan
    if buckets:
        # scenes whose control plane splits dispatches mid-run (sub-pass
        # membership): compile every bucket size before the timed loop
        for b in (CHUNK, 12, 3, 1):
            r.render_frames_device(BLOCK * b)
    blocks = r.render_frames_device(BLOCK * VCHUNK)
    blocks = r.render_frames_device(BLOCK * VCHUNK)  # idle wide scan
    float(np.asarray(jnp.sum(blocks[-1][-1] ** 2)))
    log(f"[{label}] warmup incl. compile: {time.time()-t0:.1f}s")


#: game ticks per live trial (~16 s of audio at 47-block ticks)
LTICKS = 32


def live_trials(r, scene, handles, rng, label, ntrials=5):
    """Like velocity_trials but with 64 set_motion deltas per ~0.5 s game
    tick."""
    import jax.numpy as jnp

    audio = LTICKS * CHUNK * BLOCK / RATE
    trials = []
    upd = 0
    for _ in range(ntrials):
        t0 = time.time()
        for _ in range(LTICKS):
            for h in handles[upd : upd + 64]:
                h.set_motion(rng.uniform(-30, 30, 3), rng.uniform(-5, 5, 3),
                             False)
            upd = (upd + 64) % len(handles)
            blocks = r.render_frames_device(BLOCK * CHUNK, sync=False)
            scene.sync_prefetch()
        total = float(np.asarray(jnp.sum(blocks[-1][-1] ** 2)))
        assert np.isfinite(total) and total > 0
        trials.append(round(audio / (time.time() - t0), 2))
    scene.sync()
    log(f"[{label}] live-control x{ntrials} -> "
        + ", ".join(f"{x:.1f}" for x in trials) + "x RT")
    return trials


def bench_spatial(buffered, rng, with_live):
    import oddio_tpu as ot

    label = "buffered" if buffered else "seek"
    t0 = time.time()
    control, scene, handles = build_spatial(buffered)
    log(f"built {VOICES}-voice {label} scene in {time.time()-t0:.1f}s")
    r = ot.Renderer(scene, RATE, scan_buckets=BUCKETS)
    if buffered:
        warmup(r, scene, handles, rng, label, p_lim=15.0, v_lim=0.3,
               live=with_live)
    else:
        warmup(r, scene, handles, rng, label, live=with_live)
    live = live_trials(r, scene, handles, rng, label) if with_live else None
    # buffered trials stay at ONE dispatch each: doubling the run length
    # drifts the bounded-motion voices past the max_delay*c clamp late in
    # the run
    vel = velocity_trials(r, scene, label, ntrials=5,
                          nchunks=1 if buffered else NVCHUNKS)
    # end-to-end incl. bulk PCM egress (stderr only)
    t0 = time.time()
    out = r.render_frames(BLOCK * CHUNK)
    e2e = (CHUNK * BLOCK / RATE) / (time.time() - t0)
    log(f"[{label}] end-to-end incl. audio egress: {e2e:.2f}x RT "
        f"({out.nbytes/1e3:.0f} KB)")
    return vel, live


def bench_subpass(rng):
    """4096 buffered voices of which 64 sit beyond max_delay*c (offset
    clamped, frozen reads — spatial.rs:414-415).  Fully clamped voices read
    with ds = 0 exactly inside the main tight (512, 32) pass — no family
    sub-pass slots, no wide side pass, no demotion.  The sub-pass
    machinery itself is exercised by buffered_mixed's boundary-band churn
    and the goldens.

    The bounded voices move SLOWLY (±0.05 m/s) so none crosses into the
    clamp transition band during the ~225 s of simulated audio."""
    import oddio_tpu as ot

    control, scene = ot.SpatialScene.new(initial_capacity=VOICES)
    for i in range(VOICES):
        sig = ot.Sine(rng.uniform(0, 6), rng.uniform(100, 2000))
        if i < 64:
            # beyond (50/343 + 0.1)*343 = 84.3 m -> clamped, wide-listed
            p = rng.uniform(100, 150, 3) * rng.choice([-1.0, 1.0], 3)
            opts = ot.SpatialOptions(position=p)
        else:
            opts = ot.SpatialOptions(
                position=rng.uniform(-15, 15, 3),
                velocity=rng.uniform(-0.05, 0.05, 3),
            )
        control.play_buffered(
            sig, opts, max_distance=50.0, rate=RATE, buffer_duration=0.1
        )
    r = ot.Renderer(scene, RATE, scan_buckets=BUCKETS)
    warmup(r, scene, [], rng, "subpass")
    (tiers,) = control.read_tiers().values()
    log(f"[subpass] tiers={tiers}")
    assert tiers["read_cfg"] is not None and tiers["read_cfg"][0] == 512
    assert not tiers["demoted"] and tiers["frozen"] == 64
    assert tiers["listed"] == 0, tiers  # tight tier, not the sub-pass
    return velocity_trials(r, scene, "subpass", ntrials=3, nchunks=4)


def bench_buffered_mixed(rng):
    """4096 buffered voices under SEEK-scene motion (±5 m/s velocities,
    ±30 m positions): voices drift across the max_delay*c clamp boundary
    mid-run, so the family sub-pass membership changes while the clock is
    running — the tier machinery's real cost under game-like motion
    (spatial.rs:414-415 clamping)."""
    import oddio_tpu as ot

    control, scene = ot.SpatialScene.new(initial_capacity=VOICES)
    for _ in range(VOICES):
        control.play_buffered(
            ot.Sine(rng.uniform(0, 6), rng.uniform(100, 2000)),
            ot.SpatialOptions(position=rng.uniform(-30, 30, 3),
                              velocity=rng.uniform(-5, 5, 3)),
            max_distance=50.0, rate=RATE, buffer_duration=0.1,
        )
    r = ot.Renderer(scene, RATE, scan_buckets=BUCKETS)
    warmup(r, scene, [], rng, "buffered_mixed", buckets=True)
    # transition warmup: the drifting voices cross tier/membership
    # boundaries during the first trial-length of audio, compiling the
    # demoted-tier programs mid-trial — run one untimed trial so the timed
    # ones measure the engine in the regime the scene converges to
    control.tier_events()  # drop the warmup transitions
    velocity_trials(r, scene, "buffered_mixed warm", ntrials=1)
    (tiers,) = control.read_tiers().values()
    log(f"[buffered_mixed] tiers={tiers}")
    out = velocity_trials(r, scene, "buffered_mixed", ntrials=3)
    for pool, evs in control.tier_events().items():
        view = "; ".join(
            f"t={t:.1f}s cfg={c} sub={s} listed={l}"
            for t, c, s, l in evs[-6:]
        )
        log(f"[buffered_mixed] tier transitions ({pool}, {len(evs)} "
            f"since warm): {view}")
    return out


def bench_scenepack(rng):
    """BASELINE config 5 scaled to one device: a 16-scene ScenePack of 256
    voices each (32 Adapt(Stream) prefilled with 0.3 s of 8 kHz PCM + 224
    Adapt(Sine)), rendered through on-device pack scans on a (1, 1) mesh.
    xrt = per-scene audio seconds over wall seconds (all 16 scenes render
    concurrently, so >= 1x means the whole pack holds real time)."""
    # nch=40 (1880-block trials) keeps the fixed per-trial enqueue + fetch
    # cost small against the trial
    pack = _build_pack(16, rng)
    trials = _pack_rate(pack, "scenepack", nch=40)
    log("[scenepack] 16 scenes x 256 voices -> "
        + ", ".join(f"{x:.1f}" for x in trials) + "x RT per scene")
    return trials


def _build_pack(S, rng, unroll=8, mesh=None):
    """A ScenePack of S BASELINE-config-5 scenes (256 voices each: 32
    Adapt(Stream) prefilled + 224 Adapt(Sine)) on ``mesh`` (default: a
    (1, 1) mesh).  scan_unroll=8: small-scene packs are per-iteration
    fixed-cost bound."""
    import oddio_tpu as ot
    from oddio_tpu.parallel.mesh import make_mesh
    from oddio_tpu.parallel.sharded import ScenePack

    V, NS, FILL = 256, 32, 2400

    def build(seed):
        rng2 = np.random.default_rng(seed)
        mixer = ot.Mixer(1, initial_capacity=NS)
        control = ot.MixerControl(mixer)
        ctls = []
        for i in range(V):
            opt = ot.AdaptOptions(tau=0.1, max_gain=4.0)
            if i < NS:
                stream = ot.Stream(8000, FILL + 128, max_write_per_block=FILL)
                ctls.append(stream.control)
                control.play(ot.Adapt(stream, 0.1, opt))
            else:
                control.play(ot.Adapt(
                    ot.Sine(rng2.uniform(0, 6), rng2.uniform(50, 2000)),
                    0.1, opt,
                ))
        return mixer, ctls

    scenes, ctls = zip(*[build(s) for s in range(S)])
    mesh = make_mesh(1, 1) if mesh is None else mesh
    pack = ScenePack(list(scenes), RATE, mesh, scan_unroll=unroll)
    pcm = rng.standard_normal((S * NS, FILL)).astype(np.float32) * 0.1
    for j, ctl in enumerate(c for group in ctls for c in group):
        ctl.write(pcm[j])
    return pack


def _pack_rate(pack, label, ntrials=2, nch=4):
    """Per-scene xRT of a warmed pack."""
    import jax.numpy as jnp

    t0 = time.time()
    blocks = pack.render_frames_device(BLOCK * 8)
    blocks = pack.render_frames_device(BLOCK * CHUNK)
    float(np.asarray(jnp.sum(blocks[-1][-1] ** 2)))
    log(f"[{label}] warmup incl. compile + PCM upload: {time.time()-t0:.1f}s")
    audio = nch * CHUNK * BLOCK / RATE
    trials = []
    for _ in range(ntrials):
        t0 = time.time()
        for _ in range(nch):
            blocks = pack.render_frames_device(BLOCK * CHUNK)
        total = float(np.asarray(jnp.sum(blocks[-1][-1] ** 2)))
        assert np.isfinite(total)
        trials.append(round(audio / (time.time() - t0), 2))
    pack.sync()
    return trials


def bench_scenes_capacity(rng, r16):
    """BASELINE config 5 at its stated SCALE: the largest N where N
    256-voice Stream+AGC scenes sustain >= 1x real time per scene on one
    device.  Measures a second pack size (64), fits the affine per-block
    cost T(S) = a + b*S through the two measured points, predicts the
    break-even N, then MEASURES the predicted point — the reported value
    is the largest measured-or-verified N with rate >= 1."""
    r16_med = float(np.median(r16))
    t16 = (BLOCK / RATE) / r16_med  # seconds per block at S=16
    pack = _build_pack(64, rng)
    r64 = _pack_rate(pack, "scenes64")
    log(f"[scenes64] 64 scenes x 256 voices -> "
        + ", ".join(f"{x:.1f}" for x in r64) + "x RT per scene")
    r64_med = float(np.median(r64))
    t64 = (BLOCK / RATE) / r64_med
    b = max((t64 - t16) / (64 - 16), 1e-9)
    a = max(t16 - b * 16, 0.0)
    n_hat = int((BLOCK / RATE - a) / b)
    # quantize to multiples of 32: each pack size compiles its own program,
    # so the candidate must hit the persistent cache across runs despite
    # fit jitter
    n_hat = max(32, min(1024, (n_hat // 32) * 32))
    log(f"[scenes_capacity] fit a={a*1e3:.3f}ms b={b*1e3:.4f}ms/scene "
        f"-> predicted break-even N={n_hat}")
    if r64_med < 1.0:
        verified = 16 if r16_med >= 1.0 else 0
        return verified, r64
    if n_hat <= 64:
        return 64, r64
    # verify the candidate; on a miss, rescale by the measured rate (with
    # a small safety margin — the affine fit runs slightly optimistic at
    # large S) and verify again (three measured sizes max — each compiles
    # a program).  Only sizes VERIFIED at >= 1x are ever reported; the
    # safety margin makes the post-miss candidates land under break-even
    # so a near-miss at the fit point ends on a verified large size
    # instead of falling back to 64.
    best = 64
    for _ in range(3):
        pack = _build_pack(n_hat, rng)
        rv = _pack_rate(pack, f"scenes{n_hat}")
        rv_med = float(np.median(rv))
        log(f"[scenes{n_hat}] -> " + ", ".join(f"{x:.1f}" for x in rv)
            + "x RT per scene")
        if rv_med >= 1.0:
            return n_hat, r64
        n2 = max(64, min(n_hat - 32,
                         (int(n_hat * rv_med * 0.97) // 32) * 32))
        if n2 <= best:
            break
        n_hat = n2
    return best, r64


def bench_densemix(rng):
    import oddio_tpu as ot

    control, mixer = ot.Mixer.new(channels=1)
    gcs = []
    for _ in range(1024):
        gc, g = ot.Gain.new(ot.Sine(rng.uniform(0, 6), rng.uniform(50, 4000)))
        gc.set_gain(rng.uniform(-20, 0))
        gcs.append(gc)
        control.play(g)
    chain = ot.Tanh(ot.Reinhard(mixer))
    # 1024-voice mixer scenes are partly op-launch bound: unroll 4 blocks
    # per scan iteration
    r = ot.Renderer(chain, RATE, scan_buckets=BUCKETS, scan_unroll=4)
    warmup(r, mixer, [], rng, "densemix")
    return velocity_trials(r, mixer, "densemix", ntrials=2, nchunks=4)


def build_agc(rng):
    """256 Adapt-wrapped voices in one Mixer (adapt.rs:69-88)."""
    import oddio_tpu as ot

    control, mixer = ot.Mixer.new(channels=1)
    for _ in range(256):
        control.play(ot.Adapt(
            ot.Sine(rng.uniform(0, 6), rng.uniform(50, 2000)),
            0.1, ot.AdaptOptions(tau=0.1, max_gain=4.0),
        ))
    return mixer


def bench_agc(rng):
    """The per-frame AGC EMA (adapt.rs:69-88) is sequential over the frame
    axis — this line makes its cost regression-visible."""
    import oddio_tpu as ot

    mixer = build_agc(rng)
    # 256-voice scenes are op-launch bound: unroll 4 blocks per iteration
    r = ot.Renderer(mixer, RATE, scan_buckets=BUCKETS, scan_unroll=4)
    warmup(r, mixer, [], rng, "agc")
    return velocity_trials(r, mixer, "agc", ntrials=2, nchunks=4)


def build_wavetable(rng):
    """1024 Cycle+Speed wavetable voices in one Mixer."""
    import oddio_tpu as ot

    table = np.sin(np.linspace(0, 2 * np.pi, 2048, endpoint=False)).astype(
        np.float32
    )
    frames = ot.Frames.from_slice(RATE, table)
    control, mixer = ot.Mixer.new(channels=1)
    for _ in range(1024):
        c = ot.Cycle(frames)
        c.seek(float(rng.uniform(0, 0.04)))
        control.play(ot.Speed.new(c)[1])
    return mixer


def bench_wavetable(rng):
    import oddio_tpu as ot

    mixer = build_wavetable(rng)
    r = ot.Renderer(mixer, RATE, scan_buckets=BUCKETS)
    warmup(r, mixer, [], rng, "wavetable")
    return velocity_trials(r, mixer, "wavetable", ntrials=2, nchunks=4)


#: blocks per stream-drain dispatch (4x-wide: at 64 voices a CHUNK-block
#: dispatch costs about its fixed enqueue overhead)
DRAIN_CHUNK = CHUNK * 4


def build_streams(rng, spatial, seconds=13):
    """64 Stream voices prefilled with ``seconds`` of PCM each, in a Mixer
    or spatialized through play_buffered."""
    import oddio_tpu as ot

    n_streams = 64
    fill = seconds * RATE
    if spatial:
        control, scene = ot.SpatialScene.new(initial_capacity=n_streams)
    else:
        control, scene = ot.Mixer.new(channels=1)
    ctls = []
    for _ in range(n_streams):
        ctl, s = ot.Stream.new(RATE, fill + RATE // 4)
        if spatial:
            control.play_buffered(
                s, ot.SpatialOptions(position=rng.uniform(-20, 20, 3)),
                max_distance=50.0, rate=RATE, buffer_duration=0.1,
            )
        else:
            control.play(s)
        ctls.append(ctl)
    data = rng.standard_normal((n_streams, fill)).astype(np.float32) * 0.05
    for j, ctl in enumerate(ctls):
        ctl.write(data[j])
    return scene


def bench_streams(rng, spatial):
    """Engine-side drain rate of 64 prefilled streams."""
    import jax.numpy as jnp

    import oddio_tpu as ot

    label = "streams_spatial" if spatial else "streams_mixer"
    fill = 13 * RATE
    scene = build_streams(rng, spatial)
    # 64-voice scenes are per-block fixed-cost bound: unrolling 4 blocks
    # per scan iteration amortizes it; the top bucket must BE the dispatch
    # width so a drain dispatch is one scan
    r = ot.Renderer(scene, RATE, scan_buckets=(DRAIN_CHUNK, CHUNK, 12, 3, 1),
                    scan_unroll=4)
    chunk2 = DRAIN_CHUNK
    t0 = time.time()
    first = r.render_frames(BLOCK * 8)
    assert np.isfinite(first).all()
    blocks = r.render_frames_device(BLOCK * chunk2)
    float(np.asarray(jnp.sum(blocks[-1][-1] ** 2)))
    log(f"[{label}] warmup incl. compile + buffer upload: {time.time()-t0:.1f}s")
    # chunks that fit the remaining PCM after warmup (8 + chunk2 blocks)
    # and the pipeline-fill chunk below, with 0.3 s of slack
    nch = min(int(((fill - 0.3 * RATE) / BLOCK - 8 - chunk2) // chunk2), 21)
    # one untimed chunk fills the dispatch pipeline
    blocks = r.render_frames_device(BLOCK * chunk2, sync=False)
    float(np.asarray(jnp.sum(blocks[-1][-1] ** 2)))
    t0 = time.time()
    for _ in range(nch - 1):
        blocks = r.render_frames_device(BLOCK * chunk2, sync=False)
    total = float(np.asarray(jnp.sum(blocks[-1][-1] ** 2)))
    assert np.isfinite(total)
    xrt = round((nch - 1) * chunk2 * BLOCK / RATE / (time.time() - t0), 2)
    log(f"[{label}] drain rate: {xrt:.1f}x RT")
    return xrt


def main():
    import jax

    from oddio_tpu.utils.cache import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs an NVIDIA GPU; JAX's default device is "
                 f"{dev.platform} ({dev.device_kind})")
    use_compile_cache()
    log(f"devices: {jax.devices()}")
    rng = np.random.default_rng(1)

    seek_vel, seek_live = bench_spatial(False, rng, with_live=True)
    buf_vel, _ = bench_spatial(True, rng, with_live=False)
    buf_mixed = bench_buffered_mixed(rng)
    subpass = bench_subpass(rng)
    densemix = bench_densemix(rng)
    wavetable = bench_wavetable(rng)
    agc = bench_agc(rng)
    scenepack = bench_scenepack(rng)
    scenes_cap, scenes64 = bench_scenes_capacity(rng, scenepack)
    sm = bench_streams(rng, spatial=False)
    ss = bench_streams(rng, spatial=True)

    value = float(np.median(seek_vel))
    print(json.dumps({
        "metric": f"spatial_{VOICES}v_{RATE//1000}kHz_stereo_render_xrt",
        "value": round(value, 2),
        "unit": "x_realtime",
        "vs_baseline": round(value / 100.0, 3),
        "seek_trials": seek_vel,
        "live_control_xrt": float(np.median(seek_live)),
        "live_trials": seek_live,
        "buffered_xrt": float(np.median(buf_vel)),
        "buffered_trials": buf_vel,
        "buffered_mixed_xrt": float(np.median(buf_mixed)),
        "buffered_mixed_trials": buf_mixed,
        "subpass_xrt": float(np.median(subpass)),
        "subpass_trials": subpass,
        "densemix_xrt": float(np.median(densemix)),
        "wavetable_xrt": float(np.median(wavetable)),
        "agc_xrt": float(np.median(agc)),
        "scenepack_xrt": float(np.median(scenepack)),
        "scenepack_trials": scenepack,
        "scenes_per_chip_realtime": scenes_cap,
        "scenes64_xrt": float(np.median(scenes64)),
        "streams_mixer_xrt": sm,
        "streams_spatial_xrt": ss,
    }))


if __name__ == "__main__":
    main()
