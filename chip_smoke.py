"""Smoke test of oddio_tpu on NVIDIA GPUs, through the user entry points
(Renderer, Mixer, SpatialScene, ScenePack).

    python chip_smoke.py          # one GPU: device, golden, ring read, full width
    python chip_smoke.py --four   # four GPUs: the ScenePack mesh paths only

Phases run in order; the first failure ends the run with a nonzero exit
status.  Golden phases compare small scenes with the scalar oracle
(tests/reference_impl.py) to the PARITY.md contract of 1e-5.  Full-width
phases render >= 1 s of each benchmark scene at 48 kHz in 512-frame
blocks and compare the first 16 blocks with the same scene rendered by the
same code on the CPU backend in this process: max|diff| <= tol * max(1,
peak|out|).  All math is f32 with no matrix products; tol is 1e-5 (sums
taken in another order) except for the 4096-voice spatial scenes, see
SPATIAL_TOL.  The last line of stdout is one JSON object naming the
device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RATE = 48000
BLOCK = 512
#: blocks compared with the CPU render
CMP_BLOCKS = 16
#: blocks rendered per full-width scene (>= 1 s of audio at RATE)
TOTAL_BLOCKS = -(-RATE // BLOCK)
#: the golden contract against the scalar oracle (PARITY.md)
GOLDEN_TOL = 1e-5
#: GPU vs CPU bound for the 4096-voice spatial scenes, relative to
#: max(1, peak): each voice's ear time offsets come out of f32 geometry
#: whose last bits differ between XLA's GPU and CPU code, and the read
#: position (buffered) or phase (seek) turns a 1-ulp time difference into
#: an output error proportional to the source frequency (measured on an
#: H100: the seek scene's 1.5e-5 diff falls 29x with every source at 50 Hz
#: instead of 100-2000 Hz).  1e-4 is the f32 envelope PARITY.md documents
#: for these paths' time shifts.
SPATIAL_TOL = 1e-4


def log(msg):
    print(msg, flush=True)


# --- device ------------------------------------------------------------------


def phase_device(count=1):
    """Require ``count`` GPUs as JAX's default devices; print the card, the
    jax/jaxlib versions and nvidia-smi's name and power limit.  Exits with
    a message (status 1) on any other platform: nothing falls back to the
    CPU."""
    import jax
    import jaxlib

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX's default device is "
            f"{devs[0].platform} ({devs[0].device_kind})"
        )
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(f"[device] {devs[0].device_kind} x{len(devs)}, jax {jax.__version__}, "
        f"jaxlib {jaxlib.__version__}")
    log("[device] nvidia-smi name, power.limit:")
    for line in smi.splitlines():
        print(line, flush=True)
    from oddio_tpu.utils.cache import compile_cache_dir, use_compile_cache

    use_compile_cache()
    log(f"[device] compile cache: {compile_cache_dir()}")
    return devs


# --- step probing ------------------------------------------------------------


def _spec(x):
    import jax

    if isinstance(x, jax.Array):
        return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding)
    if isinstance(x, np.ndarray):
        return jax.ShapeDtypeStruct(x.shape, x.dtype)
    return x


class StepProbe:
    """Records the argument shapes of the last step ``obj`` dispatches
    through its step getter (``Renderer._get_step`` or
    ``ScenePack._get_scan_step``), so the step can be lowered again for
    ``memory_analysis`` after its donated inputs are gone."""

    def __init__(self, obj, getter):
        import jax

        self.last = None
        orig = getattr(obj, getter)

        def get(*a, **k):
            step = orig(*a, **k)

            def call(*args):
                self.last = (step, jax.tree.map(_spec, args))
                return step(*args)

            return call

        setattr(obj, getter, get)

    def memory_analysis(self, pack=False):
        from oddio_tpu.parallel.context import voice_axis
        from oddio_tpu.parallel.mesh import VOICE_AXIS

        step, specs = self.last
        with voice_axis(VOICE_AXIS if pack else None):
            return step.lower(*specs).compile().memory_analysis()


# --- golden ------------------------------------------------------------------


def _oracle():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import reference_impl

    return reference_impl


def _oracle_blocks(osig, rate, nblk, block, channels=1):
    ref = _oracle()
    shape = (block,) if channels == 1 else (block, channels)
    out = []
    for _ in range(nblk):
        buf = np.zeros(shape, np.float32)
        ref.oddio_run(osig, rate, buf)
        out.append(buf)
    out = np.concatenate(out)
    return out[:, None] if channels == 1 else out


def golden_sine_gain():
    """BASELINE config 1: Sine -> Gain -> Mixer with a mid-render ramp."""
    import oddio_tpu as ot

    ref = _oracle()
    rate, half = 44100, 4096
    control, mixer = ot.Mixer.new(channels=1)
    gctl, g = ot.Gain.new(ot.Sine(0.1, 500.0))
    control.play(g)
    r = ot.Renderer(mixer, rate)
    eng = [r.render_frames(half)]
    gctl.set_amplitude_ratio(0.25)
    eng.append(r.render_frames(half))
    om = ref.OMixer()
    og = ref.OGain(ref.OSine(0.1, 500.0, exact=True), exact=True)
    om.play(og)
    orc = [_oracle_blocks(om, rate, half // BLOCK, BLOCK)]
    og.set_amplitude_ratio(0.25)
    orc.append(_oracle_blocks(om, rate, half // BLOCK, BLOCK))
    return np.concatenate(eng), np.concatenate(orc)


def golden_frames_speed():
    """BASELINE config 2: a 44.1 kHz FramesSignal under Speed at 48 kHz."""
    import oddio_tpu as ot

    ref = _oracle()
    data = np.random.default_rng(7).uniform(-1, 1, 44100).astype(np.float32)
    sctl, sp = ot.Speed.new(
        ot.FramesSignal(ot.Frames.from_slice(44100, data), 0.0)
    )
    sctl.set_speed(1.2)
    eng = ot.Renderer(sp, RATE).render_frames(8192)
    osig = ref.OSpeed(
        ref.OFramesSignal(ref.OFrames(44100, data), 0.0, exact=True), 1.2
    )
    return eng, _oracle_blocks(osig, RATE, 8192 // BLOCK, BLOCK)


def golden_spatial64(buffered):
    """BASELINE config 3 (scaled): 64 moving sources in one SpatialScene,
    seek (play) or buffered (play_buffered) voices."""
    import oddio_tpu as ot

    ref = _oracle()
    rate, nblk = 8000, 4
    rng = np.random.default_rng(64)
    pos = rng.uniform(-15, 15, (64, 3))
    vel = rng.uniform(-5, 5, (64, 3))
    freq = rng.uniform(100, 900, 64)
    control, scene = ot.SpatialScene.new()
    oscene = ref.OSpatialScene(exact=True)
    for p, v, f in zip(pos, vel, freq):
        opts = ot.SpatialOptions(position=p, velocity=v)
        osig = ref.OSine(0.0, f, exact=True)
        if buffered:
            control.play_buffered(ot.Sine(0.0, f), opts, max_distance=50.0,
                                  rate=rate, buffer_duration=0.1)
            oscene.play_buffered(osig, p, v, 0.1, max_distance=50.0,
                                 rate=rate, buffer_duration=0.1)
        else:
            control.play(ot.Sine(0.0, f), opts)
            oscene.play(osig, p, v, 0.1)
    r = ot.Renderer(scene, rate)
    eng = np.concatenate([r.render_block(BLOCK) for _ in range(nblk)])
    return eng, _oracle_blocks(oscene, rate, nblk, BLOCK, channels=2)


def golden_adapt():
    """Adapt AGC over a mixer (BASELINE config 5's AGC component)."""
    import oddio_tpu as ot

    ref = _oracle()
    f32 = np.float32
    control, mixer = ot.Mixer.new(channels=1)
    control.play(ot.FixedGain(ot.Sine(0.0, 500.0), -30.0))
    sig = ot.Adapt(mixer, 1e-3 / np.sqrt(2), ot.AdaptOptions(
        tau=0.1, max_gain=1e6, low=0.1 / np.sqrt(2), high=0.5 / np.sqrt(2)))
    eng = ot.Renderer(sig, 44100).render_frames(4096)
    om = ref.OMixer()
    om.play(ref.OFixedGain(ref.OSine(0.0, 500.0), -30.0))
    s2 = np.sqrt(f32(2.0), dtype=f32)
    osig = ref.OAdapt(om, f32(1e-3) / s2, 0.1, 1e6, f32(0.1) / s2,
                      f32(0.5) / s2)
    return eng, _oracle_blocks(osig, 44100, 4096 // BLOCK, BLOCK)


def golden_stream():
    """Stream ingest (stream.rs:37-61): PCM written through StreamControl
    plays back at unit rate exactly, lerped at half rate, zero-padded on
    underrun."""
    import oddio_tpu as ot

    pcm = np.sin(np.arange(3000) * 0.05).astype(np.float32)
    outs, refs = [], []
    for rate in (8000, 16000):
        control, mixer = ot.Mixer.new(channels=1)
        ctl, s = ot.Stream.new(8000, 4000)
        control.play(s)
        ctl.write(pcm)
        r = ot.Renderer(mixer, rate)
        outs.append(r.render_frames(8 * BLOCK)[:, 0])
        x = np.arange(8 * BLOCK) * (8000 / rate)
        i = np.floor(x).astype(int)
        ext = np.concatenate([pcm, np.zeros(8 * BLOCK + 2, np.float32)])
        refs.append(ext[i] + (x - i) * (ext[i + 1] - ext[i]))
    return np.concatenate(outs), np.concatenate(refs)


GOLDENS = {
    "sine_gain_mixer": golden_sine_gain,
    "frames_speed_44k1_to_48k": golden_frames_speed,
    "spatial64_seek": lambda: golden_spatial64(False),
    "spatial64_buffered": lambda: golden_spatial64(True),
    "adapt": golden_adapt,
    "stream_ingest": golden_stream,
}


def phase_golden(names=None):
    """Small scenes on the default device vs the scalar oracle."""
    for name, fn in GOLDENS.items():
        if names is not None and name not in names:
            continue
        t0 = time.time()
        eng, orc = fn()
        err = float(np.abs(eng - orc).max())
        log(f"[golden] {name}: max|diff| vs oracle = {err:.3e} "
            f"({time.time() - t0:.1f} s)")
        if not np.isfinite(err) or err > GOLDEN_TOL:
            raise AssertionError(f"golden {name}: {err} > {GOLDEN_TOL}")


# --- full width --------------------------------------------------------------


def _bench():
    sys.path.insert(0, ROOT)
    import bench

    return bench


def _scenes():
    """name -> (build(seed, cpu) -> renderable, Renderer kwargs, is_pack,
    tolerance).  The constructions are bench.py's."""
    import jax

    b = _bench()

    def spatial(buffered):
        return lambda seed, cpu: b.build_spatial(buffered)[1]

    def pack(seed, cpu):
        from oddio_tpu.parallel.mesh import make_mesh

        devs = jax.devices("cpu") if cpu else None
        return b._build_pack(16, np.random.default_rng(seed),
                             mesh=make_mesh(1, 1, devices=devs))

    rng = np.random.default_rng
    return {
        "seek_4096": (spatial(False), {}, False, SPATIAL_TOL),
        "buffered_4096": (spatial(True), {}, False, SPATIAL_TOL),
        "wavetable_1024": (lambda s, c: b.build_wavetable(rng(s)), {}, False,
                           1e-5),
        "agc_256": (lambda s, c: b.build_agc(rng(s)), {"scan_unroll": 4},
                    False, 1e-5),
        "streams_mixer_64": (
            lambda s, c: b.build_streams(rng(s), False, seconds=2),
            {"scan_unroll": 4}, False, 1e-5),
        "streams_spatial_64": (
            lambda s, c: b.build_streams(rng(s), True, seconds=2),
            {"scan_unroll": 4}, False, 1e-5),
        "scenepack_16x256": (pack, {}, True, 1e-5),
    }


def _render(build, kwargs, is_pack, cpu, nblocks, probe=False):
    """Render ``nblocks`` blocks.  Returns the first CMP_BLOCKS on the host
    ((frames, C), or (S, frames, C) for a pack), whether every block is
    finite, the peak |sample|, and the StepProbe (or None)."""
    import jax.numpy as jnp

    import oddio_tpu as ot

    obj = build(1, cpu)
    if is_pack:
        sp = StepProbe(obj, "_get_scan_step") if probe else None
        head = obj.render_frames_device(BLOCK * CMP_BLOCKS)
        head = np.concatenate([np.asarray(x) for x in head])  # (B, S, C, n)
        head = np.moveaxis(head, 0, 2)  # (S, C, B, n)
        head = head.reshape(head.shape[0], head.shape[1], -1).transpose(0, 2, 1)
        render = obj.render_frames_device
    else:
        r = ot.Renderer(obj, RATE, **kwargs)
        sp = StepProbe(r, "_get_step") if probe else None
        head = r.render_frames(BLOCK * CMP_BLOCKS)
        render = r.render_frames_device
    rest = nblocks - CMP_BLOCKS
    digests = []
    if rest > 0:
        for x in render(BLOCK * rest):
            digests.append((jnp.all(jnp.isfinite(x)), jnp.max(jnp.abs(x))))
    finite = all(bool(f) for f, _ in digests) and np.isfinite(head).all()
    peak = max([float(m) for _, m in digests] + [float(np.abs(head).max())])
    return head, finite, peak, sp


def phase_full_width(names=None):
    """Each benchmark scene at full width: >= 1 s on the GPU (render_frames
    fetch + render_frames_device scans), finite and non-silent, first 16
    blocks against the CPU backend."""
    import jax

    cpu = jax.devices("cpu")[0]
    for name, (build, kwargs, is_pack, rel_tol) in _scenes().items():
        if names is not None and name not in names:
            continue
        t0 = time.time()
        head, finite, peak, sp = _render(build, kwargs, is_pack, False,
                                         TOTAL_BLOCKS, probe=True)
        t_gpu = time.time() - t0
        if not finite or peak <= 0.0:
            raise AssertionError(f"{name}: finite={finite} peak={peak}")
        mem = sp.memory_analysis(pack=is_pack)
        stats = jax.devices()[0].memory_stats() or {}
        t0 = time.time()
        with jax.default_device(cpu):
            want, _, _, _ = _render(build, kwargs, is_pack, True, CMP_BLOCKS)
        t_cpu = time.time() - t0
        diff = float(np.abs(head - want).max())
        tol = rel_tol * max(1.0, peak)
        log(f"[full] {name}: {TOTAL_BLOCKS} blocks, peak {peak:.4f}, "
            f"max|gpu - cpu| over {CMP_BLOCKS} blocks = {diff:.3e} "
            f"(tol {tol:.1e}); gpu {t_gpu:.1f} s, cpu {t_cpu:.1f} s "
            f"incl. compile")
        log(f"[full] {name}: step memory_analysis: {mem}")
        log(f"[full] {name}: peak_bytes_in_use "
            f"{stats.get('peak_bytes_in_use', 'n/a')}")
        if not diff <= tol:
            raise AssertionError(f"{name}: gpu vs cpu {diff} > {tol}")


# --- ring-read kernel ----------------------------------------------------------


def phase_ring_read():
    """The Triton ring-read kernel compiled for the card against the plain
    XLA read at V = 4096, n = 512: both ears, frozen (offset-clamped,
    ds = 0) and masked voices, reads wrapping past the ring end, gains at
    distance-attenuation scale; <= 1e-6 absolute."""
    import jax

    from oddio_tpu.ops.ring_read_triton import ring_read_triton
    from oddio_tpu.spatial import _ring_read

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_ring_read_triton import ring_read_operands

    V, n = 4096, 512
    args = list(ring_read_operands(V, n, cap=16384, rowlen=16384 + 3072))
    args[5] = [g / V for g in args[5]]
    args[6] = [g / V for g in args[6]]
    want = np.asarray(jax.jit(_ring_read, static_argnums=(7, 8))(*args))
    got = np.asarray(jax.jit(ring_read_triton, static_argnums=(7, 8))(*args))
    diff = float(np.abs(got - want).max())
    log(f"[ring_read] V={V} n={n}: max|triton - plain| = {diff:.3e}, "
        f"peak {float(np.abs(want).max()):.4f}")
    if not diff <= 1e-6:
        raise AssertionError(f"ring read kernel: {diff} > 1e-6")


# --- four GPUs ----------------------------------------------------------------


def _mixed_scene():
    """One SpatialScene with 4096 buffered and 4096 seek voices."""
    sys.path.insert(0, ROOT)
    import __graft_entry__ as g

    return g._build_scene(n_buffered=4096, n_seek=4096, rate=RATE,
                          capacity=4096)[1]


def phase_four():
    """ScenePack on four GPUs vs a one-device render of the same scenes on
    GPU 0: 64 config-5 scenes on a (4, 1) scene-parallel mesh, and the
    4096-voice buffered + seek scene on a (1, 4) voice-sharded mesh (psum
    mix reduction)."""
    import jax

    from oddio_tpu.parallel.mesh import make_mesh
    from oddio_tpu.parallel.sharded import ScenePack

    b = _bench()
    gpu0 = jax.devices()[:1]

    def config5(mesh):
        return b._build_pack(64, np.random.default_rng(5), mesh=mesh)

    def mixed(mesh):
        return ScenePack([_mixed_scene()], RATE, mesh)

    for name, build, shape in (("config5_64_scenes", config5, (4, 1)),
                               ("buffered_seek_4096", mixed, (1, 4))):
        outs = []
        for mesh in (make_mesh(*shape), make_mesh(1, 1, devices=gpu0)):
            t0 = time.time()
            pack = build(mesh)
            blocks = pack.render_frames_device(BLOCK * CMP_BLOCKS)
            outs.append(np.concatenate([np.asarray(x) for x in blocks]))
            log(f"[four] {name} on mesh {dict(mesh.shape)}: "
                f"{time.time() - t0:.1f} s incl. compile")
        peak = float(np.abs(outs[1]).max())
        diff = float(np.abs(outs[0] - outs[1]).max())
        tol = 1e-5 * max(1.0, peak)
        log(f"[four] {name}: mesh {shape} vs one device: max|diff| = "
            f"{diff:.3e} (tol {tol:.1e}), peak {peak:.4f}")
        if not (np.isfinite(outs[0]).all() and peak > 0 and diff <= tol):
            raise AssertionError(f"four {name}: diff {diff} > {tol}")


# --- main ----------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU ScenePack mesh phase")
    args = ap.parse_args(argv)
    t0 = time.time()
    import oddio_tpu  # noqa: F401  (fail before touching the device)

    devs = phase_device(4 if args.four else 1)
    if args.four:
        phase_four()
    else:
        phase_golden()
        phase_ring_read()
        phase_full_width()
    log(f"[done] {time.time() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)


if __name__ == "__main__":
    main()
