"""Decide the DR ring read on the GPU: the plain XLA read
(``spatial._ring_read``) against the Triton kernel
(``ops/ring_read_triton.py``).

    python tools/ring_read_ab.py [--trials 3] [--out chiprun_out/ring_read_ab]

1. Kernel check at V = 4096, n = 512: both reads on the same operands
   (frozen voices, ring wrap), max|diff|, and each read's time alone.
2. End to end: the 4096-voice buffered bench scene rendered in 1504-block
   dispatches, alternating plain, kernel, kernel, plain; xRT per trial.
3. One short profiler trace of each read's idle scan; the device kernels
   by total time (and the ring-sized MemcpyD2D of the plain read) go to
   stdout and result.json; the traces themselves are deleted.

Needs an NVIDIA GPU.  Prints the card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def log(msg):
    print(msg, flush=True)


def time_call(fn, args, reps=50):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def kernel_check():
    import jax
    import jax.numpy as jnp

    from oddio_tpu.ops.ring_read_triton import ring_read_triton
    from oddio_tpu.spatial import _ring_read
    from test_ring_read_triton import ring_read_operands

    V, n = 4096, 512
    args = list(ring_read_operands(V, n, cap=16384, rowlen=16384 + 3072,
                                   seed=1))
    # realistic gains: distance attenuation keeps the 4096-voice mix O(1)
    args[5] = [g / V for g in args[5]]
    args[6] = [g / V for g in args[6]]
    plain = jax.jit(_ring_read, static_argnums=(7, 8))
    tri = jax.jit(ring_read_triton, static_argnums=(7, 8))
    a = np.asarray(plain(*args))
    b = np.asarray(tri(*args))
    diff = float(np.abs(a - b).max())
    tp = time_call(plain, args)
    tk = time_call(tri, args)
    log(f"[kernel] V={V} n={n}: max|triton - plain| = {diff:.3e}, "
        f"peak {float(np.abs(a).max()):.4f}; plain {tp * 1e6:.1f} us, "
        f"triton {tk * 1e6:.1f} us per call")
    return {"diff": diff, "plain_us": tp * 1e6, "triton_us": tk * 1e6}


def scene_trials(mode, trials, trace_dir=None):
    import jax
    import jax.numpy as jnp

    import bench
    import oddio_tpu as ot
    import oddio_tpu.spatial as sp
    from oddio_tpu.ops.ring_read_triton import ring_read_triton

    reader = sp._ring_reader
    impl = {"plain": sp._ring_read, "kernel": ring_read_triton}[mode]
    sp._ring_reader = lambda: impl
    try:
        _, scene, _ = bench.build_spatial(True)
        r = ot.Renderer(scene, bench.RATE, scan_buckets=bench.BUCKETS)
        t0 = time.time()
        r.render_frames(bench.BLOCK * 8)
        for _ in range(2):
            blocks = r.render_frames_device(bench.BLOCK * bench.VCHUNK)
        jax.block_until_ready(blocks)
        warm = time.time() - t0
        audio = bench.VCHUNK * bench.BLOCK / bench.RATE
        out = []
        for _ in range(trials):
            t0 = time.perf_counter()
            blocks = r.render_frames_device(bench.BLOCK * bench.VCHUNK,
                                            sync=False)
            jax.block_until_ready(blocks)
            out.append(audio / (time.perf_counter() - t0))
        digest = float(jnp.sum(blocks[-1][-1] ** 2))
        assert np.isfinite(digest) and digest > 0
        log(f"[scene] {mode}: warmup incl. compile {warm:.1f} s; xRT "
            + ", ".join(f"{x:.2f}" for x in out))
        if trace_dir:
            jax.profiler.start_trace(trace_dir)
            blocks = r.render_frames_device(bench.BLOCK * bench.CHUNK)
            jax.block_until_ready(blocks)
            jax.profiler.stop_trace()
        return out
    finally:
        sp._ring_reader = reader


def summarize_trace(trace_dir, top=12):
    """Device kernel time by name over the traced dispatch; deletes the
    trace."""
    import glob
    import shutil

    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        log("[trace] no xplane file")
        return
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    shutil.rmtree(trace_dir)
    tot = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0.0) + ev.duration_ns
    busy = sum(tot.values())
    log(f"[trace] device kernels over one 47-block dispatch: "
        f"{busy / 1e6:.3f} ms summed")
    for name, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[trace]   {ns / 1e6:9.3f} ms  {name[:110]}")
    copies = {k: v for k, v in tot.items()
              if "copy" in k.lower() or "memcpy" in k.lower()}
    log(f"[trace] copy kernels: {len(copies)}, "
        f"{sum(copies.values()) / 1e6:.3f} ms")
    return {"busy_ms": busy / 1e6, "copy_ms": sum(copies.values()) / 1e6,
            "top": {k: v / 1e6 for k, v in
                    sorted(tot.items(), key=lambda kv: -kv[1])[:top]}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "ring_read_ab"))
    args = ap.parse_args()
    import jax

    from oddio_tpu.utils.cache import use_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs an NVIDIA GPU; found {dev.platform}")
    use_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(f"[device] {dev.device_kind}; nvidia-smi: {smi}")
    res = {"card": smi, "kernel": kernel_check()}
    os.makedirs(args.out, exist_ok=True)
    res["trials"] = {"plain": [], "kernel": []}
    for i, mode in enumerate(("plain", "kernel", "kernel", "plain")):
        trace = os.path.join(args.out, f"trace_{mode}") if i < 2 else None
        res["trials"][mode] += scene_trials(mode, args.trials, trace)
        if trace:
            res[f"trace_{mode}"] = summarize_trace(trace)
    for mode, xs in res["trials"].items():
        log(f"[scene] {mode}: median xRT {np.median(xs):.2f} over {len(xs)}")
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
