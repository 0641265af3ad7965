"""Real-time spatial scene with live motion — mirrors the reference's
examples/realtime.rs: a source orbiting the listener, motion updated from
the control thread each tick, audio pulled by the callback side."""

import time

import numpy as np

import oddio_tpu as ot
from oddio_tpu.control.realtime import RealtimeDriver

RATE = 48000


def main():
    scene_handle, scene = ot.SpatialScene.new()
    driver = RealtimeDriver(scene, RATE, block_size=512).start()

    handle = scene_handle.play_buffered(
        ot.Sine(0.0, 440.0),
        ot.SpatialOptions(position=[5.0, 0.0, 0.0]),
        max_distance=30.0,
        rate=RATE,
        buffer_duration=0.1,
    )

    # warm up: wait for the render thread to finish its first compiles and
    # start producing audio (first jit of each step variant is slow)
    handle.set_motion([5.0, 0.0, 0.0], [0.0, 0.0, 0.0], False)
    for _ in range(1200):
        if np.abs(driver.read(512)).max() > 0:
            break
        time.sleep(0.05)
    driver.underruns = 0

    # orbit at 1 rev / 2 s, radius 5 m; motion is paced by *rendered* time so
    # the demo is correct on any machine (on a GPU the loop runs in realtime;
    # on a slow CPU it renders slower than wall clock)
    frames = []
    rendered = 0.0
    while rendered < 1.5:
        ang = rendered * np.pi
        pos = [5 * np.cos(ang), 0.0, -5 * np.sin(ang)]
        vel = [-5 * np.pi * np.sin(ang), 0.0, -5 * np.pi * np.cos(ang)]
        handle.set_motion(pos, vel, False)
        while driver._ring.readable() < 512 * 2:
            time.sleep(0.002)
        frames.append(driver.read(512))
        rendered += 512 / RATE
    driver.stop()
    scene.sync()
    out = np.concatenate(frames)
    n3 = len(out) // 3
    for i, name in enumerate(("start", "mid", "end")):
        seg = out[i * n3 : (i + 1) * n3]
        l, rr = np.sqrt((seg**2).mean(axis=0))
        print(f"{name}: L {l:.4f}  R {rr:.4f}")
    print(f"underruns: {driver.underruns}, finished: {handle.is_finished()}")


if __name__ == "__main__":
    main()
