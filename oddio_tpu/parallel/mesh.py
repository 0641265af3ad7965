"""Device-mesh helpers for scaling audio scenes across devices.

The reference has no distributed backend at all (SURVEY.md §2: its only
concurrency is the two-thread wait-free control plane).  The batch
equivalents are:

* **scene axis** — independent scenes are embarrassingly parallel: pure data
  parallelism, no collectives.
* **voice axis** — one giant scene's voices shard across devices; the mix
  reduction becomes a single ``psum`` over the voice mesh axis.
"""

from __future__ import annotations

import jax
import numpy as np

__all__ = ["make_mesh", "SCENE_AXIS", "VOICE_AXIS"]

SCENE_AXIS = "scene"
VOICE_AXIS = "voice"


def make_mesh(scene=1, voice=1, devices=None):
    """Build a (scene, voice) mesh over ``devices`` (default: all)."""
    devices = jax.devices() if devices is None else devices
    need = scene * voice
    if need > len(devices):
        raise ValueError(f"mesh {scene}x{voice} needs {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(scene, voice)
    return jax.sharding.Mesh(arr, (SCENE_AXIS, VOICE_AXIS))
