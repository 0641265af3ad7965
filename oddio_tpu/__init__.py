"""oddio_tpu — a batch audio rendering engine in JAX.

A from-scratch rebuild of the capabilities of Ralith/oddio (a real-time,
sans-I/O game-audio library, see SURVEY.md) as dense batch computation
on an accelerator via JAX/XLA:

* signal chains compile to fused XLA kernels over fixed-size frame blocks;
* the dynamic voice set becomes masked, vmapped voice pools reduced in a
  single mix kernel;
* the lock-free spsc/swap/atomic control plane becomes host-written per-block
  parameter arrays with oddio's handle API (`play`, `stop`, `set_gain`,
  `set_motion`, `seek`, ...);
* scenes scale across devices by sharding the voice/scene axes over a
  `jax.sharding.Mesh`.

Public surface mirrors oddio's re-exports (reference lib.rs:65-82).
"""

from .core.signal import Signal, ControlBlock
from .core.frames import Frames, FramesSignal, FramesSignalControl
from .core.smooth import Smoothed, interpolate
from .core.run import Renderer, run
from .ops.constant import Constant
from .ops.sine import Sine
from .ops.cycle import Cycle
from .ops.gain import FixedGain, Gain, GainControl
from .ops.speed import Speed, SpeedControl
from .ops.channels import MonoToStereo, Downmix
from .ops.limit import Reinhard, Tanh
from .ops.stream import Stream, StreamControl
from .ops.adapt import Adapt, AdaptOptions
from .ops.fader import Fader, FaderControl
from .mixer import Mixer, MixerControl, Mixed
from .spatial import (
    SpatialScene,
    SpatialSceneControl,
    Spatial,
    SpatialOptions,
    SPEED_OF_SOUND,
    HEAD_RADIUS,
)
from .control.realtime import RealtimeDriver
from .utils.wav import read_wav, write_wav
from .utils.profiler import XrtMeter

#: Unitless instantaneous sound wave amplitude measurement (lib.rs:85)
Sample = float


def frame_stereo(xs):
    """View interleaved stereo data as (n, 2) frames (lib.rs:98-104)."""
    import numpy as _np

    return _np.asarray(xs).reshape(-1, 2)


def flatten_stereo(xs):
    """View (n, 2) stereo frames as interleaved samples (lib.rs:103-104)."""
    import numpy as _np

    return _np.asarray(xs).reshape(-1)

__all__ = [
    "Signal",
    "ControlBlock",
    "Frames",
    "FramesSignal",
    "FramesSignalControl",
    "Smoothed",
    "interpolate",
    "Renderer",
    "run",
    "Constant",
    "Sine",
    "Cycle",
    "FixedGain",
    "Gain",
    "GainControl",
    "Speed",
    "SpeedControl",
    "MonoToStereo",
    "Downmix",
    "Reinhard",
    "Tanh",
    "Stream",
    "StreamControl",
    "Adapt",
    "AdaptOptions",
    "Fader",
    "FaderControl",
    "Mixer",
    "MixerControl",
    "Mixed",
    "SpatialScene",
    "SpatialSceneControl",
    "Spatial",
    "SpatialOptions",
    "SPEED_OF_SOUND",
    "HEAD_RADIUS",
    "RealtimeDriver",
    "read_wav",
    "write_wav",
    "XrtMeter",
    "Sample",
    "frame_stereo",
    "flatten_stereo",
]
