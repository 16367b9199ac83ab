"""PyTorch/CUDA port of ``realisticaudioraytracing2d_tpu``.

The JAX package is the reference; this package has its module names and
runs the reference app's main loop (scene -> Monte-Carlo trace into an
IR -> crossfaded chunked convolution) with PyTorch on the CPU or on an
NVIDIA H100, where the trace runs in a hand-written CUDA kernel
(``csrc/bounce_kernel.cu``), or, for scenes past 5,280 walls, in the
hand-written cluster kernels (``csrc/accel_kernel.cu``). It also sweeps
room datasets and mixes down many sources through the bounce kernel's
batched mode (:mod:`.parallel`), and hands out individual hit records
(debug ray paths, the legacy time x frequency IR) through the wall-sweep
kernels (``csrc/trace_kernel.cu``) and the bounce kernel's hit-row mode
(``csrc/bounce_kernel.cu``). Every path takes directive sources and
microphones (:mod:`.ops.directivity`); the stream and the CLI add edge
diffraction (:mod:`.ops.diffraction`) and air absorption
(:mod:`.ops.air`). :mod:`.spatial` traces spatial (W/X/Y) IRs through
the same kernels and decodes them to two ears, which the stream does
per chunk in binaural mode; :mod:`.analysis` computes the ISO 3382 room
parameters of an IR. :mod:`.diff` fits wall materials and locates a
source from a target IR by autograd through the plain trace (the hand
kernels have no backward). :class:`.live.LivePlayer` plays the stream's
chunks through a producer thread and an audio thread around the native
host ring (:mod:`.native`: the ring, mp3 codecs, the ALSA sink, built
with g++ at first use), steered while it plays by
:class:`.posefeed.PoseFeed`.
It imports no JAX.

Every builder takes ``device=None``, which means :data:`DEFAULT_DEVICE`
(``"cuda"``); pass ``device="cpu"`` for the plain PyTorch path.

Quick start::

    import torch
    import realisticaudioraytracing2d_tpu_torch as art
    room = art.rooms.smoll_room()                     # on the card
    eng = art.Engine(room.scene, art.smoll_room_config())
    params = eng.params(room.source, room.listener)
    ir_state = eng.trace_frames(params, seed=0, n_frames=8)
    wet = eng.bake(torch.as_tensor(dry_audio, device="cuda"), ir_state)
"""

from . import (analysis, config, diff, live, native, parallel, posefeed,
               spatial, utils)
from .config import (AudioConfig, DebugConfig, EngineConfig, SimConfig,
                     big_room_config, sample_scene_config,
                     smoll_room_config)
from .device import DEFAULT_DEVICE
from .engine import Engine, bake_audio, trace_accumulate
from .live import LivePlayer, LiveReport
from .models import materials, rooms, scene
from .models.materials import (MATERIAL_ANECHOIC, MATERIAL_BORDER,
                               MATERIAL_INTERIOR, AudioMaterial)
from .models.scene import Scene, SceneBuilder, Transform2D
from .ops import air, convolve, diffraction, directivity, geometry, ir, trace
from .ops.ir import IRState
from .ops.trace import DebugPaths, Hits, TraceParams
from .posefeed import PoseFeed, PoseFeedError
from .streaming import (RingBuffer, Streamer, StreamState, stream_chunk,
                        wet_chunk)

__version__ = "0.1.0"

__all__ = [
    "AudioConfig", "AudioMaterial", "DEFAULT_DEVICE", "DebugConfig",
    "DebugPaths", "Engine", "EngineConfig", "Hits", "IRState", "LivePlayer", "LiveReport",
    "MATERIAL_ANECHOIC", "MATERIAL_BORDER", "MATERIAL_INTERIOR",
    "PoseFeed", "PoseFeedError", "RingBuffer", "Scene",
    "SceneBuilder", "SimConfig", "StreamState", "Streamer", "TraceParams",
    "Transform2D", "air", "analysis", "bake_audio", "big_room_config", "config",
    "convolve", "diff", "diffraction", "directivity", "geometry", "ir", "live",
    "materials", "native", "parallel", "posefeed", "rooms",
    "sample_scene_config", "scene", "smoll_room_config", "spatial",
    "stream_chunk", "trace", "trace_accumulate", "wet_chunk",
    "utils",
]
