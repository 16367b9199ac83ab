"""Frozen configuration dataclasses.

These mirror the Unity-inspector configuration surface of the reference 1:1
(fields, defaults and valid ranges of ``RayTraceManager`` at
``Assets/Script/RayTraceManager.cs:8-34``, ``AudioManager.chunkDuration`` at
``Assets/Script/AudioManager.cs:5`` and ``AudioMaterial`` at
``Assets/Script/AudioMaterial.cs:6-20``), re-expressed as plain frozen
dataclasses that can be loaded from / dumped to JSON.

Anything that affects traced/compiled shapes (ray count, bounce count, IR
length, band count) is deliberately kept here as static Python ints so a
config maps to exactly one XLA compilation.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional


def _check_range(name: str, value, lo, hi) -> None:
    if not (lo <= value <= hi):
        raise ValueError(f"{name}={value!r} outside valid range [{lo}, {hi}]")


@dataclass(frozen=True)
class SimConfig:
    """Trace-loop configuration (reference: RayTraceManager.cs:12-16,26-28)."""

    ray_count: int = 1000          # Range(10, 100000), RayTraceManager.cs:13
    max_bounces: int = 5           # Range(1, 10), RayTraceManager.cs:14
    speed_of_sound: float = 343.0  # RayTraceManager.cs:15
    dynamic_obstacles: bool = False  # RayTraceManager.cs:16
    listener_radius: float = 0.5   # Range(0.1, 5), RayTraceManager.cs:28
    input_gain: float = 1.0        # Range(0.1, 10), RayTraceManager.cs:22
    n_bands: int = 1               # 1 = scalar energy (current kernel);
                                   # >1 = frequency-banded IR (legacy
                                   # RaytraceOcclusion2D.compute:234-252,
                                   # generalized to per-material band absorption)

    def __post_init__(self) -> None:
        _check_range("ray_count", self.ray_count, 10, 1_000_000)
        _check_range("max_bounces", self.max_bounces, 1, 64)
        _check_range("listener_radius", self.listener_radius, 1e-3, 1e3)
        if self.n_bands < 1:
            raise ValueError("n_bands must be >= 1")


@dataclass(frozen=True)
class AudioConfig:
    """Audio/IR configuration (reference: RayTraceManager.cs:18-24,
    AudioManager.cs:5)."""

    sample_rate: int = 48000        # RayTraceManager.cs:21
    reverb_duration: float = 2.0    # Range(0.1, 5), RayTraceManager.cs:23
    loop: bool = True               # RayTraceManager.cs:24
    chunk_duration: float = 0.1     # Range(0.05, 1), AudioManager.cs:5

    def __post_init__(self) -> None:
        _check_range("sample_rate", self.sample_rate, 1000, 384000)
        _check_range("reverb_duration", self.reverb_duration, 0.01, 60.0)
        _check_range("chunk_duration", self.chunk_duration, 0.001, 10.0)

    @property
    def ir_length(self) -> int:
        """IR sample count (reference: ``(int)(sampleRate * reverbDuration)``,
        RayTraceManager.cs:181)."""
        return int(self.sample_rate * self.reverb_duration)

    @property
    def chunk_samples(self) -> int:
        """Streaming chunk length (reference: RayTraceManager.cs:129)."""
        return int(round(self.sample_rate * self.chunk_duration))


@dataclass(frozen=True)
class DebugConfig:
    """Debug/visualization knobs (reference: RayTraceManager.cs:31-34)."""

    show_debug_texture: bool = True
    debug_ray_count: int = 100      # Range(5, 100)
    waveform_gain: float = 1000.0   # Range(1, 10000)
    tex_width: int = 1024           # RayTraceManager.cs:187
    tex_height: int = 256


@dataclass(frozen=True)
class EngineConfig:
    """Top-level bundle: everything an Engine needs besides the scene."""

    sim: SimConfig = SimConfig()
    audio: AudioConfig = AudioConfig()
    debug: DebugConfig = DebugConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "EngineConfig":
        raw: Dict[str, Any] = json.loads(text)
        return EngineConfig(
            sim=SimConfig(**raw.get("sim", {})),
            audio=AudioConfig(**raw.get("audio", {})),
            debug=DebugConfig(**raw.get("debug", {})),
        )

    @staticmethod
    def load(path: str) -> "EngineConfig":
        with open(path) as f:
            return EngineConfig.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def smoll_room_config(n_bands: int = 1,
                      ray_count: Optional[int] = None) -> EngineConfig:
    """The exact shipped configuration of the SmollRoom scene
    (``Assets/Scenes/SmollRoom.unity:154-168,997``)."""
    return EngineConfig(
        sim=SimConfig(
            ray_count=15000 if ray_count is None else ray_count,
            max_bounces=5,
            speed_of_sound=343.0,
            dynamic_obstacles=True,
            listener_radius=0.5,
            input_gain=1.0,
            n_bands=n_bands,
        ),
        audio=AudioConfig(sample_rate=48000, reverb_duration=1.5, loop=True,
                          chunk_duration=0.1),
    )


def big_room_config(n_bands: int = 1,
                    ray_count: Optional[int] = None) -> EngineConfig:
    """Big Room shipped config — identical to SmollRoom except
    ``inputGain: 100`` offsets the 10x-scaled inverse-square losses
    (``Assets/Scenes/Big Room.unity:161``)."""
    cfg = smoll_room_config(n_bands=n_bands, ray_count=ray_count)
    return dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim,
                                                            input_gain=100.0))


def sample_scene_config(n_bands: int = 1,
                        ray_count: Optional[int] = None) -> EngineConfig:
    """SampleScene shipped config (``Assets/Scenes/SampleScene.unity:
    156-168``): sampleRate 44100, reverbDuration 2; fields the stale scene
    does not serialize (inputGain, chunkDuration, loop) take the manager's
    C# defaults (``RayTraceManager.cs:22-24``, ``AudioManager.cs:5``)."""
    cfg = smoll_room_config(n_bands=n_bands, ray_count=ray_count)
    return dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, sample_rate=44100,
                                       reverb_duration=2.0))
