"""Audio file I/O and synthetic test clips (numpy only).

Copied from ``realisticaudioraytracing2d_tpu/utils/audio_io.py``. WAV
(PCM) read/write is stdlib-only (wave + numpy); mp3, the format the
reference ships its dry clips in, goes through the port's native runtime
(``native.decode_mp3`` / ``encode_mp3``: the system libmpg123 /
libmp3lame, opened at run time). :func:`read_audio` / :func:`write_audio`
dispatch on the file extension. :func:`builtin_clip_path` is the port's
own copy of the bundled dry clip (``assets/dry_clip.wav``), the default
``--in`` of the CLI.

Plus generators for synthetic dry clips used by tests and the chip smoke.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file. Returns ``(samples[N] or [N, C] float32 in
    [-1, 1], sample_rate)``."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # could be PCM32 or float32; wave module only does PCM — treat as i4
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch)
    return x, rate


def write_wav(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write float32 audio ([-1, 1], shape [N] or [N, C]) as PCM16 WAV."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(x, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(x.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Read an audio file: ``.mp3`` through the native system-codec
    binding, anything else as WAV. Returns ``(samples[N] or [N, C]
    float32, sample_rate)``."""
    if path.lower().endswith(".mp3"):
        from .. import native
        return native.decode_mp3(path)
    return read_wav(path)


def write_audio(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write float32 audio ([-1, 1], shape [N] or [N, C]): ``.mp3``
    through the native system-codec binding (192 kbps), anything else as
    PCM16 WAV."""
    if path.lower().endswith(".mp3"):
        from .. import native
        native.encode_mp3(path, np.asarray(x, np.float32), sample_rate)
        return
    write_wav(path, x, sample_rate)


def sine_clip(freq: float, duration: float, sample_rate: int,
              amplitude: float = 0.5) -> np.ndarray:
    t = np.arange(int(duration * sample_rate)) / sample_rate
    return (amplitude * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def click_clip(duration: float, sample_rate: int,
               click_times=(0.05,)) -> np.ndarray:
    """Dirac-ish clicks — ideal for verifying IR delays audibly/numerically."""
    x = np.zeros(int(duration * sample_rate), np.float32)
    for t in click_times:
        i = int(t * sample_rate)
        if 0 <= i < len(x):
            x[i] = 1.0
    return x


def noise_burst(duration: float, sample_rate: int, seed: int = 0,
                amplitude: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(duration * sample_rate)
    env = np.minimum(1.0, np.arange(n) / max(1, n * 0.05))
    env *= np.minimum(1.0, (n - np.arange(n)) / max(1, n * 0.05))
    return (amplitude * env *
            rng.standard_normal(n).astype(np.float32)).astype(np.float32)


def builtin_clip_path() -> str:
    """Path to the bundled 1 s / 48 kHz dry test clip (two clicks + a
    plucked arpeggio), the port's copy of the JAX package's. An
    uncompressed WAV, so ``bake``/``stream``/``live`` work on any host,
    codec or not."""
    import os
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets", "dry_clip.wav")


def load_builtin_clip() -> Tuple[np.ndarray, int]:
    """The bundled clip's samples and sample rate."""
    return read_wav(builtin_clip_path())
