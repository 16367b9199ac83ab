"""ctypes bindings for the native host runtime (``artnative.cpp``,
``mp3dec.cpp``, ``audiosink.cpp``).

The port's own copy of ``realisticaudioraytracing2d_tpu/native``: the
same C++ sources (framework-free, copied byte for byte) and the same
bindings. The library is compiled with ``g++`` at first use into
``<repository>/build/torch_native/libartnative_<hash>.so``, the hash over
the sources, the flags and the host's CPU (``-march=native`` builds for
the CPU at hand, so a checkout moved to another machine builds its own),
so an edited source rebuilds and an unchanged one is loaded as it is (as
``ops/cuda/build.py`` does for the CUDA kernels). A file lock serialises
concurrent builders, and the library is moved into place atomically.
Every entry point has a NumPy fallback for a host without a toolchain;
``available()`` reports which path is active.
The mp3 codec entry points also need the system codecs (libmpg123 /
libmp3lame, opened at run time): ``mp3_probe()`` reports what resolved;
the ALSA sink likewise needs libasound (``sink_probe()``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRCS = [_HERE / "artnative.cpp", _HERE / "mp3dec.cpp",
         _HERE / "audiosink.cpp"]
BUILD_DIR = _HERE.parents[1] / "build" / "torch_native"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_cpu() -> str:
    """The CPU the library is built for: the first processor's model and
    feature flags (Linux), else the machine name."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f.read().split("\n\n")[0].splitlines()
                     if ln.startswith(("model name", "flags"))]
    except OSError:
        lines = []
    return "\n".join(lines) or platform.machine()


def library_path() -> Path:
    """Where the library for the current sources, flags and CPU lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_host_cpu().encode())
    for src in _SRCS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libartnative_{h.hexdigest()[:16]}.so"


def _compile(lib: Path) -> bool:
    """Build ``lib`` unless it exists, under a file lock so that
    concurrent processes build it once. False if g++ fails or is
    missing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return True
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, *map(str, _SRCS), "-o", tmp,
                            "-ldl"], check=True, capture_output=True,
                           timeout=300)
            os.replace(tmp, lib)
            return True
        except (OSError, subprocess.SubprocessError):
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not _compile(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.art_flatten_boxes.restype = ctypes.c_int
        lib.art_flatten_boxes.argtypes = [f32p, ctypes.c_int, f32p]
        lib.art_flatten_loop.restype = ctypes.c_int
        lib.art_flatten_loop.argtypes = [f32p, ctypes.c_int, f32p, f32p]
        lib.art_morton_clusters.restype = ctypes.c_int
        lib.art_morton_clusters.argtypes = [f32p, ctypes.c_int,
                                            ctypes.c_int, i32p, f32p]
        lib.art_ring_create.restype = ctypes.c_void_p
        lib.art_ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.art_ring_destroy.restype = None
        lib.art_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.art_ring_push.restype = None
        lib.art_ring_push.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int,
                                      ctypes.c_int64]
        lib.art_ring_drain.restype = None
        lib.art_ring_drain.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int]
        lib.art_ring_read_head.restype = ctypes.c_int64
        lib.art_ring_read_head.argtypes = [ctypes.c_void_p]
        lib.art_mp3_probe.restype = ctypes.c_int
        lib.art_mp3_probe.argtypes = []
        lib.art_mp3_decode.restype = ctypes.c_void_p
        lib.art_mp3_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
        lib.art_mp3_copy.restype = None
        lib.art_mp3_copy.argtypes = [ctypes.c_void_p, f32p]
        lib.art_mp3_free.restype = None
        lib.art_mp3_free.argtypes = [ctypes.c_void_p]
        lib.art_mp3_encode.restype = ctypes.c_int
        lib.art_mp3_encode.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.art_sink_probe.restype = ctypes.c_int
        lib.art_sink_probe.argtypes = []
        lib.art_sink_error.restype = ctypes.c_char_p
        lib.art_sink_error.argtypes = []
        lib.art_sink_open.restype = ctypes.c_void_p
        lib.art_sink_open.argtypes = [ctypes.c_char_p, ctypes.c_uint,
                                      ctypes.c_uint, ctypes.c_uint]
        lib.art_sink_write.restype = ctypes.c_long
        lib.art_sink_write.argtypes = [ctypes.c_void_p, f32p,
                                       ctypes.c_long, ctypes.c_int]
        lib.art_sink_close.restype = None
        lib.art_sink_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the compiled library is in use (else the NumPy
    fallbacks)."""
    return _load() is not None


def _f32(a: np.ndarray) -> "ctypes.pointer":
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32(a: np.ndarray) -> "ctypes.pointer":
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def flatten_boxes(boxes: np.ndarray) -> np.ndarray:
    """Flatten boxes [(x, y, angle, sx, sy, w, h, ox, oy)] x N into edge
    soup [N*4, 6] = (ax, ay, bx, by, nx, ny). Native fast path, NumPy
    fallback (same math as SceneBuilder.add_box)."""
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 9)
    n = boxes.shape[0]
    lib = _load()
    out = np.empty((n * 4, 6), np.float32)
    if lib is not None:
        wrote = lib.art_flatten_boxes(_f32(boxes), n, _f32(out))
        return out[:wrote]
    cx = np.array([-0.5, 0.5, 0.5, -0.5], np.float32)
    cy = np.array([-0.5, -0.5, 0.5, 0.5], np.float32)
    px, py, ang, sx, sy, w, h, ox, oy = boxes.T
    c, s = np.cos(ang), np.sin(ang)
    lx = (cx[None] * w[:, None] + ox[:, None]) * sx[:, None]   # [n,4]
    ly = (cy[None] * h[:, None] + oy[:, None]) * sy[:, None]
    wx = c[:, None] * lx - s[:, None] * ly + px[:, None]
    wy = s[:, None] * lx + c[:, None] * ly + py[:, None]
    winding = np.sign(sx * sy)
    winding[winding == 0] = 1.0
    k2 = [1, 2, 3, 0]
    a = np.stack([wx, wy], -1)                                  # [n,4,2]
    b = a[:, k2]
    d = b - a
    ln = np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where(ln > 0, d / np.maximum(ln, 1e-30), 0.0)
    nrm = np.stack([d[..., 1], -d[..., 0]], -1) * winding[:, None, None]
    return np.concatenate([a, b, nrm], -1).reshape(n * 4, 6).astype(
        np.float32)


def flatten_loop(points: np.ndarray, transform: Tuple[float, ...]
                 ) -> np.ndarray:
    """Flatten one closed loop under (x, y, angle, sx, sy)."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 2)
    tf = np.asarray(transform, np.float32)
    n = pts.shape[0]
    lib = _load()
    if lib is not None:
        out = np.empty((n, 6), np.float32)
        lib.art_flatten_loop(_f32(pts), n, _f32(tf), _f32(out))
        return out
    px, py, ang, sx, sy = [float(v) for v in tf]
    c, s = np.cos(ang), np.sin(ang)
    lx = pts[:, 0] * sx
    ly = pts[:, 1] * sy
    wx = c * lx - s * ly + px
    wy = s * lx + c * ly + py
    a = np.stack([wx, wy], -1)
    b = np.roll(a, -1, axis=0)
    d = b - a
    ln = np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where(ln > 0, d / np.maximum(ln, 1e-30), 0.0)
    winding = 1.0 if sx * sy >= 0 else -1.0
    nrm = np.stack([d[:, 1], -d[:, 0]], -1) * winding
    return np.concatenate([a, b, nrm], -1).astype(np.float32)


def morton_clusters(segments: np.ndarray, cluster_size: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Sort walls by Morton code of their centroid and emit per-cluster
    AABBs over runs of ``cluster_size`` sorted walls. Degenerate padding
    segments sort last; padding-only clusters get an inverted AABB (never
    slab-hit). Returns ``(order[N] int32 permutation, aabb[n_clusters, 4]
    f32 (xmin, ymin, xmax, ymax))``."""
    segs = np.ascontiguousarray(segments, np.float32).reshape(-1, 6)
    n = segs.shape[0]
    n_clusters = -(-n // cluster_size)
    order = np.empty((n,), np.int32)
    aabb = np.empty((n_clusters, 4), np.float32)
    lib = _load()
    if lib is not None:
        got = lib.art_morton_clusters(_f32(segs), n, cluster_size,
                                      _i32(order), _f32(aabb))
        if got != n_clusters:
            raise RuntimeError(f"art_morton_clusters wrote {got} clusters, "
                               f"expected {n_clusters}")
        return order, aabb
    a, b = segs[:, 0:2], segs[:, 2:4]
    degen = np.all(a == b, axis=1)
    valid = ~degen
    lo = a[valid].min(0).astype(np.float64) if valid.any() else np.zeros(2)
    hi = a[valid].max(0).astype(np.float64) if valid.any() else np.ones(2)
    lo = np.minimum(lo, b[valid].min(0)) if valid.any() else lo
    hi = np.maximum(hi, b[valid].max(0)) if valid.any() else hi
    span = np.where(hi > lo, hi - lo, 1.0)
    cen = 0.5 * (a + b)
    q = ((cen - lo) / span * 65535.0).clip(0, 65535).astype(np.uint64)

    def part1by1(x):
        x &= np.uint64(0xFFFF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F)
        x = (x | (x << np.uint64(2))) & np.uint64(0x33333333)
        x = (x | (x << np.uint64(1))) & np.uint64(0x55555555)
        return x

    key = part1by1(q[:, 0]) | (part1by1(q[:, 1]) << np.uint64(1))
    key[degen] = np.uint64(0x1FFFFFFFF)
    order[:] = np.argsort(key, kind="stable").astype(np.int32)
    aabb[:, :2] = np.float32(1e30)
    aabb[:, 2:] = np.float32(-1e30)
    for c in range(n_clusters):
        ids = order[c * cluster_size:(c + 1) * cluster_size]
        ids = ids[~degen[ids]]
        if len(ids) == 0:
            continue
        pts = np.concatenate([a[ids], b[ids]], axis=0)
        aabb[c, :2] = pts.min(0)
        aabb[c, 2:] = pts.max(0)
    return order, aabb


class NativeRingBuffer:
    """Mutex-protected additive ring buffer ``[channels, size]`` usable
    from a real audio callback thread: the host twin of
    :class:`..streaming.RingBuffer` (the tensor version). Writes add,
    reads zero what they consume (``AudioManager.cs:45-69``). The ctypes
    calls release the interpreter lock while the C++ mutex is held."""

    def __init__(self, size: int, channels: int = 1):
        self.size = size
        self.channels = channels
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.art_ring_create(channels, size)
        else:
            self._h = None
            self._data = np.zeros((channels, size), np.float32)
            self._head = 0
            self._pylock = threading.Lock()

    def push(self, samples: np.ndarray, offset: int) -> None:
        """Overlap-add ``samples`` (``[N]`` or ``[channels, N]``) at the
        absolute sample ``offset`` (wrapped mod size)."""
        samples = np.ascontiguousarray(samples, np.float32)
        if samples.ndim == 1:
            samples = samples[None, :]
        if samples.shape[0] != self.channels:
            raise ValueError(f"ring has {self.channels} channels, samples "
                             f"have {samples.shape[0]}")
        n = samples.shape[-1]
        if self._h is not None:
            self._lib.art_ring_push(self._h, _f32(samples), n, offset)
            return
        with self._pylock:
            idx = (offset + np.arange(n)) % self.size
            np.add.at(self._data, (slice(None), idx), samples)

    def drain(self, n: int) -> np.ndarray:
        """Read and zero ``n`` samples per channel from the read head,
        then advance it: ``[channels, n]``."""
        out = np.empty((self.channels, n), np.float32)
        if self._h is not None:
            self._lib.art_ring_drain(self._h, _f32(out), n)
            return out
        with self._pylock:
            idx = (self._head + np.arange(n)) % self.size
            out[:] = self._data[:, idx]
            self._data[:, idx] = 0.0
            self._head = (self._head + n) % self.size
        return out

    @property
    def read_head(self) -> int:
        if self._h is not None:
            return int(self._lib.art_ring_read_head(self._h))
        return self._head

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.art_ring_destroy(self._h)
            self._h = None


def mp3_probe() -> Tuple[bool, bool]:
    """``(decode_available, encode_available)``: whether the system
    codecs (libmpg123 / libmp3lame) resolved at run time."""
    lib = _load()
    if lib is None:
        return False, False
    m = lib.art_mp3_probe()
    return bool(m & 1), bool(m & 2)


def decode_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decode an mp3 file to ``(samples[N] or [N, C] float32, rate)``
    through the system libmpg123 (the reference borrows its host's
    decoder too: Unity's importer decodes ``Assets/Script/*.mp3``).
    Raises ``RuntimeError`` when the codec is unavailable or the file
    does not decode."""
    lib = _load()
    if lib is None or not (lib.art_mp3_probe() & 1):
        raise RuntimeError(
            "mp3 decode unavailable: native runtime or libmpg123 missing")
    r = ctypes.c_int()
    ch = ctypes.c_int()
    fr = ctypes.c_longlong()
    h = lib.art_mp3_decode(str(path).encode(), ctypes.byref(r),
                           ctypes.byref(ch), ctypes.byref(fr))
    if not h:
        raise RuntimeError(f"mp3 decode failed: {path}")
    out = np.empty(fr.value * ch.value, np.float32)
    lib.art_mp3_copy(h, _f32(out))
    lib.art_mp3_free(h)
    x = out.reshape(fr.value, ch.value)
    return (x[:, 0] if ch.value == 1 else x), r.value


def encode_mp3(path: str, x: np.ndarray, sample_rate: int,
               kbps: int = 192) -> None:
    """Encode float32 audio ([-1, 1], shape [N] or [N, C<=2]) to an mp3
    file through the system libmp3lame. Raises ``RuntimeError`` when the
    encoder is unavailable."""
    lib = _load()
    if lib is None or not (lib.art_mp3_probe() & 2):
        raise RuntimeError(
            "mp3 encode unavailable: native runtime or libmp3lame missing")
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2 or x.shape[1] not in (1, 2):
        raise ValueError(f"mp3 encode wants [N] or [N, 1|2], got {x.shape}")
    xi = np.ascontiguousarray(x.reshape(-1))
    rc = lib.art_mp3_encode(str(path).encode(), _f32(xi), x.shape[0],
                            x.shape[1], sample_rate, kbps)
    if rc != 0:
        raise RuntimeError(f"mp3 encode failed ({rc}): {path}")


def sink_probe() -> Tuple[bool, str]:
    """``(available, reason)``: whether an OS audio sink can exist here,
    i.e. the native runtime compiled and libasound resolved at run time.
    A device may still fail to open (no sound card); that error comes
    from :class:`AudioSink` with the ALSA message."""
    lib = _load()
    if lib is None:
        return False, "native runtime unavailable (no g++?)"
    if not lib.art_sink_probe():
        return False, "libasound.so.2 not found (no ALSA runtime)"
    return True, "alsa"


class AudioSink:
    """Playback through the default (or named) ALSA PCM device: the last
    hop of the reference's audio path (Unity hands ``OnAudioFilterRead``'s
    buffer to the sound card, ``AudioManager.cs:56-69``); the live
    consumer thread hands each drained DSP buffer to :meth:`write`.

    Raises ``RuntimeError`` with the probe reason or the ALSA error when
    no sink can open; ``cli live --play`` exits with that message. Use as
    a context manager or call :meth:`close` (drains)."""

    def __init__(self, sample_rate: int, channels: int,
                 device: str = "default", latency_ms: float = 100.0):
        ok, reason = sink_probe()
        if not ok:
            raise RuntimeError(f"audio sink unavailable: {reason}")
        lib = _load()
        self._lib = lib
        self.channels = int(channels)
        self._pcm = lib.art_sink_open(device.encode(), int(sample_rate),
                                      int(channels),
                                      int(latency_ms * 1000))
        if not self._pcm:
            err = lib.art_sink_error()
            raise RuntimeError(
                "audio sink open failed: "
                f"{err.decode() if err else 'unknown alsa error'}")

    def write(self, block: np.ndarray) -> int:
        """Blocking play of ``block``: ``[N]`` mono or ``[C, N]``
        channel-major (the pipeline's layout; a mono block is copied to
        every device channel, as the reference does). Returns frames
        written."""
        x = np.asarray(block, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[0] != self.channels:
            if x.shape[0] == 1:
                x = np.broadcast_to(x, (self.channels, x.shape[1]))
            else:
                raise ValueError(f"sink has {self.channels} channels, "
                                 f"block has {x.shape[0]}")
        inter = np.ascontiguousarray(x.T.reshape(-1))     # interleave
        n = self._lib.art_sink_write(self._pcm, _f32(inter), x.shape[1],
                                     self.channels)
        if n < 0:
            err = self._lib.art_sink_error()
            raise RuntimeError(
                "audio sink write failed: "
                f"{err.decode() if err else 'unknown alsa error'}")
        return int(n)

    def close(self) -> None:
        if getattr(self, "_pcm", None):
            self._lib.art_sink_close(self._pcm)
            self._pcm = None

    def __enter__(self) -> "AudioSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
