"""Real-time streaming: chunked convolution with live IR updates (PyTorch,
plain and binaural modes).

Port of ``realisticaudioraytracing2d_tpu/streaming.py`` in its plain and
binaural modes (the reference's ``FixedUpdate`` chunk clock +
``ProcessChunk`` coroutine, ``Assets/Script/RayTraceManager.cs:64-123``,
and the ``AudioManager`` overlap-add ring,
``Assets/Script/AudioManager.cs:45-69``). Per chunk,
:func:`stream_chunk`:

1. traces ``frames_per_chunk`` Monte-Carlo frames into a fresh IR (on the
   card through the hand kernel, see ``engine.trace_accumulate``);
2. convolves the dry chunk against the previous chunk's IR and the new
   one (one input FFT) and crossfades between them;
3. overlap-adds the wet chunk with its reverb tail into the ring and
   drains exactly one chunk (add-then-zero).

The fresh chunk IR takes the JAX step's physics addenda before the
crossfade (:func:`_augment_ir`): edge diffraction (``ops/diffraction.py``,
its visibility sweeps through the kernel K2 on the card) and ISO 9613-1
air absorption (``ops/air.py``). Directive sources and microphones ride
in ``params``. Where the JAX step donates its state buffers, this one
updates the preallocated :class:`StreamState` in place.

In binaural mode (``binaural_facing``) the chunk traces the head's
three-microphone spatial capture (``spatial.binaural_trace_params``: K4
for a seed, K3 for host uniforms, K8/K7 past 5,280 walls), takes the
addenda on it, and decodes it to the two ears (``spatial.
binaural_decode_ir``) before the crossfade; the head's facing may turn
every chunk. Per-arrival and shared-rate Doppler raise
``NotImplementedError`` (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .config import EngineConfig
from .device import resolve
from .models.scene import Scene
from .ops import convolve as cv
from .ops import ir as irm
from .ops.rng import mix_seed
from .ops.trace import TraceParams


def _augment_ir(cur_ir: torch.Tensor, scene: Scene, params: TraceParams,
                sample_rate: int, diffraction, air_alpha,
                plain: bool = False) -> torch.Tensor:
    """The optional physics addenda on a freshly traced, normalized chunk
    IR (the JAX package's ``streaming.py::_augment_ir``): edge diffraction
    (``diffraction`` falsy, 1, or 2 = edge-to-edge double diffraction),
    then ISO 9613-1 air absorption (``air_alpha``: dB/m, per band or a
    number; None for none), which attenuates the diffracted paths too.
    The air curve multiplies by the float32 reciprocals of the sample
    rate and 10, as XLA computes the jitted JAX step with a static
    sample rate. ``plain`` runs diffraction's visibility sweeps as the
    plain version, not K2, on a CUDA scene (``backend="plain"``)."""
    if diffraction:
        from .ops.diffraction import diffraction_ir
        cur_ir = cur_ir + diffraction_ir(
            scene, params, sample_rate=sample_rate,
            ir_length=cur_ir.shape[-2], order=int(diffraction),
            use_kernels=False if plain else None)
    if air_alpha is not None:
        from .ops.air import apply_air_absorption
        cur_ir = apply_air_absorption(cur_ir, sample_rate, air_alpha,
                                      params.speed_of_sound, reciprocal=True)
    return cur_ir


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item}); the "
        "port streams in plain and binaural mode only")


class RingBuffer:
    """Additive ring buffer ``[L, S]`` (``AudioManager.cs:45-69``: writes
    add, reads zero what they consume). Updated in place."""

    def __init__(self, data: torch.Tensor, read_head: int = 0):
        self.data = data
        self.read_head = int(read_head)

    @staticmethod
    def zeros(size: int, n_listeners: int = 1, device=None) -> "RingBuffer":
        return RingBuffer(torch.zeros((n_listeners, size), dtype=torch.float32,
                                      device=resolve(device)))

    @property
    def size(self) -> int:
        return self.data.shape[-1]

    def _spans(self, start: int, n: int):
        """``[start, start + n)`` mod size as at most two contiguous
        ``(ring slice, source offset)`` pairs."""
        if n > self.size:
            raise ValueError(f"{n} samples exceed the ring size {self.size}")
        start %= self.size
        first = min(n, self.size - start)
        spans = [(slice(start, start + first), 0)]
        if first < n:
            spans.append((slice(0, n - first), first))
        return spans

    def push(self, samples: torch.Tensor, offset: int) -> "RingBuffer":
        """Overlap-add ``samples[L, N]`` at absolute sample ``offset``
        (wrapped mod size): ``PushSamples`` (``AudioManager.cs:45-54``)."""
        n = samples.shape[-1]
        for ring, src in self._spans(int(offset), n):
            self.data[:, ring] += samples[:, src:src + ring.stop - ring.start]
        return self

    def drain(self, n: int) -> torch.Tensor:
        """Read and zero ``n`` samples from the read head, then advance it:
        ``OnAudioFilterRead`` (``AudioManager.cs:56-69``)."""
        parts = []
        for ring, _ in self._spans(self.read_head, n):
            parts.append(self.data[:, ring].clone())
            self.data[:, ring] = 0.0
        self.read_head = (self.read_head + n) % self.size
        return torch.cat(parts, dim=-1)


@dataclass
class StreamState:
    """Carried state of the stream: the previous chunk's normalized IR, the
    ring (its read head is the stream position), the chunk counter and,
    for a binaural stream only, the head facing (radians, a 0-d float32
    tensor) the previous chunk was decoded with."""

    prev_ir: torch.Tensor   # [L, T, K]
    ring: RingBuffer
    chunk_index: int = 0
    prev_facing: Optional[torch.Tensor] = None


def init_stream(ir_length: int, chunk_samples: int, n_listeners: int = 1,
                n_bands: int = 1, binaural: bool = False,
                device=None) -> StreamState:
    """Ring sized to hold a chunk + its reverb tail with slack:
    ``ir_length + 2 * chunk_samples`` (the JAX package's rule);
    ``binaural`` allocates the facing carry."""
    device = resolve(device)
    return StreamState(
        prev_ir=torch.zeros((n_listeners, ir_length, n_bands),
                            dtype=torch.float32, device=device),
        ring=RingBuffer.zeros(ir_length + 2 * chunk_samples, n_listeners,
                              device),
        prev_facing=(torch.zeros((), dtype=torch.float32, device=device)
                     if binaural else None))


def _crossfaded_wet(chunk: torch.Tensor, ir_prev: torch.Tensor,
                    ir_cur: torch.Tensor) -> torch.Tensor:
    """Wet chunk ``[L, N+T]``: convolve against both IRs (one input FFT,
    two transfer functions) and crossfade prev->cur linearly across the
    chunk; the reverb tail uses the current IR only."""
    chunk = cv.gate_input(chunk)
    n = chunk.shape[-1]
    out_length = n + ir_prev.shape[-2]
    n_fft = cv._next_pow2(out_length)
    x = torch.fft.rfft(chunk, n_fft)
    h = torch.stack([cv.combined_transfer(ir_prev, n_fft),
                     cv.combined_transfer(ir_cur, n_fft)])     # [2, L, F]
    y = torch.fft.irfft(x * h, n_fft)[..., :out_length]         # [2, L, O]
    ramp = torch.clamp(cv._divide(torch.arange(out_length,
                                               dtype=torch.float32,
                                               device=chunk.device),
                                  float(max(1, n))), max=1.0)
    return y[0] * (1.0 - ramp) + y[1] * ramp


def stream_chunk(scene: Scene, params: TraceParams, state: StreamState,
                 dry_chunk: torch.Tensor, *, seed: int, n_rays: int,
                 max_bounces: int, sample_rate: int,
                 frames_per_chunk: int = 1, diffraction=False,
                 air_alpha=None, uniforms=None, backend: str = "auto",
                 binaural_facing=None, head_radius: float = 0.0875,
                 shadow: float = 0.6, decorrelate: bool = True
                 ) -> Tuple[torch.Tensor, StreamState]:
    """One streaming step: retrace -> physics addenda -> crossfaded
    convolution -> overlap-add -> drain. Returns ``(out_chunk[L, N],
    state)``; ``state`` is updated in place. Chunk ``i`` traces with seed
    ``mix_seed(seed, i)`` unless ``uniforms`` (``emit[F, R]``,
    ``u[F, B, R, 3]``) are given. ``diffraction`` (falsy, 1 or 2) and
    ``air_alpha`` (dB/m, or None) as in :func:`_augment_ir`.

    ``binaural_facing`` (radians, a number or a 0-d tensor) makes the
    step binaural: ``params`` carry ONE listener (the head) and ``state``
    TWO channels (the ears); the chunk traces the three-microphone
    capture ``[3, T, K]``, takes the addenda on it, and decodes it to
    ``[2, T, K]`` (:func:`..spatial.binaural_decode_ir` with
    ``head_radius``, ``shadow``, ``decorrelate`` and the traced
    ``params.speed_of_sound``) before the crossfade."""
    from . import spatial as spm
    from .engine import trace_accumulate
    n = dry_chunk.shape[-1]
    l, t, k = state.prev_ir.shape
    binaural = binaural_facing is not None

    # 1. retrace: a fresh IR for this chunk (RayTraceManager.cs:82-85)
    tp = spm.binaural_trace_params(params, l) if binaural else params
    ir_state = trace_accumulate(
        scene, tp, irm.IRState.zeros(t, tp.listeners.shape[0], k,
                                     device=scene.device),
        n_rays=n_rays, max_bounces=max_bounces, sample_rate=sample_rate,
        n_frames=frames_per_chunk, seed=mix_seed(seed, state.chunk_index),
        uniforms=uniforms, backend=backend)
    cur_ir = _augment_ir(ir_state.normalized(), scene, tp, sample_rate,
                         diffraction, air_alpha,
                         plain=backend == "plain")            # [L, T, K]
    if binaural:                                  # [3, T, K] -> [2, T, K]
        cur_ir = spm.binaural_decode_ir(
            cur_ir, sample_rate, binaural_facing, head_radius, shadow,
            params.speed_of_sound, decorrelate=decorrelate)

    # The first chunk has no predecessor: fade in from the current IR.
    prev_ir = cur_ir if state.chunk_index == 0 else state.prev_ir

    # 2. convolve + crossfade; 3. overlap-add at the stream position (the
    #    read head: both advance one chunk per step), drain one chunk
    wet = _crossfaded_wet(dry_chunk, prev_ir, cur_ir)          # [L, N+T]
    out = state.ring.push(wet, state.ring.read_head).drain(n)

    state.prev_ir.copy_(cur_ir)
    if binaural and state.prev_facing is not None:
        state.prev_facing.fill_(binaural_facing)
    state.chunk_index += 1
    return out, state


class Streamer:
    """Host-side driver of the streaming loop (the reference's
    ``StartStreaming``, ``RayTraceManager.cs:125-133``). Poses may change
    every chunk. ``seed`` names the random stream; ``uniforms_fn(i) ->
    (emit[F, R], u[F, B, R, 3])`` replaces chunk ``i``'s draws.
    ``diffraction`` (False, 1 or 2) and ``air_alpha`` add edge
    diffraction and air absorption to every chunk's IR. ``binaural``
    streams one head listener to two ear channels (``n_listeners`` is 2
    then), decoded with ``head_radius``, ``shadow`` and ``decorrelate``
    at the facing :meth:`process` is given."""

    def __init__(self, scene: Scene, config: EngineConfig, seed: int = 0,
                 n_listeners: int = 1, frames_per_chunk: int = 1,
                 uniforms_fn=None, backend: str = "auto",
                 diffraction: bool = False, air_alpha=None,
                 binaural: bool = False, head_radius: float = 0.0875,
                 shadow: float = 0.6, decorrelate: bool = True):
        if binaural and n_listeners != 1:
            raise ValueError("binaural streaming takes one head listener")
        self.scene = scene
        self.diffraction = diffraction
        self.air_alpha = air_alpha
        self.config = config
        self.seed = int(seed)
        self.n_listeners = 2 if binaural else n_listeners
        self.frames_per_chunk = frames_per_chunk
        self.uniforms_fn = uniforms_fn
        self.backend = backend
        self.binaural = binaural
        self.head_radius = head_radius
        self.shadow = shadow
        self.decorrelate = decorrelate
        self.state = init_stream(config.audio.ir_length,
                                 config.audio.chunk_samples,
                                 self.n_listeners, scene.n_bands,
                                 binaural=binaural, device=scene.device)

    def reset_ir(self) -> None:
        """The reference's R key (``RayTraceManager.cs:58-61``): drop the
        crossfade's previous IR, so the next chunk fades in from silence.
        Audio already in the ring keeps playing."""
        self.state.prev_ir.zero_()

    def process(self, dry_chunk: torch.Tensor, params: TraceParams,
                scene: Optional[Scene] = None,
                facing: float = 0.0) -> torch.Tensor:
        """One chunk; ``scene`` overrides the bound scene for this chunk
        (dynamic obstacles, ``RayTraceManager.cs:67``); ``facing``
        (radians) steers the decode of a binaural streamer."""
        i = self.state.chunk_index
        uniforms = self.uniforms_fn(i) if self.uniforms_fn else None
        out, self.state = stream_chunk(
            scene if scene is not None else self.scene, params, self.state,
            dry_chunk, seed=self.seed, n_rays=self.config.sim.ray_count,
            max_bounces=self.config.sim.max_bounces,
            sample_rate=self.config.audio.sample_rate,
            frames_per_chunk=self.frames_per_chunk,
            diffraction=self.diffraction, air_alpha=self.air_alpha,
            uniforms=uniforms, backend=self.backend,
            binaural_facing=(float(facing) if self.binaural else None),
            head_radius=self.head_radius, shadow=self.shadow,
            decorrelate=self.decorrelate)
        return out

    def stream_clip(self, dry: torch.Tensor, params_fn, scene_fn=None,
                    pad_tail: bool = True, loop: Optional[bool] = None,
                    total_chunks: Optional[int] = None, on_chunk=None,
                    facing_fn=None, doppler=False,
                    control_fn=None) -> torch.Tensor:
        """Stream a whole clip; ``params_fn(i) -> TraceParams`` supplies the
        poses and ``scene_fn(i) -> Scene`` optional per-chunk geometry.
        Returns wet audio ``[L, total]``.

        ``loop`` (``RayTraceManager.cs:74-77``): when set, the dry feed
        restarts at the clip head for ``total_chunks`` chunks (required);
        when clear, the clip plays once and ``pad_tail`` flushes the reverb
        tail. ``None`` honors ``config.audio.loop`` for timed streams.
        ``on_chunk(i, state)`` runs after every chunk. ``facing_fn(i)``
        gives a binaural streamer's head facing (radians) at chunk ``i``.
        ``control_fn(i) -> dict``: a truthy ``"reset_ir"`` applies
        :meth:`reset_ir` before chunk ``i``; a truthy ``"stop"`` silences
        the dry feed from chunk ``i``, flushes ``ir_length`` worth of
        chunks and ends the stream."""
        if doppler:
            raise _not_ported("Doppler streaming", 5)
        n = self.config.audio.chunk_samples
        total = dry.shape[-1]
        if loop is None:
            loop = self.config.audio.loop and total_chunks is not None
        if loop:
            if total_chunks is None:
                raise ValueError(
                    "loop=True streams forever; pass total_chunks")
            n_steps = total_chunks
        else:
            n_chunks = (total + n - 1) // n
            tail = (self.config.audio.ir_length + n - 1) // n \
                if pad_tail else 0
            n_steps = (n_chunks + tail) if total_chunks is None \
                else total_chunks
        tail_chunks = (self.config.audio.ir_length + n - 1) // n
        chunks = []
        stopped = False
        i, end_step = 0, n_steps
        while i < end_step:
            if control_fn is not None:
                ctrl = control_fn(i) or {}
                if ctrl.get("reset_ir"):
                    self.reset_ir()
                if ctrl.get("stop") and not stopped:
                    stopped = True
                    end_step = min(end_step, i + tail_chunks)
            piece = (torch.zeros(n, dtype=dry.dtype, device=dry.device)
                     if stopped else dry_chunk(dry, i, n, loop))
            scene_i = scene_fn(i) if scene_fn is not None else None
            facing = facing_fn(i) if facing_fn is not None else 0.0
            chunks.append(self.process(piece, params_fn(i), scene_i,
                                       facing=facing))
            if on_chunk is not None:
                on_chunk(i, self.state)
            i += 1
        return torch.cat(chunks, dim=-1)


def dry_chunk(dry: torch.Tensor, i: int, n: int, loop: bool
              ) -> torch.Tensor:
    """Chunk ``i`` of the dry feed. Looping wraps the clip modulo its
    length (``RayTraceManager.cs:74-77``); without loop the post-clip feed
    is silence (tail flush)."""
    total = dry.shape[-1]
    lo = i * n
    if loop:
        idx = ((lo % total) + torch.arange(n, device=dry.device)) % total
        return dry[..., idx]
    piece = dry[..., lo:lo + n]
    if piece.shape[-1] < n:
        piece = torch.nn.functional.pad(piece, (0, n - piece.shape[-1]))
    return piece
