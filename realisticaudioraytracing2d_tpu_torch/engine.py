"""High-level engine: trace -> IR accumulation -> convolution (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/engine.py`` (the reference's
``RayTraceManager.RunSimulation``/``OnSimulationFinished``,
``Assets/Script/RayTraceManager.cs:179-244``, and the legacy offline
bake, ``RayTraceManagerComplex.cs:170-227``).

Routing of :func:`trace_accumulate` (the JAX package's
``engine.py:110-136``, with the H100's limits in place of VMEM limits):

* a CUDA scene of at most ``MAX_WALLS`` (5,280) walls goes to the bounce
  kernel (``ops/cuda/bounce_kernel.py``: K4 with in-kernel Philox numbers
  for a seed, K3 when uniforms are given), which keeps the whole wall
  table in one block's shared memory, at any band count;
* a larger CUDA scene goes to the cluster kernels
  (``ops/cuda/accel_kernel.py``), one launch per bounce with the Morton
  re-sort of the rays between launches: K8 for K = 1, K7 (the same
  kernel's banded instantiations) for any K > 1;
* ``backend="accel"`` forces the cluster path on any scene (K8 at K = 1,
  K7 at K > 1), so both can be held against K4 on one scene. The port's
  backend values are part of its API and mirror the JAX engine's
  (``"auto"``, ``"accel"``, and ``"plain"`` for its ``"jnp"``), so code
  written for one engine names the same routes on the other;
* a CPU scene runs the plain path (``backend="accel"``: the cluster
  kernels' plain version), and ``backend="plain"`` forces the plain path
  on either device (the JAX package's ``backend="jnp"``).

Every route takes a Philox ``entry`` and a ``frame_offset`` (K4 and the
cluster kernels alike), so a ray-sharded or frame-sharded run
(``parallel/``) takes a scene of any wall count, as the JAX package's
does. Every kernel takes any listener count (listener blocks where a
block's shared memory is too small for all of them). What a kernel does
not take raises on CUDA and is never rerouted: host ``uniforms`` on a
route whose kernel draws its own numbers, and patterns too large for a
block's shared memory; both messages name ``backend='plain'``.

Each call of :func:`trace_ir` (and so of :func:`trace_accumulate`) is one
span of the port's (``utils/profiling.py::span``) named by the route that
ran: ``art.trace.k4``, ``art.trace.k3``, ``art.trace.cluster`` (K8/K7) or
``art.trace.plain`` (any plain version, every CPU scene's).

Routing of a request for hit RECORDS (:func:`trace_hits`: the legacy
spectro-IR, anything that consumes individual hits instead of a binned
IR), by device and shape:

* a CUDA scene with one listener, one band and at most ``MAX_WALLS`` walls
  goes to the hit-row kernel K5 (``bounce_kernel.trace_fused``);
* any other CUDA scene (more listeners, bands, or walls) goes to the plain
  trace with its two rays x walls passes in the kernels K1 and K2
  (``ops/trace.py::trace(use_kernels=True)``), as do the debug ray paths
  (:meth:`Engine.trace_debug`);
* a CPU scene runs the plain trace.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import EngineConfig
from .models.scene import Scene
from .ops import convolve as cv
from .ops import ir as irm
from .ops.cuda import accel_kernel as ak
from .ops.cuda import bounce_kernel as bk
from .ops import rng
from .ops.trace import DebugPaths, Hits, TraceParams, trace, trace_hits_only
from .utils.profiling import span

_BACKENDS = ("auto", "plain", "accel")


def trace_accumulate(scene: Scene, params: TraceParams, state: irm.IRState,
                     *, n_rays: int, max_bounces: int, sample_rate: int,
                     n_frames: int = 1, seed: int = 0,
                     uniforms: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                     backend: str = "auto") -> irm.IRState:
    """Run ``n_frames`` trace frames and add them to ``state``.

    Frame ``f`` draws from ``(seed, f)``: the Philox stream of
    :func:`..ops.rng.philox_uniforms`, which the kernel draws in-kernel
    and the plain path computes on the host, so one seed names the same
    rays on either path. ``uniforms = (emit[F, R], u[F, B, R, 3])``
    replaces the draws (the parity tests pass JAX's)."""
    ir = trace_ir(scene, params, n_rays=n_rays, max_bounces=max_bounces,
                  sample_rate=sample_rate, ir_length=state.ir_length,
                  n_frames=n_frames, seed=seed, uniforms=uniforms,
                  backend=backend)
    return irm.IRState(sum=state.sum + ir, frames=state.frames + n_frames)


def trace_ir(scene: Scene, params: TraceParams, *, n_rays: int,
             max_bounces: int, sample_rate: int, ir_length: int,
             n_frames: int = 1, seed: int = 0,
             uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             backend: str = "auto", entry: int = 0,
             frame_offset: int = 0) -> torch.Tensor:
    """The frame-summed IR ``[L, T, K]`` of ``n_frames`` frames, routed as
    :func:`trace_accumulate` (which adds it to its state). ``entry`` and
    ``frame_offset`` name the Philox stream as the kernels' arguments of
    those names do (:func:`..ops.cuda.bounce_kernel.trace_frames_ir_mega`,
    :func:`..ops.cuda.accel_kernel.trace_frames_ir_accel_sorted`), on
    every route: the shard of a ray-sharded trace draws entry ``d``, the
    shard of a frame-sharded run the frames from ``frame_offset`` on.
    Host ``uniforms`` are the frames' numbers themselves: with them the
    offset names nothing and is not used (a sharded caller slices the
    uniforms of its frames)."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    kw = dict(sample_rate=sample_rate, ir_length=ir_length)
    plain = backend == "plain"
    # the span names the route that runs: a kernel's, or the plain version
    kernel = scene.device.type == "cuda" and not plain
    if backend == "accel" or (backend == "auto"
                              and scene.device.type == "cuda"
                              and scene.n_walls > bk.MAX_WALLS):
        with span("trace.cluster" if kernel else "trace.plain"):
            return _trace_accel(scene, params, seed, n_frames, uniforms,
                                n_rays=n_rays, max_bounces=max_bounces,
                                entry=entry,
                                frame_offset=0 if uniforms is not None
                                else frame_offset, **kw)
    if uniforms is None:
        mega = bk.trace_frames_ir_mega_plain if plain \
            else bk.trace_frames_ir_mega
        with span("trace.k4" if kernel else "trace.plain"):
            return mega(scene, params, seed, n_frames, n_rays=n_rays,
                        max_bounces=max_bounces, entry=entry,
                        frame_offset=frame_offset, **kw)
    emit, u = uniforms
    if emit.shape != (n_frames, n_rays) or \
            u.shape != (n_frames, max_bounces, n_rays, 3):
        raise ValueError(
            f"uniforms must be emit[{n_frames}, {n_rays}] and "
            f"u[{n_frames}, {max_bounces}, {n_rays}, 3]; got "
            f"{tuple(emit.shape)} and {tuple(u.shape)}")
    whole = bk.trace_frames_ir_plain if plain else bk.trace_frames_ir_whole
    with span("trace.k3" if kernel else "trace.plain"):
        return whole(scene, params, emit, u, **kw)


def _trace_accel(scene: Scene, params: TraceParams, seed: int,
                 n_frames: int, uniforms, entry: int = 0,
                 frame_offset: int = 0, **kw) -> torch.Tensor:
    """The cluster path: K8 for K = 1, K7 for banded scenes (both the
    sorted bounce kernel), or their plain version on a CPU scene, on the
    Philox frames ``frame_offset ..`` of ``seed`` and ``entry``. Host
    ``uniforms`` reach only the plain version: the kernels draw their own
    numbers."""
    if scene.device.type != "cuda":
        return ak.trace_frames_ir_accel_sorted_plain(
            scene, params, seed, n_frames, uniforms=uniforms, entry=entry,
            frame_offset=frame_offset, **kw)
    if uniforms is not None:
        raise ValueError("the cluster kernels draw their own numbers: "
                         "uniforms= needs backend='plain'")
    return ak.trace_frames_ir_accel_sorted(scene, params, seed, n_frames,
                                           entry=entry,
                                           frame_offset=frame_offset, **kw)


def trace_hits(scene: Scene, params: TraceParams, emit: torch.Tensor,
               u: torch.Tensor) -> Hits:
    """One frame's hit records ``[B, 2, R, L]`` for host uniforms
    ``emit[R]``, ``u[B, R, 3]``: the one place that routes a request for
    hits (see the module docstring). On CUDA the chosen kernel launches or
    raises; nothing continues on a plain version."""
    if scene.device.type != "cuda":
        return trace_hits_only(scene, params, emit, u)
    if params.listeners.shape[0] == 1 and scene.n_bands == 1 \
            and scene.n_walls <= bk.MAX_WALLS:
        return bk.trace_fused(scene, params, emit, u)
    return trace_hits_only(scene, params, emit, u, use_kernels=True)


def bake_audio(dry: torch.Tensor, state: irm.IRState, *,
               normalize: bool = True) -> torch.Tensor:
    """Offline bake: one FFT convolution of a whole dry clip with the
    frame-averaged IR (``RayTraceManagerComplex.cs:170-245``). Returns
    ``[N+T]`` mono or ``[L, N+T]``."""
    ir = state.normalized()                  # [L, T, K]
    if ir.shape[0] == 1:
        ir = ir[0]                           # -> [T, K] (mono listener)
    wet = cv.apply_ir(dry, ir, accum_count=1)
    return cv.peak_normalize(wet) if normalize else wet


class Engine:
    """A scene + config bound to the pure functions; keeps no simulation
    state. Everything lives on the scene's device."""

    def __init__(self, scene: Scene, config: EngineConfig,
                 n_listeners: int = 1):
        self.scene = scene
        self.config = config
        self.n_listeners = n_listeners

    def fresh_ir(self) -> irm.IRState:
        return irm.IRState.zeros(self.config.audio.ir_length,
                                 self.n_listeners, self.scene.n_bands,
                                 device=self.scene.device)

    def params(self, source, listener, directivity=None,
               mic_directivity=None) -> TraceParams:
        with span("params"):
            return TraceParams.make(
                source, listener,
                listener_radius=self.config.sim.listener_radius,
                speed_of_sound=self.config.sim.speed_of_sound,
                input_gain=self.config.sim.input_gain,
                directivity=directivity, mic_directivity=mic_directivity,
                device=self.scene.device)

    def trace_frames(self, params: TraceParams, seed: int = 0,
                     n_frames: int = 1,
                     state: Optional[irm.IRState] = None,
                     uniforms=None, backend: str = "auto") -> irm.IRState:
        state = self.fresh_ir() if state is None else state
        return trace_accumulate(
            self.scene, params, state, n_rays=self.config.sim.ray_count,
            max_bounces=self.config.sim.max_bounces,
            sample_rate=self.config.audio.sample_rate, n_frames=n_frames,
            seed=seed, uniforms=uniforms, backend=backend)

    def frame_uniforms(self, seed: int, frame: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(emit[R], u[B, R, 3])`` of frame ``frame`` of ``seed``: the
        Philox numbers K4 draws for that frame, so the hit records and
        debug paths of a seed are those of the rays behind its IR."""
        emit, u = rng.philox_uniforms(
            seed, 1, self.config.sim.max_bounces, self.config.sim.ray_count,
            self.scene.device, first_frame=frame)
        return emit[0], u[0]

    def trace_hits(self, params: TraceParams, seed: int = 0,
                   frame: int = 0) -> Hits:
        """Hit records of one frame of ``seed`` (:func:`trace_hits`)."""
        return trace_hits(self.scene, params,
                          *self.frame_uniforms(seed, frame))

    def trace_debug(self, params: TraceParams, seed: int = 0,
                    n_debug: int = 100) -> Tuple[Hits, DebugPaths]:
        """Frame 0 of ``seed`` with the ray paths of its first ``n_debug``
        rays, through ``trace(use_kernels=True)``: K1 and K2 on a CUDA
        scene, their plain versions on the CPU."""
        return trace(self.scene, params, *self.frame_uniforms(seed),
                     n_debug=n_debug, use_kernels=True)

    def bake(self, dry: torch.Tensor, state: irm.IRState,
             normalize: bool = True) -> torch.Tensor:
        return bake_audio(dry, state, normalize=normalize)
