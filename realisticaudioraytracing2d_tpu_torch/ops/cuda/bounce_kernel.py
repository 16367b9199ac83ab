"""Whole-frame bounce kernel: wrappers, plain version and launch counts.

Two entry points launch the one CUDA template of
``csrc/bounce_kernel.cu``:

* :func:`trace_frames_ir_whole` (K3) takes host uniforms ``emit[F, R]`` and
  ``u[F, B, R, 3]``; it replaces ``ops/pallas/bounce_kernel.py::
  trace_frame_ir_whole`` of the JAX package;
* :func:`trace_frames_ir_mega` (K4) draws Philox numbers in the kernel
  from an integer seed; it replaces ``::trace_frames_ir_mega``.

Both return the frame-SUMMED IR ``[L, T, 1]`` float32. On a CUDA scene
they launch the kernel or raise; on a CPU scene they run their plain
version, :func:`trace_frames_ir_plain` (the oracle trace + scatter,
summed over frames) and :func:`trace_frames_ir_mega_plain` (the same on
the kernel's Philox numbers), which are also what the kernel is held
against on the card. Each entry point counts its launches in
``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ...models.scene import Scene
from .. import rng
from ..ir import scatter_hits
from ..trace import TraceParams, trace_hits_only
from . import build

MAX_LISTENERS = 16
# 44 B per wall in the 227 KB of shared memory a block can use, beside
# the listener table (kMaxWalls in csrc/bounce_kernel.cu)
MAX_WALLS = (232448 - 2 * MAX_LISTENERS * 4) // (11 * 4)

_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def _kernel_fn():
    fn = build.load_library().art_trace_frames_ir
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_kernel_supported(scene: Scene, params: TraceParams) -> None:
    """Raise ``NotImplementedError`` for a configuration the kernel does not
    take. Such configurations are never rerouted to the plain path."""
    if scene.n_bands != 1:
        raise NotImplementedError(
            f"the CUDA bounce kernel traces K=1 only (scene has K="
            f"{scene.n_bands}); the banded kernel is still to port (ROADMAP "
            "queue 2, K3/K4 with K>1). backend='plain' traces bands.")
    if params.directivity is not None or params.mic_directivity is not None:
        raise NotImplementedError(
            "directive sources/microphones are still to port to the CUDA "
            "bounce kernel (ROADMAP queue 1, item 8)")
    n_l = params.listeners.shape[0]
    if n_l > MAX_LISTENERS:
        raise NotImplementedError(
            f"{n_l} listeners exceed the kernel's {MAX_LISTENERS}-listener "
            "table; blocked listener launches are still to port")
    if scene.n_walls > MAX_WALLS:
        raise NotImplementedError(
            f"{scene.n_walls} walls exceed the kernel's shared-memory limit "
            f"of {MAX_WALLS}; large scenes need the cluster kernels K7/K8, "
            "still to port (ROADMAP queue 2)")


def _check_tensor(name, x, device, shape=None, dtype=torch.float32):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the scene on {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")


def pack_walls(scene: Scene) -> torch.Tensor:
    """Wall table ``[11, W]``: ax, ay, v2x, v2y, cc, nx, ny, absorption,
    scattering, transmission, ior (the kernel's shared-memory layout).
    ``v2`` and ``cc`` are computed as the plain trace computes them."""
    ax, ay = scene.a[:, 0], scene.a[:, 1]
    v2x = scene.b[:, 0] - ax
    v2y = scene.b[:, 1] - ay
    cc = v2x * ay - v2y * ax
    return torch.stack([ax, ay, v2x, v2y, cc, scene.normal[:, 0],
                        scene.normal[:, 1], scene.absorption[:, 0],
                        scene.scattering, scene.transmission,
                        scene.ior]).contiguous()


def fixed_point_scale(params: TraceParams, n_frames: int, n_rays: int,
                      max_bounces: int) -> torch.Tensor:
    """The kernel's fixed-point scale ``S`` (a 0-d float64 tensor on the
    params' device; computed there, so no host sync).

    A bin can receive at most ``n_frames * n_rays * 2 * max_bounces`` hits
    of one listener (one direct and one NEE hit per bounce). A direct
    hit carries at most the input gain; an NEE hit at most
    ``gain * 0.5 / d^2`` with ``d`` >= the source-listener distance (the
    path through the wall is no shorter). ``S`` is the largest power of
    two that keeps that worst-case sum below 2^62, so no u64 bin
    overflows and ``S`` itself is exact."""
    d2 = ((params.listeners.double() - params.source.double()) ** 2
          ).sum(-1).min().clamp(min=1e-12)
    e_max = params.input_gain.double() * torch.clamp(0.5 / d2, min=1.0)
    # clamped at 1 so a zero gain still gives a finite S (at most 2^62)
    bound = (float(n_frames * n_rays * 2 * max_bounces) * e_max).clamp(min=1.0)
    return torch.exp2(torch.floor(62.0 - torch.log2(bound)))


def _launch(host_uniforms, scene, params, emit, u, key, n_frames, n_rays,
            max_bounces, sample_rate, ir_length):
    check_kernel_supported(scene, params)
    dev = scene.device
    walls = pack_walls(scene)
    lis = params.listeners.contiguous()
    scal = torch.stack([params.source[0], params.source[1],
                        params.listener_radius, params.speed_of_sound,
                        params.input_gain]).to(torch.float32).contiguous()
    for name, x in (("walls", walls), ("listeners", lis), ("scalars", scal)):
        _check_tensor(name, x, dev)
    n_l = lis.shape[0]
    scale = fixed_point_scale(params, n_frames, n_rays, max_bounces)
    acc = torch.empty((n_l, ir_length), dtype=torch.int64, device=dev)
    out = torch.empty((n_l, ir_length, 1), dtype=torch.float32, device=dev)
    err = _kernel_fn()(
        int(host_uniforms), walls.data_ptr(), scene.n_walls, lis.data_ptr(),
        n_l, scal.data_ptr(), float(sample_rate),
        emit.data_ptr() if emit is not None else None,
        u.data_ptr() if u is not None else None, key[0], key[1], n_rays,
        max_bounces, n_frames, ir_length, scale.data_ptr(), acc.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bounce kernel launch failed: cudaError {err}")
    return out


def trace_frames_ir_plain(scene: Scene, params: TraceParams,
                          emit: torch.Tensor, u: torch.Tensor, *,
                          sample_rate: int, ir_length: int) -> torch.Tensor:
    """Plain PyTorch version: the oracle trace + scatter of every frame
    (``emit[F, R]``, ``u[F, B, R, 3]``), summed over frames.
    Returns ``[L, T, K]``."""
    ir = torch.zeros((params.listeners.shape[0], ir_length, scene.n_bands),
                     dtype=torch.float32, device=scene.device)
    for f in range(emit.shape[0]):
        hits = trace_hits_only(scene, params, emit[f], u[f])
        ir = ir + scatter_hits(hits, sample_rate, ir_length)
    return ir


def trace_frames_ir_mega_plain(scene: Scene, params: TraceParams, seed: int,
                               n_frames: int, *, n_rays: int,
                               max_bounces: int, sample_rate: int,
                               ir_length: int) -> torch.Tensor:
    """Plain version of K4: :func:`trace_frames_ir_plain` on the Philox
    numbers the kernel draws for ``seed`` (:func:`..rng.philox_uniforms`)."""
    emit, u = rng.philox_uniforms(seed, n_frames, max_bounces, n_rays,
                                  scene.device)
    return trace_frames_ir_plain(scene, params, emit, u,
                                 sample_rate=sample_rate, ir_length=ir_length)


def trace_frames_ir_whole(scene: Scene, params: TraceParams,
                          emit: torch.Tensor, u: torch.Tensor, *,
                          sample_rate: int, ir_length: int) -> torch.Tensor:
    """K3: ``F`` frames with host uniforms ``emit[F, R]``, ``u[F, B, R, 3]``
    -> frame-summed IR ``[L, T, 1]``. CUDA scenes launch the kernel; CPU
    scenes run :func:`trace_frames_ir_plain`."""
    if scene.device.type != "cuda":
        return trace_frames_ir_plain(scene, params, emit, u,
                                     sample_rate=sample_rate,
                                     ir_length=ir_length)
    n_frames, n_rays = emit.shape
    max_bounces = u.shape[1]
    _check_tensor("emit", emit, scene.device, (n_frames, n_rays))
    _check_tensor("u", u, scene.device, (n_frames, max_bounces, n_rays, 3))
    out = _launch(True, scene, params, emit.contiguous(), u.contiguous(),
                  (0, 0), n_frames, n_rays, max_bounces, sample_rate,
                  ir_length)
    trace_frames_ir_whole.launches += 1
    return out


def trace_frames_ir_mega(scene: Scene, params: TraceParams, seed: int,
                         n_frames: int, *, n_rays: int, max_bounces: int,
                         sample_rate: int, ir_length: int) -> torch.Tensor:
    """K4: ``n_frames`` frames in one launch, uniforms drawn in the kernel
    (Philox-4x32-10 under the key of ``seed``) -> frame-summed IR
    ``[L, T, 1]``. CPU scenes run :func:`trace_frames_ir_mega_plain`."""
    if scene.device.type != "cuda":
        return trace_frames_ir_mega_plain(
            scene, params, seed, n_frames, n_rays=n_rays,
            max_bounces=max_bounces, sample_rate=sample_rate,
            ir_length=ir_length)
    out = _launch(False, scene, params, None, None, rng.seed_key(seed),
                  n_frames, n_rays, max_bounces, sample_rate, ir_length)
    trace_frames_ir_mega.launches += 1
    return out


trace_frames_ir_whole.launches = 0
trace_frames_ir_mega.launches = 0
