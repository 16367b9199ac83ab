"""Room-dataset sweeps on one device (BASELINE.json config #5).

Port of ``realisticaudioraytracing2d_tpu/parallel/sweep.py::sweep_rooms``:
a batch of procedurally generated rooms (a stacked :class:`Scene`) is
traced in ONE launch of the rooms-batched kernel K9 on the card, or
through its plain version on the CPU, into the ``[n_rooms, L, T, K]`` IR
dataset. Rooms past the bounce kernel's wall limit (5,280 walls) go
through the cluster kernels on the card instead, one K8 (K = 1) or K7 call
per room (``ops/cuda/accel_kernel.py::trace_rooms_ir_accel``), where the
JAX package runs them through jnp. :func:`sweep_rooms_sharded` splits
the rooms over an axis of a :class:`.mesh.Mesh`, one :func:`sweep_rooms`
(one K9 launch) per shard.

Room ``i`` draws the Philox stream of entry ``room_offset + i``, its
global id, so a sweep of rows 4-7 with ``room_offset=4`` equals rows 4-7
of the whole sweep, and the sharded sweep equals the unsharded one bit
for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.scene import Scene
from ..ops.cuda import accel_kernel as ak
from ..ops.cuda import bounce_kernel as bk
from .mesh import Mesh, gather, on_device, sharded_leading

_BACKENDS = ("auto", "plain")


def trace_batch(scenes: Scene, sources, listeners, seed: int, n_frames: int,
                *, backend: str = "auto",
                uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                **kw) -> torch.Tensor:
    """The batched paths' choice of backend: the plain version of K9
    (:func:`..ops.cuda.bounce_kernel.trace_rooms_ir_mega_plain`) with
    ``backend="plain"``; else, for CUDA scenes past
    :data:`..ops.cuda.bounce_kernel.MAX_WALLS` walls, the cluster kernels
    entry by entry (:func:`..ops.cuda.accel_kernel.trace_rooms_ir_accel`,
    which, as every kernel, draws its own numbers and refuses
    ``uniforms``); else the K9 wrapper, which itself runs the plain
    version on a CPU scene. ``scenes`` is stacked (``[E or 1, W, ...]``);
    the cluster route also takes one unstacked scene that every entry
    shares. Returns the frame-summed ``[E, L, T, K]``."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    if backend == "plain":
        return bk.trace_rooms_ir_mega_plain(scenes, sources, listeners, seed,
                                            n_frames, uniforms=uniforms,
                                            **kw)
    if large_on_card(scenes):
        if uniforms is not None:
            raise ValueError("the kernels draw their own numbers: "
                             "uniforms= needs backend='plain'")
        return ak.trace_rooms_ir_accel(scenes, sources, listeners, seed,
                                       n_frames, **kw)
    return bk.trace_rooms_ir_mega(scenes, sources, listeners, seed, n_frames,
                                  uniforms=uniforms, **kw)


def large_on_card(scenes: Scene) -> bool:
    """Does a batch go to the cluster kernels: a CUDA scene past the
    bounce kernel's wall limit."""
    return scenes.device.type == "cuda" and scenes.n_walls > bk.MAX_WALLS


def sweep_rooms(scenes: Scene, sources, listeners, seed: int, *,
                n_rays: int, max_bounces: int, sample_rate: int,
                ir_length: int, n_frames: int = 1,
                listener_radius: float = 0.5, speed_of_sound: float = 343.0,
                input_gain: float = 1.0, backend: str = "auto",
                room_offset: int = 0,
                uniforms: Optional[Tuple[torch.Tensor,
                                         torch.Tensor]] = None,
                directivity=None, mic_directivity=None) -> torch.Tensor:
    """Sweep a room batch: returns frame-normalized IRs ``[n_rooms, L, T,
    K]``. ``scenes`` is stacked (leading room axis), ``sources``
    ``[n_rooms, 2]``, ``listeners`` ``[n_rooms, 2]`` or ``[n_rooms, L, 2]``.

    ``backend="auto"`` launches K9 once on a CUDA scene (one K8 or K7 call
    per room past 5,280 walls) and runs its plain version on a CPU scene;
    ``"plain"`` runs the plain version on either (the JAX package's
    ``backend="jnp"``). ``uniforms = (emit[R, F, n],
    u[R, F, B, n, 3])`` replace the Philox draws on the plain path (the
    parity tests pass JAX's); the kernel draws its own numbers, so a CUDA
    scene with ``backend="auto"`` refuses them. ``directivity`` (``[C]``
    shared or ``[n_rooms, C]`` per room) and ``mic_directivity`` (``[C]``,
    ``[L, C]`` or ``[n_rooms, L, C]``) weight emission and pickup in the
    kernel, as on the single-scene paths."""
    irs = trace_batch(scenes, sources, listeners, seed, n_frames,
                      backend=backend, uniforms=uniforms, n_rays=n_rays,
                      max_bounces=max_bounces, sample_rate=sample_rate,
                      ir_length=ir_length, listener_radius=listener_radius,
                      speed_of_sound=speed_of_sound, input_gain=input_gain,
                      entry_offset=room_offset, directivity=directivity,
                      mic_directivity=mic_directivity)
    # in place, and by a tensor: torch on CUDA divides by a host scalar as
    # a multiply by its reciprocal (ROADMAP section 3). The divisor is
    # filled on the device: a tensor copied from the host (new_tensor)
    # waits for the launch, which kept the next shard of
    # sweep_rooms_sharded from being issued while this one ran
    return irs.div_(torch.full((), float(n_frames), device=irs.device))


def sweep_rooms_sharded(scenes: Scene, sources, listeners, seed: int,
                        mesh: Mesh, *, n_rays: int, max_bounces: int,
                        sample_rate: int, ir_length: int, n_frames: int = 1,
                        axis: str = "rooms", backend: str = "auto",
                        uniforms: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                        **pose_kw) -> torch.Tensor:
    """:func:`sweep_rooms` with the rooms split over ``mesh[axis]``: shard
    ``d`` sweeps its rooms on its device with ``room_offset = d * local``
    (one K9 launch on a CUDA shard; K8/K7 calls past 5,280 walls), and the
    IRs come back in room order on the mesh's first device. The room count
    must divide evenly. Room ``i`` draws entry ``i`` wherever it runs and
    its fixed-point scale is its own, so the result equals the unsharded
    sweep bit for bit. ``uniforms`` (the plain path's per-room draws) are
    split with the rooms; ``pose_kw`` (``listener_radius``,
    ``speed_of_sound``, ``input_gain``, ``directivity``,
    ``mic_directivity``) reaches every shard unchanged, as in the JAX
    package."""
    n_rooms = len(sources)
    n_dev = mesh.shape[axis]
    if n_rooms % n_dev != 0:
        raise ValueError(f"{n_rooms} rooms not divisible by {axis}={n_dev}")
    local = n_rooms // n_dev
    parts = sharded_leading(mesh, axis, (
        scenes, torch.as_tensor(sources, dtype=torch.float32),
        torch.as_tensor(listeners, dtype=torch.float32), uniforms))
    irs = []
    for d, (dev, (scenes_d, src_d, lis_d, uni_d)) in enumerate(
            zip(mesh.axis_devices(axis), parts)):
        kw = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
              for k, v in pose_kw.items()}
        with on_device(dev):
            irs.append(sweep_rooms(
                scenes_d, src_d, lis_d, seed, n_rays=n_rays,
                max_bounces=max_bounces, sample_rate=sample_rate,
                ir_length=ir_length, n_frames=n_frames, backend=backend,
                room_offset=d * local, uniforms=uni_d, **kw))
    return gather(mesh, irs)
