"""Frame-axis data parallelism: Monte-Carlo frames split across a mesh axis.

Port of ``realisticaudioraytracing2d_tpu/parallel/frames.py``. Frames are
independent Monte-Carlo samples and an IR accumulates as a sum over
frames, so distributing the frame loop and summing the partial sums is
exact. Each shard runs the full single-frame workload (all rays, all
walls) on its slice of the frame stream: shard ``d`` runs frames
``d * local .. (d + 1) * local - 1`` of the unsharded stream, as the JAX
package's jnp path does (``frame_key(key, d * local + i)``). On a CUDA
scene that is one kernel call of ``local`` frames with ``frame_offset =
d * local`` (the frames' Philox counter word 1): one K4 launch up to
5,280 walls, and past them ``max_bounces`` launches of the cluster kernel
(K8 at one band, K7 at more), so a scene of any wall count shards, as in
the JAX package; the sharded IR is the unsharded IR summed in another
order.

The kernels' fixed-point scale depends on the call's frame count
(:func:`..ops.cuda.bounce_kernel.fixed_point_scale`), so a shard rounds
each deposit to ``1 / S_d`` where the unsharded call rounds to ``1 / S``:
a bin of ``n`` deposits differs from the unsharded bin by at most ``n /
S`` (``n <= F * R * 2 * B``), plus the float rounding of the sum over
shards. The plain path bins in float and differs by the order of the sum
alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..engine import trace_ir
from ..models.scene import Scene
from ..ops import ir as irm
from ..ops.trace import TraceParams
from .mesh import Mesh, on_device, reduce_sum

_BACKENDS = ("auto", "plain")


def accumulate_frames_sharded(scene: Scene, params: TraceParams,
                              state: irm.IRState, seed: int, mesh: Mesh, *,
                              n_rays: int, max_bounces: int,
                              sample_rate: int, n_frames: int,
                              axis: str = "rooms", backend: str = "auto",
                              uniforms: Optional[Tuple[torch.Tensor,
                                                       torch.Tensor]] = None
                              ) -> irm.IRState:
    """Accumulate ``n_frames`` frames with the frame loop split over
    ``mesh[axis]``; returns ``state`` advanced by all of them
    (``frames += n_frames``), on the mesh's first device. ``n_frames`` must
    divide evenly by the axis size. ``uniforms = (emit[F, R], u[F, B, R,
    3])`` replace the draws frame by frame (K3 on a CUDA scene, the plain
    version on the CPU and with ``backend="plain"``)."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    n_dev = mesh.shape[axis]
    if n_frames % n_dev != 0:
        raise ValueError(
            f"n_frames={n_frames} not divisible by {axis}={n_dev}")
    local = n_frames // n_dev
    parts = []
    for d, dev in enumerate(mesh.axis_devices(axis)):
        frames = slice(d * local, (d + 1) * local)
        uni = None if uniforms is None else tuple(
            x[frames].to(dev) for x in uniforms)
        with on_device(dev):
            parts.append(trace_ir(
                scene.to(dev), params.to(dev), n_rays=n_rays,
                max_bounces=max_bounces, sample_rate=sample_rate,
                ir_length=state.ir_length, n_frames=local, seed=seed,
                uniforms=uni, backend=backend, frame_offset=d * local))
    return irm.IRState(sum=state.sum.to(mesh.first) + reduce_sum(mesh, parts),
                       frames=state.frames + n_frames)
