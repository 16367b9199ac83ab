"""Ray-axis sharding: one scene, the ray batch split across a mesh axis.

Port of ``realisticaudioraytracing2d_tpu/parallel/rays.py``. An IR is
linear in its hits, so tracing the Monte-Carlo ray batch in shards and
summing the partial IRs is exact. Shard ``d`` traces ``n_rays / n_dev``
rays with its own full-circle stratified fan, as in the JAX package: the
union is an unbiased estimator whose stratification is per shard.

Random numbers: shard ``d`` draws the Philox stream of batch entry ``d``
(counter word 3, the kernels' entry id; JAX folds ``d`` into its key).
Streams of different entries are disjoint by construction, and shard 0 is
the unsharded trace at ``n_rays / n_dev`` rays. Each shard routes as the
single-scene engine does (:func:`..engine.trace_ir`): K4 on a CUDA scene,
the cluster kernels K8/K7 past 5,280 walls, the plain version on the CPU
or with ``backend="plain"`` (the JAX package's ``"jnp"``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..engine import trace_ir
from ..models.scene import Scene
from ..ops.trace import TraceParams
from .mesh import Mesh, on_device, reduce_sum

_BACKENDS = ("auto", "plain")


def trace_rays_sharded(scene: Scene, params: TraceParams, seed: int,
                       mesh: Mesh, *, n_rays: int, max_bounces: int,
                       sample_rate: int, ir_length: int, axis: str = "rays",
                       backend: str = "auto",
                       uniforms: Optional[Sequence[Tuple[torch.Tensor,
                                                         torch.Tensor]]]
                       = None) -> torch.Tensor:
    """Trace one frame of ``n_rays`` rays split over ``mesh[axis]`` and
    return the summed IR ``[L, T, K]`` on the mesh's first device. The
    rays must divide evenly by the axis size.

    ``uniforms``: one ``(emit[R_d], u[B, R_d, 3])`` per shard in place of
    the Philox draws (the parity tests pass JAX's per-shard draws). On a
    CUDA scene they go to K3; on the CPU and with ``backend="plain"``, to
    the plain version."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    n_dev = mesh.shape[axis]
    if n_rays % n_dev != 0:
        raise ValueError(f"n_rays={n_rays} not divisible by {axis}={n_dev}")
    if uniforms is not None and len(uniforms) != n_dev:
        raise ValueError(f"uniforms: {len(uniforms)} shards for "
                         f"{axis}={n_dev}")
    local = n_rays // n_dev
    parts = []
    for d, dev in enumerate(mesh.axis_devices(axis)):
        uni = None if uniforms is None else tuple(
            x.to(dev)[None] for x in uniforms[d])
        with on_device(dev):
            parts.append(trace_ir(
                scene.to(dev), params.to(dev), n_rays=local,
                max_bounces=max_bounces, sample_rate=sample_rate,
                ir_length=ir_length, seed=seed, uniforms=uni,
                backend=backend, entry=d))
    return reduce_sum(mesh, parts)
