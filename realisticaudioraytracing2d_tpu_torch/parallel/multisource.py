"""Multi-source batching and mixdown (BASELINE.json config #4).

Port of ``realisticaudioraytracing2d_tpu/parallel/multisource.py::
trace_sources_mixdown``: S simultaneous sources share one scene. They
become the S entries of one launch of the rooms-batched kernel K9, which
reads the one wall table with stride 0, and the IRs are mixed down by a
sum over sources at the listeners (exact, since an IR is linear in hit
energy). On a scene past the bounce kernel's wall limit (5,280 walls) the
sources go through the cluster kernels instead, one K8 (K = 1) or K7 call
per source on the one sorted scene. :func:`trace_sources_mixdown_sharded`
splits the sources over an axis of a :class:`.mesh.Mesh` and sums the
shards' mixdowns (the JAX package's ``psum``) in shard order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.scene import Scene
from ..ops.trace import TraceParams
from .mesh import Mesh, on_device, reduce_sum, sharded_leading
from .sweep import large_on_card, trace_batch


def trace_sources_mixdown(scene: Scene, params: TraceParams, seed: int, *,
                          n_rays: int, max_bounces: int, sample_rate: int,
                          ir_length: int, backend: str = "auto",
                          uniforms: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None,
                          entry_offset: int = 0) -> torch.Tensor:
    """Trace S sources (``params.source`` ``[S, 2]``, ``input_gain`` a
    scalar or per-source ``[S]``), one frame each, and return the summed IR
    ``[L, T, K]`` at the shared listeners ``params.listeners``.

    Source ``s`` draws the Philox stream of entry ``entry_offset + s``
    (a shard of :func:`trace_sources_mixdown_sharded` passes its first
    source's global index). ``backend="auto"``
    launches K9 once on a CUDA scene (one K8 or K7 call per source past
    5,280 walls, on the scene sorted once) and runs its plain version on a
    CPU scene; ``"plain"`` runs the plain version on either. ``uniforms =
    (emit[S, 1, R], u[S, 1, B, R, 3])`` replace the draws on the plain path
    (the parity tests pass JAX's). The sum over sources runs on the
    device in one fixed order, so one seed gives a bit-identical mixdown.

    ``params.directivity`` may be ``[C]`` (every source shares the
    pattern) or ``[S, C]`` (per-source aims, e.g. a steered speaker
    array); ``params.mic_directivity`` (``[C]`` or ``[L, C]``) applies to
    every source. Both run in the kernel, each source's block reading its
    own rows."""
    sources = params.source.reshape(-1, 2)
    n_src = sources.shape[0]
    # leading dim 1; the cluster route takes the scene itself, so that its
    # sorted tables are found again (ops/cuda/accel_kernel.py::prepare)
    shared = (scene if backend == "auto" and large_on_card(scene)
              else Scene(*(x[None] for x in scene)))
    listeners = params.listeners.expand(n_src, -1, 2)
    irs = trace_batch(shared, sources, listeners, seed, 1, backend=backend,
                      uniforms=uniforms, n_rays=n_rays,
                      max_bounces=max_bounces, sample_rate=sample_rate,
                      ir_length=ir_length,
                      listener_radius=params.listener_radius,
                      speed_of_sound=params.speed_of_sound,
                      input_gain=params.input_gain,
                      directivity=params.directivity,
                      mic_directivity=params.mic_directivity,
                      entry_offset=entry_offset)
    return irs.sum(dim=0)                            # [L, T, K]


def trace_sources_mixdown_sharded(scene: Scene, params: TraceParams,
                                  seed: int, mesh: Mesh, *, n_rays: int,
                                  max_bounces: int, sample_rate: int,
                                  ir_length: int, axis: str = "rays",
                                  backend: str = "auto",
                                  uniforms: Optional[Tuple[torch.Tensor,
                                                           torch.Tensor]]
                                  = None) -> torch.Tensor:
    """:func:`trace_sources_mixdown` with the sources split over
    ``mesh[axis]``; returns the summed IR ``[L, T, K]`` on the mesh's first
    device. The source count must divide evenly by the axis size. The
    per-source gains and, for a 2-D ``directivity`` (``[S, C]``, or ``[1,
    C]`` broadcast to every source), the per-source aims split with the
    sources; a ``[C]`` pattern is shared. Shard ``d`` runs its ``local`` sources on
    its device with entry offset ``d * local`` (one K9 launch; K8/K7 calls
    past 5,280 walls), so it draws the unsharded mixdown's numbers, and the
    shards' IRs are summed in shard order (:func:`.mesh.reduce_sum`): the
    result differs from the unsharded mixdown only in the order of the
    float sum over sources. ``uniforms`` (``emit[S, 1, R]``, ``u[S, 1, B,
    R, 3]``, the plain path's) split with the sources."""
    n_dev = mesh.shape[axis]
    sources = params.source.reshape(-1, 2)
    n_src = sources.shape[0]
    if n_src % n_dev != 0:
        raise ValueError(f"{n_src} sources not divisible by mesh axis "
                         f"{axis}={n_dev}")
    local = n_src // n_dev
    gains = torch.broadcast_to(params.input_gain.reshape(-1), (n_src,))
    dirs = params.directivity
    per_source = dirs is not None and dirs.dim() == 2
    if per_source:        # [1, C] broadcasts to every source, as in JAX
        dirs = torch.broadcast_to(dirs, (n_src, dirs.shape[-1]))
    parts = sharded_leading(mesh, axis, (sources, gains,
                                         dirs if per_source else None,
                                         uniforms))
    irs = []
    for d, (dev, (src_d, gain_d, dir_d, uni_d)) in enumerate(
            zip(mesh.axis_devices(axis), parts)):
        p_d = params.to(dev)._replace(
            source=src_d, input_gain=gain_d,
            directivity=dir_d if per_source else (
                None if dirs is None else dirs.to(dev)))
        with on_device(dev):
            irs.append(trace_sources_mixdown(
                scene.to(dev), p_d, seed, n_rays=n_rays,
                max_bounces=max_bounces, sample_rate=sample_rate,
                ir_length=ir_length, backend=backend, uniforms=uni_d,
                entry_offset=d * local))
    return reduce_sum(mesh, irs)
