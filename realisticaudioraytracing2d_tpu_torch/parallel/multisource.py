"""Multi-source batching and mixdown (BASELINE.json config #4).

Port of ``realisticaudioraytracing2d_tpu/parallel/multisource.py::
trace_sources_mixdown``: S simultaneous sources share one scene. They
become the S entries of one launch of the rooms-batched kernel K9, which
reads the one wall table with stride 0, and the IRs are mixed down by a
sum over sources at the listeners (exact, since an IR is linear in hit
energy). On a scene past the bounce kernel's wall limit (5,280 walls) the
sources go through the cluster kernels instead, one K8 (K = 1) or K7 call
per source on the one sorted scene. The mesh-sharded
``trace_sources_mixdown_sharded`` is not ported yet (ROADMAP queue 1,
item 10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.scene import Scene
from ..ops.trace import TraceParams
from .sweep import large_on_card, trace_batch


def trace_sources_mixdown(scene: Scene, params: TraceParams, seed: int, *,
                          n_rays: int, max_bounces: int, sample_rate: int,
                          ir_length: int, backend: str = "auto",
                          uniforms: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None
                          ) -> torch.Tensor:
    """Trace S sources (``params.source`` ``[S, 2]``, ``input_gain`` a
    scalar or per-source ``[S]``), one frame each, and return the summed IR
    ``[L, T, K]`` at the shared listeners ``params.listeners``.

    Source ``s`` draws the Philox stream of entry ``s``. ``backend="auto"``
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
                      mic_directivity=params.mic_directivity)
    return irs.sum(dim=0)                            # [L, T, K]
