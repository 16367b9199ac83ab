"""Impulse-response construction and accumulation (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/ops/ir.py`` (spec: the
reference's ``ProcessHits`` / ``ClearImpulse`` kernels,
``Raytrace2D.compute:157-172``): each hit deposits its energy into IR bin
``floor(timeDelay * SampleRate)``. This plain version adds hits in one
fixed order (``index_add_`` over the flattened ``[B, 2, R]`` hits of a
listener), which on the CPU is deterministic. The hand kernel bins with
fixed-point integer atomics instead, so it is deterministic on the card.

:class:`IRState` holds ``(sum, frames)``, the reference's mutable
``ImpulseResponse`` buffer plus its ``accumFrames`` counter
(``RayTraceManager.cs:233``); normalization by the frame count happens at
use time, exactly like ``AudioConvolve.compute:30``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve
from .trace import Hits


class IRState(NamedTuple):
    """Accumulated impulse response: running energy sum ``[L, T, K]``
    (listeners, time bins, bands) + frame count."""

    sum: torch.Tensor   # [L, T, K] float32
    frames: int

    @staticmethod
    def zeros(ir_length: int, n_listeners: int = 1, n_bands: int = 1,
              device=None) -> "IRState":
        """Fresh state: the ``ClearImpulse`` + ``accumFrames = 0`` reset
        (``RayTraceManager.cs:169-177``)."""
        return IRState(sum=torch.zeros((n_listeners, ir_length, n_bands),
                                       dtype=torch.float32,
                                       device=resolve(device)),
                       frames=0)

    @property
    def ir_length(self) -> int:
        return self.sum.shape[-2]

    def normalized(self) -> torch.Tensor:
        """Monte-Carlo frame average ``sum / max(1, frames)`` (a tensor
        divisor keeps IEEE division on CUDA, see ``trace.emission_angle``)."""
        return self.sum / self.sum.new_tensor(float(max(1, self.frames)))


def _flatten_hits(hits: Hits):
    """[B,2,R,L] hit records -> per-listener flat (delay[L,N], valid[L,N],
    energy[L,N,K])."""
    b, s, r, l = hits.valid.shape
    k = hits.energy.shape[-1]
    n = b * s * r
    delay = hits.delay.movedim(-1, 0).reshape(l, n)
    valid = hits.valid.movedim(-1, 0).reshape(l, n)
    energy = hits.energy.movedim(-2, 0).reshape(l, n, k)
    return delay, valid, energy


def scatter_hits(hits: Hits, sample_rate: int, ir_length: int
                 ) -> torch.Tensor:
    """Deposit hits into IR bins: returns ``ir[L, T, K]``.

    Bin index is ``floor(delay * sample_rate)``; out-of-range or invalid
    hits are routed to a sacrificial bin ``T`` that is sliced off (the
    JAX function's rule, ``ops/ir.py:84-95``)."""
    delay, valid, energy = _flatten_hits(hits)
    l, n, k = energy.shape
    bins = torch.floor(delay * sample_rate).to(torch.int32)
    ok = valid & (bins >= 0) & (bins < ir_length)
    bins = torch.where(ok, bins, ir_length).long()
    energy = energy * ok[..., None].to(energy.dtype)
    rows = bins + (ir_length + 1) * torch.arange(
        l, device=bins.device)[:, None]                      # [L, N]
    ir = torch.zeros((l * (ir_length + 1), k), dtype=torch.float32,
                     device=energy.device)
    ir.index_add_(0, rows.reshape(-1), energy.reshape(l * n, k))
    return ir.reshape(l, ir_length + 1, k)[:, :ir_length]


def accumulate(state: IRState, hits: Hits, sample_rate: int) -> IRState:
    """One frame of Monte-Carlo IR accumulation (ProcessHits +
    accumFrames++, ``RayTraceManager.cs:220-233``)."""
    ir = scatter_hits(hits, sample_rate, state.ir_length)
    return IRState(sum=state.sum + ir, frames=state.frames + 1)
