"""Impulse-response construction and accumulation (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/ops/ir.py`` (spec: the
reference's ``ProcessHits`` / ``ClearImpulse`` kernels,
``Raytrace2D.compute:157-172``): each hit deposits its energy into IR bin
``floor(timeDelay * SampleRate)``. This plain version adds hits in one
fixed order (:func:`add_rows` over the flattened ``[B, 2, R]`` hits of a
listener): ``index_add_`` on the CPU, and on the card, where that would
be float atomics in arbitrary order, the sort-based accumulate of
``index_put_``, so the same hits give a bit-identical IR on a rerun. The
hand kernels bin with fixed-point integer atomics instead.

:class:`IRState` holds ``(sum, frames)``, the reference's mutable
``ImpulseResponse`` buffer plus its ``accumFrames`` counter
(``RayTraceManager.cs:233``); normalization by the frame count happens at
use time, exactly like ``AudioConvolve.compute:30``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
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


def add_rows(n_rows: int, rows: torch.Tensor, values: torch.Tensor,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[rows[i]] += values[i]`` into zeros ``[n_rows, ...]``, in a
    fixed order on either device. ``keep[i]`` False marks an entry whose
    value is zero and whose row is the caller's sacrificial one.

    On the CPU ``index_add_`` runs in index order. On CUDA it would be
    float ``atomicAdd`` in arbitrary order; there the accumulate form of
    ``index_put_`` under torch's deterministic mode (scoped to this call)
    sorts the indices and sums each row's values in their original order,
    so a rerun gives the same bits. That kernel walks the entries of one
    row one after the other, so the CUDA path first drops the entries
    ``keep`` rules out (most hit records are invalid, and all of them
    would queue on the sacrificial row); the order of the others, and so
    every sum, stays as it is."""
    out = torch.zeros((n_rows,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    if values.device.type != "cuda":
        return out.index_add_(0, rows, values)
    if keep is not None:
        rows, values = rows[keep], values[keep]
    was_on = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return out.index_put_((rows,), values, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was_on, warn_only=warn_only)


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
    ir = add_rows(l * (ir_length + 1), rows.reshape(-1),
                  energy.reshape(l * n, k), ok.reshape(-1))
    return ir.reshape(l, ir_length + 1, k)[:, :ir_length]


def scatter_hits_soft(hits: Hits, sample_rate: int, ir_length: int
                      ) -> torch.Tensor:
    """Differentiable variant of :func:`scatter_hits` (JAX
    ``ops/ir.py:98-133``): each hit splats linearly onto the two bins
    around ``pos = delay * sample_rate``, with weights ``1 - frac`` and
    ``frac``, ``frac = pos - floor(pos)``. ``frac`` carries the gradient
    in the delay; ``floor`` carries none. A share that falls out of range
    goes to the sacrificial bin ``T``, as in :func:`scatter_hits`.

    The deposits go through :func:`add_rows` in the JAX function's order
    (every lower share, then every upper share), so the IR is
    deterministic on the card, and its backward is a gather."""
    delay, valid, energy = _flatten_hits(hits)
    l, n, k = energy.shape
    pos = delay * sample_rate
    i0f = torch.floor(pos)
    frac = pos - i0f
    # int64: a far miss (delay ~ INF / c) does not wrap
    i0 = i0f.long()
    ok0 = valid & (i0 >= 0) & (i0 < ir_length)
    ok1 = valid & (i0 + 1 >= 0) & (i0 + 1 < ir_length)
    b0 = torch.where(ok0, i0, ir_length)
    b1 = torch.where(ok1, i0 + 1, ir_length)
    e0 = energy * ((1.0 - frac) * ok0.to(frac.dtype))[..., None]
    e1 = energy * (frac * ok1.to(frac.dtype))[..., None]
    base = (ir_length + 1) * torch.arange(l, device=delay.device)[:, None]
    rows = torch.cat([b0 + base, b1 + base], dim=1)         # [L, 2N]
    ir = add_rows(l * (ir_length + 1), rows.reshape(-1),
                  torch.cat([e0, e1], dim=1).reshape(l * 2 * n, k),
                  torch.cat([ok0, ok1], dim=1).reshape(-1))
    return ir.reshape(l, ir_length + 1, k)[:, :ir_length]


def accumulate(state: IRState, hits: Hits, sample_rate: int) -> IRState:
    """One frame of Monte-Carlo IR accumulation (ProcessHits +
    accumFrames++, ``RayTraceManager.cs:220-233``)."""
    ir = scatter_hits(hits, sample_rate, state.ir_length)
    return IRState(sum=state.sum + ir, frames=state.frames + 1)


def muffle_band_energies(energy: torch.Tensor, muffle: torch.Tensor,
                         n_bands: int, muffle_scale: float = 5.0
                         ) -> torch.Tensor:
    """Legacy frequency spread: expand scalar hit energies ``[...]`` into
    band energies ``[..., n_bands]`` attenuated as
    ``energy * exp(-muffle * band * muffle_scale / n_bands)``, verbatim
    ``RaytraceOcclusion2D.compute:248`` (with its ``WindowSize`` = n_bands
    and default ``muffleFactor = 5.0`` from ``RayTraceManagerComplex.cs:28``).
    """
    bands = torch.arange(n_bands, dtype=torch.float32, device=energy.device)
    # a tensor divisor keeps IEEE division on CUDA (trace.emission_angle)
    att = torch.exp(-muffle[..., None] * bands * muffle_scale
                    / bands.new_tensor(float(n_bands)))
    return energy[..., None] * att


def rasterize_ir(ir_accum: torch.Tensor, frames: int, gain: float = 1000.0,
                 width: int = 1024, height: int = 256) -> torch.Tensor:
    """Waveform raster of a (possibly banded) IR, the ``DrawIR`` debug
    overlay (``Raytrace2D.compute:174-189``) as a pure function.

    ``ir_accum``: [T] or [T, K] accumulated (unnormalized) IR; ``frames``
    its frame count. Returns a float32 image [height, width] with 1.0 where
    the reference writes green. Reference mapping: column x samples bin
    ``floor(x/W * T)``, bar spans ``0.1*h < y < 0.1*h + amp * gain * h``
    with ``amp = ir[bin]/accumCount``.

    The JAX function is jitted with ``width`` static, and XLA turns its
    ``x / width`` into ``x * (1 / width)`` in float32, which for a width
    that is no power of two moves a few columns by one bin against true
    division. The port multiplies by the same float32 reciprocal (computed
    on the host, so the card rounds as the CPU does) and its images equal
    JAX's exactly; ``amp`` divides by a tensor."""
    if ir_accum.dim() == 2:
        ir_accum = ir_accum.sum(dim=-1)
    t = ir_accum.shape[0]
    cols = torch.arange(width, dtype=torch.float32, device=ir_accum.device)
    inv_width = float(np.float32(1.0) / np.float32(width))
    xs = (cols * inv_width * t).to(torch.int32)
    amp = ir_accum[torch.clamp(xs, 0, t - 1).long()] \
        / ir_accum.new_tensor(float(max(1, int(frames))))
    h = float(height)
    y_top = 0.1 * h + amp * gain * h                       # [W]
    rows = torch.arange(height, dtype=torch.float32,
                        device=ir_accum.device)[:, None]   # [H, 1]
    img = (rows > 0.1 * h) & (rows < y_top[None, :])
    # Image rows run bottom-up in the reference texture; keep that layout.
    return img.to(torch.float32)
