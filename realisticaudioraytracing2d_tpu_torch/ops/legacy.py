"""Legacy frequency-binned pipeline parity (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/ops/legacy.py``. The reference
ships an older kernel suite (``RaytraceOcclusion2D.compute``) and a
synchronous orchestrator (``RayTraceManagerComplex.cs``) whose IR is
**time x frequency binned**: hits carry a ``muffleFactor`` (placeholder
``1 - energy``, ``RaytraceOcclusion2D.compute:125-127``) and ``ProcessHits``
spreads each hit across ``WindowSize`` (=128) frequency slots with
``exp(-muffle * freq * MuffleScale / WindowSize)`` attenuation at time bin
``timeDelay * SampleRate / WindowSize`` (``:234-252``).

This module reproduces that pipeline on top of the modern trace's hit
records: scalar hits -> muffled banded IR -> spectrogram raster -> offline
bake. The FFT/IFFT the legacy kernels sketched is ``torch.fft.irfft``
(cuFFT on the card): in the JAX package that product is XLA's FFT, outside
any hand kernel. Both scatters go through ``ops/ir.py::add_rows``, so the
card gives the same bits on a rerun.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve
from .ir import add_rows, muffle_band_energies
from .trace import Hits

DEFAULT_WINDOW_SIZE = 128   # RayTraceManagerComplex.cs:27
DEFAULT_MUFFLE_SCALE = 5.0  # RayTraceManagerComplex.cs:28


def hit_muffle_factors(hits: Hits) -> torch.Tensor:
    """The legacy placeholder muffle model: ``muffle = 1 - energy``
    (``RaytraceOcclusion2D.compute:126``), using the scalar (band-0)
    energy. Shape [B, 2, R, L]."""
    return 1.0 - hits.energy[..., 0]


def scatter_hits_legacy(hits: Hits, sample_rate: int, n_time_bins: int,
                        window_size: int = DEFAULT_WINDOW_SIZE,
                        muffle_scale: float = DEFAULT_MUFFLE_SCALE
                        ) -> torch.Tensor:
    """Build the legacy time x frequency IR ``[L, n_time_bins, window_size]``.

    Time bin = ``floor(delay * sample_rate / window_size)``; each hit's
    energy spreads across the ``window_size`` frequency slots with the
    exponential high-frequency muffle (``RaytraceOcclusion2D.compute:
    241-249``), scatter-added in a fixed order.
    """
    b, s, r, l = hits.valid.shape
    n = b * s * r
    delay = hits.delay.movedim(-1, 0).reshape(l, n)
    valid = hits.valid.movedim(-1, 0).reshape(l, n)
    energy = hits.energy[..., 0].movedim(-1, 0).reshape(l, n)
    muffle = hit_muffle_factors(hits).movedim(-1, 0).reshape(l, n)

    # a tensor divisor keeps IEEE division on CUDA (trace.emission_angle)
    bins = torch.floor(delay * sample_rate
                       / delay.new_tensor(float(window_size))
                       ).to(torch.int32)
    ok = valid & (bins >= 0) & (bins < n_time_bins)
    bins = torch.where(ok, bins, n_time_bins).long()
    banded = muffle_band_energies(energy, muffle, window_size,
                                  muffle_scale)          # [L, N, W]
    banded = banded * ok[..., None].to(banded.dtype)
    rows = bins + (n_time_bins + 1) * torch.arange(
        l, device=bins.device)[:, None]                  # [L, N]
    ir = add_rows(l * (n_time_bins + 1), rows.reshape(-1),
                  banded.reshape(l * n, window_size), ok.reshape(-1))
    return ir.reshape(l, n_time_bins + 1, window_size)[:, :n_time_bins]


class LegacyIRState(NamedTuple):
    """Accumulated legacy spectro-IR + frame counter (single mutable buffer
    in the reference; explicit state here)."""

    sum: torch.Tensor  # [L, T_bins, window]
    frames: int

    @staticmethod
    def zeros(n_time_bins: int, n_listeners: int = 1,
              window_size: int = DEFAULT_WINDOW_SIZE,
              device=None) -> "LegacyIRState":
        return LegacyIRState(
            sum=torch.zeros((n_listeners, n_time_bins, window_size),
                            dtype=torch.float32, device=resolve(device)),
            frames=0)

    def normalized(self) -> torch.Tensor:
        return self.sum / self.sum.new_tensor(float(max(1, self.frames)))


def accumulate_legacy(state: LegacyIRState, hits: Hits, sample_rate: int,
                      muffle_scale: float = DEFAULT_MUFFLE_SCALE
                      ) -> LegacyIRState:
    ir = scatter_hits_legacy(hits, sample_rate, state.sum.shape[-2],
                             state.sum.shape[-1], muffle_scale)
    return LegacyIRState(sum=state.sum + ir, frames=state.frames + 1)


def legacy_ir_to_time_domain(spectro_ir: torch.Tensor, sample_rate: int,
                             ir_length: int,
                             window_size: int = DEFAULT_WINDOW_SIZE
                             ) -> torch.Tensor:
    """Render the legacy time x frequency IR back to a time-domain IR of
    ``ir_length`` samples for convolution: each time bin contributes a
    windowed burst whose spectrum follows its band energies (irfft of the
    per-bin band amplitudes, the role the never-dispatched legacy IFFT
    kernel was sketched for). Returns ``[L, ir_length]``."""
    l, t_bins, w = spectro_ir.shape
    dev = spectro_ir.device
    # irfft over the band axis: [L, T_bins, 2*(W-1)] time-domain bursts
    bursts = torch.fft.irfft(spectro_ir.to(torch.complex64), dim=-1)
    burst_len = bursts.shape[-1]
    # overlap-add bursts at their time-bin offsets
    offsets = torch.arange(t_bins, device=dev) * window_size
    idx = offsets[:, None] + torch.arange(burst_len, device=dev)[None, :]
    flat_idx = torch.clamp(idx, 0, ir_length + burst_len - 1).reshape(-1)
    n_out = ir_length + burst_len
    rows = flat_idx[None, :] + n_out * torch.arange(l, device=dev)[:, None]
    out = add_rows(l * n_out, rows.reshape(-1), bursts.reshape(-1))
    return out.reshape(l, n_out)[:, :ir_length]
