"""Convolution of dry audio with impulse responses (PyTorch, ``torch.fft``).

Port of ``realisticaudioraytracing2d_tpu/ops/convolve.py``. The reference
convolves directly, one thread per output sample
(``Assets/Script/AudioConvolve.compute:13-31``); here the production path
is FFT convolution (cuFFT on the card), with the direct form kept as the
oracle, including the reference's quirks:

* input samples with ``|x| <= eps`` (1e-4) are skipped
  (``AudioConvolve.compute:25``), behind ``gate_eps``;
* the output is ``InputLength + IRLength`` samples, one more than the
  true full-convolution length (the trailing sample is always 0);
* the IR is normalized by the Monte-Carlo frame count at convolution time
  (``AudioConvolve.compute:30``).

A banded IR ``[T, K]`` convolves each band of the dry signal with its
own band of the IR, the bands brickwall masks on the FFT's bins. Two
splits: JAX's K equal bands of [0, Nyquist] (:func:`band_filterbank`,
the default), and the port's log-spaced bands about the centres the air
absorption, the Maekawa factor and banded materials are computed at
(:func:`octave_filterbank`: octaves at K = 8), which the stream takes
through its ``band_split``.

The JAX package has no Pallas kernel here, so neither does the port.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .air import band_frequencies
from .geometry import EPS


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _count(accum_count) -> float:
    return float(max(1, int(accum_count)))


def _divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` with IEEE division on CUDA too: torch multiplies by
    the reciprocal when the divisor is a Python number."""
    return x / x.new_tensor(divisor)


def gate_input(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """The reference's ``|x| <= eps -> skip`` input gate."""
    return torch.where(x.abs() > eps, x, 0.0)


def convolve_direct(x: torch.Tensor, ir: torch.Tensor, accum_count=1,
                    gate_eps: Optional[float] = EPS) -> torch.Tensor:
    """Direct full convolution, the reference-parity oracle:
    ``out[n] = sum_k x[k] * ir[n-k] / accum_count`` with output length
    ``len(x) + len(ir)``. Computed in float64 (no TF32 or FFT rounding can
    reach it) and returned as float32."""
    if gate_eps is not None:
        x = gate_input(x, gate_eps)
    m = ir.shape[-1]
    full = F.conv1d(x.double()[None, None], ir.double().flip(-1)[None, None],
                    padding=m - 1)[0, 0]                     # length N+M-1
    full = F.pad(full, (0, 1))                               # reference N+M
    return _divide(full, _count(accum_count)).float()


def _fft_conv(x: torch.Tensor, ir: torch.Tensor, out_length: int
              ) -> torch.Tensor:
    n_fft = _next_pow2(out_length)
    X = torch.fft.rfft(x, n_fft)
    H = torch.fft.rfft(ir, n_fft)
    return torch.fft.irfft(X * H, n_fft)[..., :out_length]


def convolve_fft(x: torch.Tensor, ir: torch.Tensor, accum_count=1,
                 gate_eps: Optional[float] = EPS) -> torch.Tensor:
    """FFT full convolution, equivalent to :func:`convolve_direct` (same
    length, gating and normalization)."""
    if gate_eps is not None:
        x = gate_input(x, gate_eps)
    y = _fft_conv(x, ir, x.shape[-1] + ir.shape[-1])
    return _divide(y, _count(accum_count))


def convolve_chunk_crossfade(chunk: torch.Tensor, ir_prev: torch.Tensor,
                             ir_cur: torch.Tensor, accum_prev=1,
                             accum_cur=1,
                             gate_eps: Optional[float] = EPS
                             ) -> torch.Tensor:
    """Convolve one chunk against two successive IRs ``[M]`` (one input
    FFT) and crossfade linearly from the previous to the current across
    the chunk; the reverb tail uses the current IR only."""
    if gate_eps is not None:
        chunk = gate_input(chunk, gate_eps)
    n = chunk.shape[-1]
    out_length = n + ir_prev.shape[-1]
    irs = torch.stack([ir_prev, ir_cur])                       # [2, M]
    accs = torch.tensor([_count(accum_prev), _count(accum_cur)],
                        dtype=torch.float32, device=chunk.device)
    ys = _fft_conv(chunk[None, :], irs, out_length) / accs[:, None]
    ramp = torch.clamp(_divide(torch.arange(out_length, dtype=torch.float32,
                                            device=chunk.device),
                               float(max(1, n))), max=1.0)
    return ys[0] * (1.0 - ramp) + ys[1] * ramp


def peak_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Peak normalization as in the legacy offline bake's ``PlayResult``
    (``RayTraceManagerComplex.cs:228-245``)."""
    return x / torch.clamp(x.abs().max(), min=eps)


def downmix_mono(x: torch.Tensor) -> torch.Tensor:
    """Average [samples, channels] audio to mono
    (``RayTraceManager.cs:141-147``)."""
    return x if x.ndim == 1 else x.mean(dim=-1)


def resample_linear(x: torch.Tensor, src_rate: int, dst_rate: int
                    ) -> torch.Tensor:
    """Linear-interpolation resampling, as the reference
    (``RayTraceManager.cs:149-166``): ``ratio = src/dst``,
    ``newLength = round(N / ratio)``, sample i reads ``lerp(x[floor(s)],
    x[min(floor(s)+1, N-1)], frac(s))`` at ``s = i * ratio``."""
    if src_rate == dst_rate:
        return x
    n = x.shape[-1]
    ratio = src_rate / dst_rate
    new_length = int(round(n / ratio))
    src_idx = torch.arange(new_length, dtype=torch.float32,
                           device=x.device) * ratio
    i0 = torch.floor(src_idx).long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    t = src_idx - i0.to(torch.float32)
    return x[..., i0] * (1.0 - t) + x[..., i1] * t


def load_samples(x: torch.Tensor, src_rate: int, dst_rate: int
                 ) -> torch.Tensor:
    """Full ``LoadSample`` pipeline: mono downmix then linear resample."""
    return resample_linear(downmix_mono(x), src_rate, dst_rate)


def band_filterbank(n_samples: int, n_bands: int, n_fft: int
                    ) -> torch.Tensor:
    """Brickwall rfft-domain masks splitting [0, nyquist] into ``n_bands``
    equal bands. Returns [n_bands, n_fft//2 + 1] float32 on the CPU
    (:func:`_band_masks` keeps it on the callers' device). ``n_samples``
    does not enter the masks; it stays for JAX's signature."""
    n_bins = n_fft // 2 + 1
    band_of_bin = torch.clamp((torch.arange(n_bins) * n_bands) // n_bins,
                              max=n_bands - 1)
    return (band_of_bin[None, :] ==
            torch.arange(n_bands)[:, None]).to(torch.float32)


def octave_filterbank(n_bands: int, n_fft: int, sample_rate: int
                      ) -> torch.Tensor:
    """Brickwall rfft-domain masks of the log-spaced bands whose centres
    are :func:`..air.band_frequencies` (the frequencies the air
    absorption, the Maekawa factor and banded materials are computed at):
    band k holds the bins whose frequency ``j * sample_rate / n_fft`` lies
    from the geometric midpoint below its centre up to (not including) the
    one above it, ``f_k 2^(-1/2) .. f_k 2^(1/2)`` for the octave centres
    125 Hz - 16 kHz at K = 8. Band 0 starts at 0 Hz and band K - 1 ends at
    Nyquist, so every bin lies in exactly one band (a band above Nyquist
    holds none). Returns [n_bands, n_fft//2 + 1] float32 on the CPU."""
    centres = band_frequencies(n_bands)
    edges = np.sqrt(centres[:-1] * centres[1:])              # [K - 1] Hz
    freqs = np.arange(n_fft // 2 + 1) * (float(sample_rate) / n_fft)
    band_of_bin = torch.as_tensor(np.searchsorted(edges, freqs,
                                                  side="right"))
    return (band_of_bin[None, :] ==
            torch.arange(n_bands)[:, None]).to(torch.float32)


# The band splits of a banded convolution: "linear", K equal bands of
# [0, Nyquist] (the JAX package's, the default), and "octave", bands
# around the centres the banded physics is computed at
# (:func:`octave_filterbank`).
BAND_SPLITS = ("linear", "octave")


@functools.lru_cache(maxsize=64)
def _band_masks(n_bands: int, n_fft: int, device: torch.device
                ) -> torch.Tensor:
    """:func:`band_filterbank` ``[K, F]`` on ``device``, made once per
    ``(K, n_fft, device)``: a copy to the card per banded call would wait
    for the device. Callers read it and never write it."""
    return band_filterbank(0, n_bands, n_fft).to(device)


@functools.lru_cache(maxsize=64)
def _octave_masks(n_bands: int, n_fft: int, sample_rate: int,
                  device: torch.device) -> torch.Tensor:
    """:func:`octave_filterbank` ``[K, F]`` on ``device``, made once per
    ``(K, n_fft, sample_rate, device)``, as :func:`_band_masks`."""
    return octave_filterbank(n_bands, n_fft, sample_rate).to(device)


def split_masks(n_bands: int, n_fft: int, device: torch.device,
                split: str = "linear",
                sample_rate: Optional[int] = None) -> torch.Tensor:
    """The cached ``[K, F]`` masks of band split ``split``
    (:data:`BAND_SPLITS`); the octave split needs the ``sample_rate`` its
    bins are at. Any other split raises."""
    if split == "linear":
        return _band_masks(n_bands, n_fft, device)
    if split != "octave":
        raise ValueError(f"band split must be one of {BAND_SPLITS}, got "
                         f"{split!r}")
    if sample_rate is None:
        raise ValueError("the octave band split needs the sample rate")
    return _octave_masks(n_bands, n_fft, int(sample_rate), device)


def combined_transfer(ir: torch.Tensor, n_fft: int, split: str = "linear",
                      sample_rate: Optional[int] = None) -> torch.Tensor:
    """Collapse a banded IR ``[..., T, K]`` into one rfft-domain transfer
    function ``[..., F]``: ``H = sum_k mask_k * rfft(ir[..., k])`` (the band
    masks of ``split``, :func:`split_masks`, partition the spectrum). For
    K == 1 this is ``rfft(ir)`` whatever the split."""
    k = ir.shape[-1]
    h = torch.fft.rfft(ir.movedim(-1, -2), n_fft)            # [..., K, F]
    if k == 1:
        return h[..., 0, :]
    return (h * split_masks(k, n_fft, ir.device, split, sample_rate)
            ).sum(dim=-2)


def convolve_banded(x: torch.Tensor, ir_banded: torch.Tensor,
                    accum_count=1, gate_eps: Optional[float] = EPS
                    ) -> torch.Tensor:
    """Wet audio ``[N+T]`` from a banded IR ``[T, K]``: split the dry
    signal into K frequency bands (the zero-phase brickwall filterbank of
    :func:`band_filterbank`), convolve band k with IR band k, and sum.
    The JAX package's ``convolve_banded``: its operations in its order
    (K band-limited inverse FFTs, summed), where :func:`apply_ir` sums the
    masked transfer functions first."""
    if gate_eps is not None:
        x = gate_input(x, gate_eps)
    t_ir, k = ir_banded.shape
    out_length = x.shape[-1] + t_ir
    n_fft = _next_pow2(out_length)
    spec = torch.fft.rfft(x, n_fft)                          # [F]
    masks = _band_masks(k, n_fft, x.device)                  # [K, F]
    h = torch.fft.rfft(ir_banded.T, n_fft)                   # [K, F]
    y = torch.fft.irfft(spec[None, :] * masks * h, n_fft)    # [K, n_fft]
    y = torch.sum(y, dim=0)[:out_length]
    return _divide(y, _count(accum_count))


def apply_ir(x: torch.Tensor, ir: torch.Tensor, accum_count=1,
             gate_eps: Optional[float] = EPS) -> torch.Tensor:
    """Convolve mono input ``x[N]`` with an IR of shape ``[T]``, ``[T, K]``
    or ``[L, T, K]``. Returns wet audio ``[N+T]`` or ``[L, N+T]``."""
    if gate_eps is not None:
        x = gate_input(x, gate_eps)
    squeeze = ir.ndim == 1
    if squeeze:
        ir = ir[:, None]
    out_length = x.shape[-1] + ir.shape[-2]
    n_fft = _next_pow2(out_length)
    h = combined_transfer(ir, n_fft)                         # [..., F]
    y = torch.fft.irfft(torch.fft.rfft(x, n_fft) * h, n_fft)[..., :out_length]
    y = _divide(y, _count(accum_count))
    return y[0] if (squeeze and y.ndim > 1) else y
