"""Atmospheric absorption (ISO 9613-1) for traced impulse responses.

Port of ``realisticaudioraytracing2d_tpu/ops/air.py``. The reference loses
energy only at walls and by spreading; this post-pass attenuates each IR
time bin by ``10^(-alpha * c * t / 10)`` (energy bins), which equals a
per-path attenuation because a hit's bin delay is its path time. It never
touches the trace, so it composes with every path and with accumulated
or checkpointed IRs.

* :func:`iso9613_alpha`: the pure-tone attenuation coefficient in dB/m
  (numpy, float64, as in the JAX package);
* :func:`band_frequencies`: log-spaced band centres for the scene's band
  axis;
* :func:`air_attenuation_curve` / :func:`apply_air_absorption`: the
  per-bin factors ``[T, K]`` and their product with an IR ``[..., T, K]``.

The JAX package reaches the curve in two ways, and XLA rounds them
differently: eagerly (``cli trace`` / ``bake``), where ``t / sample_rate``
and ``x / 10`` are true divisions, and inside the jitted ``stream_chunk``,
where ``sample_rate`` is a static number and XLA multiplies by the float32
reciprocals of ``sample_rate`` and 10, and reassociates ``(t * (1 / sr)) *
c`` into ``t * (c * (1 / sr))``. ``reciprocal=True`` is the second form;
each caller of the port picks the form its JAX counterpart uses. Either
matches the JAX curve to 1 ulp (the power function's last bit).
"""

from __future__ import annotations

import numpy as np
import torch

# ISO 9613-1 reference conditions.
_T0 = 293.15      # K (20 C)
_T01 = 273.16     # K (triple point)
_PR = 101.325     # kPa


def iso9613_alpha(freqs_hz, temperature_c: float = 20.0,
                  rel_humidity: float = 50.0,
                  pressure_kpa: float = _PR) -> np.ndarray:
    """Pure-tone atmospheric attenuation coefficient in dB/m (ISO 9613-1
    section 6.2: classical absorption plus the O2 and N2 vibrational
    relaxation terms). Intensity scales by ``10^(-alpha * d / 10)`` over
    a distance ``d``."""
    f = np.asarray(freqs_hz, np.float64)
    t = temperature_c + 273.15
    pa = pressure_kpa / _PR           # normalized pressure
    tr = t / _T0                      # normalized temperature
    # water-vapour molar concentration h (%)
    psat_over_pr = 10.0 ** (-6.8346 * (_T01 / t) ** 1.261 + 4.6151)
    h = rel_humidity * psat_over_pr / pa
    # relaxation frequencies of O2 and N2 (Hz)
    fr_o = pa * (24.0 + 4.04e4 * h * (0.02 + h) / (0.391 + h))
    fr_n = pa / np.sqrt(tr) * (
        9.0 + 280.0 * h * np.exp(-4.170 * (tr ** (-1.0 / 3.0) - 1.0)))
    return 8.686 * f * f * (
        1.84e-11 / pa * np.sqrt(tr)
        + tr ** (-2.5) * (
            0.01275 * np.exp(-2239.1 / t) / (fr_o + f * f / fr_o)
            + 0.1068 * np.exp(-3352.0 / t) / (fr_n + f * f / fr_n)))


def band_frequencies(n_bands: int, f_min: float = 125.0,
                     f_max: float = 16000.0) -> np.ndarray:
    """Log-spaced centre frequencies of the scene's band axis; a single
    band sits at the geometric mean (~1.4 kHz for the defaults)."""
    if n_bands == 1:
        return np.array([np.sqrt(f_min * f_max)])
    return np.geomspace(f_min, f_max, n_bands)


def air_attenuation_curve(ir_length: int, sample_rate: int, alpha_db_per_m,
                          speed_of_sound=343.0, *, reciprocal: bool = False,
                          device=None) -> torch.Tensor:
    """Per-bin energy attenuation factors ``[T, K]`` float32 on
    ``device`` (that of ``alpha_db_per_m`` if it is a tensor, else the
    CPU). ``reciprocal``: multiply by the float32 reciprocals of
    ``sample_rate`` and 10 as the jitted JAX stream step does; else divide
    (by tensors: on CUDA torch divides by a host number as a multiply by
    its reciprocal)."""
    if device is None:
        device = alpha_db_per_m.device if isinstance(
            alpha_db_per_m, torch.Tensor) else "cpu"
    alpha = torch.atleast_1d(torch.as_tensor(
        alpha_db_per_m, dtype=torch.float32, device=device))
    t = torch.arange(ir_length, dtype=torch.float32, device=device)
    c = torch.as_tensor(speed_of_sound, dtype=torch.float32, device=device)
    if reciprocal:   # XLA's order: t * (c * (1 / sr))
        dist = t * (c * t.new_tensor(np.float32(1.0)
                                     / np.float32(sample_rate)))
    else:
        dist = t / t.new_tensor(float(sample_rate)) * c            # [T]
    x = -dist[:, None] * alpha[None, :]
    x = x * x.new_tensor(np.float32(0.1)) if reciprocal \
        else x / x.new_tensor(10.0)
    return torch.pow(10.0, x)


def apply_air_absorption(ir: torch.Tensor, sample_rate: int, alpha_db_per_m,
                         speed_of_sound=343.0, *,
                         reciprocal: bool = False) -> torch.Tensor:
    """Attenuate an energy IR ``[..., T, K]`` by atmospheric absorption;
    ``alpha_db_per_m`` is a number or per-band ``[K]`` (e.g.
    :func:`iso9613_alpha` at :func:`band_frequencies`). Linear in the IR,
    so an accumulated sum and a normalized IR take it alike."""
    att = air_attenuation_curve(ir.shape[-2], sample_rate, alpha_db_per_m,
                                speed_of_sound, reciprocal=reciprocal,
                                device=ir.device)
    if att.shape[-1] not in (1, ir.shape[-1]):
        raise ValueError(f"alpha has {att.shape[-1]} bands, IR has "
                         f"{ir.shape[-1]}")
    return ir * att
