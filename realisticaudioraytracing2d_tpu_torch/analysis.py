"""Room-acoustics metrics from traced impulse responses (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/analysis.py``: the ISO 3382
room parameters the reference never computed (its only "metrics" are
the waveform raster and commented-out energy printouts,
``RayTraceManagerComplex.cs:214-224``):

* **EDC**, the Schroeder backward-integrated energy-decay curve;
* **RT60** (via T20/T30) and **EDT**, from a least-squares line on the
  dB decay;
* **C50/C80 clarity**, **D50 definition**, **centre time**;
* **IACC**, the interaural cross-correlation of two ear IRs;
* the **direct arrival** (first-arrival time and path length).

The trace deposits energy per bin (``Raytrace2D.compute:164``), so the
IRs are energy-time curves already and the EDC is a plain reversed
cumulative sum, with no squaring.

Every function takes tensors ``[..., T]`` (time last) on any device and
keeps the leading axes; :func:`analyze_ir` and :func:`analyze_dataset`
wrap them for the ``[L, T, K]`` and ``[N, L, T, K]`` layouts and return
dicts of numpy arrays, as the JAX module does. Divisions by a sample
rate divide by a tensor and ``-60 / slope`` divides the tensor into a
tensor of -60, since torch multiplies by the reciprocal for a Python
number (ROADMAP section 3, division by a host scalar); the JAX module
runs eagerly, so it divides.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import resolve

# Energy floor for dB conversions: well under any real deposit but large
# enough to keep log10 finite on empty tails.
_EDC_FLOOR = 1e-30


def _seconds(n: int, sample_rate: int, like: torch.Tensor) -> torch.Tensor:
    """``arange(n) / sample_rate`` in float32, a true division."""
    t = torch.arange(n, dtype=torch.float32, device=like.device)
    return t / t.new_tensor(float(sample_rate))


def schroeder_edc(ir: torch.Tensor) -> torch.Tensor:
    """Schroeder energy-decay curve of an energy IR ``[..., T]``:
    ``edc[t] = sum_{u >= t} ir[u]``."""
    return torch.flip(torch.cumsum(torch.flip(ir, [-1]), -1), [-1])


def edc_db(ir: torch.Tensor) -> torch.Tensor:
    """EDC normalized to its initial value, in dB: 0 at t=0, falling. The
    normalized ratio is floored, so an underflowed tail gives a finite
    level and no NaN in :func:`_fit_decay_slope`."""
    edc = schroeder_edc(ir)
    total = torch.clamp(edc[..., :1], min=_EDC_FLOOR)
    return 10.0 * torch.log10(torch.clamp(edc / total, min=_EDC_FLOOR))


def _fit_decay_slope(db: torch.Tensor, sample_rate: int,
                     db_start: float, db_end: float) -> torch.Tensor:
    """Weighted least-squares slope (dB/s) of the dB EDC ``[..., T]``
    between two levels, through a 0/1 window mask. NaN where the window
    holds fewer than two samples."""
    t = _seconds(db.shape[-1], sample_rate, db)
    w = ((db <= db_start) & (db >= db_end)).to(torch.float32)
    # where(w, db, 0) rather than w * db: a -inf/nan outside the window
    # must not poison the masked sums.
    db = torch.where(w > 0, db, torch.zeros_like(db))
    n = torch.sum(w, dim=-1)
    sum_t = torch.sum(w * t, dim=-1)
    sum_y = torch.sum(w * db, dim=-1)
    sum_tt = torch.sum(w * t * t, dim=-1)
    sum_ty = torch.sum(w * t * db, dim=-1)
    denom = n * sum_tt - sum_t * sum_t
    slope = (n * sum_ty - sum_t * sum_y) / torch.where(
        denom > 0, denom, torch.ones_like(denom))
    return torch.where((n >= 2) & (denom > 0), slope,
                       torch.full_like(slope, float("nan")))


def decay_time(ir: torch.Tensor, sample_rate: int, db_start: float = -5.0,
               db_end: float = -25.0) -> torch.Tensor:
    """Reverberation time extrapolated to -60 dB from a line fit on the
    EDC between ``db_start`` and ``db_end`` (``(-5, -25)`` T20, ``(-5,
    -35)`` T30, ``(0, -10)`` EDT). NaN where the decay never spans the
    window, including a truncated IR whose ``db_end`` sits less than
    10 dB above the truncation floor ``10 log10(edc[-1] / edc[0])``."""
    db = edc_db(ir)
    slope = _fit_decay_slope(db, sample_rate, db_start, db_end)
    ok = (slope < 0) & (db_end >= db[..., -1] + 10.0)
    return torch.where(ok, torch.full_like(slope, -60.0) / slope,
                       torch.full_like(slope, float("nan")))


def rt60_t20(ir: torch.Tensor, sample_rate: int) -> torch.Tensor:
    return decay_time(ir, sample_rate, -5.0, -25.0)


def rt60_t30(ir: torch.Tensor, sample_rate: int) -> torch.Tensor:
    return decay_time(ir, sample_rate, -5.0, -35.0)


def early_decay_time(ir: torch.Tensor, sample_rate: int) -> torch.Tensor:
    return decay_time(ir, sample_rate, 0.0, -10.0)


def _early_late(ir: torch.Tensor, sample_rate: int, split_ms: float,
                ref_bin: torch.Tensor):
    """Early/late energy split at ``ref + split_ms``, measured from the
    direct arrival (ISO 3382)."""
    t = torch.arange(ir.shape[-1], device=ir.device)
    # int + Python float -> float32, as in JAX
    split = ref_bin[..., None] + split_ms * 1e-3 * sample_rate
    zero = torch.zeros_like(ir)
    early = torch.sum(torch.where(t < split, ir, zero), dim=-1)
    late = torch.sum(torch.where(t >= split, ir, zero), dim=-1)
    return early, late


def clarity(ir: torch.Tensor, sample_rate: int,
            split_ms: float = 80.0) -> torch.Tensor:
    """C80 (``split_ms=80``) / C50 (``=50``): ``10 log10(early/late)`` dB
    around a split measured from the direct arrival."""
    early, late = _early_late(ir, sample_rate, split_ms,
                              direct_arrival_bin(ir))
    return 10.0 * torch.log10(torch.clamp(early, min=_EDC_FLOOR)
                              / torch.clamp(late, min=_EDC_FLOOR))


def definition(ir: torch.Tensor, sample_rate: int,
               split_ms: float = 50.0) -> torch.Tensor:
    """D50: the fraction of the energy arriving within ``split_ms`` of the
    direct sound, in [0, 1]."""
    early, late = _early_late(ir, sample_rate, split_ms,
                              direct_arrival_bin(ir))
    return early / torch.clamp(early + late, min=_EDC_FLOOR)


def centre_time(ir: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """Energy centroid time ``sum(t E) / sum(E)`` in seconds."""
    t = _seconds(ir.shape[-1], sample_rate, ir)
    total = torch.clamp(torch.sum(ir, dim=-1), min=_EDC_FLOOR)
    return torch.sum(ir * t, dim=-1) / total


def iacc(left: torch.Tensor, right: torch.Tensor, sample_rate: int, *,
         max_lag_ms: float = 1.0, t_start_s: float = 0.0,
         t_end_s: float | None = None) -> torch.Tensor:
    """Interaural cross-correlation coefficient (ISO 3382-1 Annex B):
    ``max_tau |sum l(t) r(t + tau)| / sqrt(E_l E_r)`` over lags ``|tau|
    <= max_lag_ms`` on the ``[t_start_s, t_end_s)`` span of two ear IRs
    ``[..., T]``. 1 is interaurally coherent, towards 0 decorrelated (a
    real diffuse late field; ``t_start_s ~ 80 ms`` gives IACC_L)."""
    lo = int(round(t_start_s * sample_rate))
    hi = left.shape[-1] if t_end_s is None else int(round(
        t_end_s * sample_rate))
    seg_l = left[..., lo:hi]
    seg_r = right[..., lo:hi]
    max_lag = max(1, int(round(max_lag_ms * 1e-3 * sample_rate)))
    energy = torch.sqrt(torch.sum(seg_l * seg_l, dim=-1)
                        * torch.sum(seg_r * seg_r, dim=-1))
    pad = torch.nn.functional.pad(seg_r, (max_lag, max_lag))
    n = seg_l.shape[-1]
    corrs = torch.stack(
        [torch.abs(torch.sum(seg_l * pad[..., k:k + n], dim=-1))
         for k in range(2 * max_lag + 1)], dim=-1)
    return torch.amax(corrs, dim=-1) / torch.clamp(energy, min=_EDC_FLOOR)


def direct_arrival_bin(ir: torch.Tensor,
                       threshold: float = 1e-2) -> torch.Tensor:
    """Bin of the first arrival: the first bin holding at least
    ``threshold`` of the peak bin's energy (0 where none does)."""
    peak = torch.amax(ir, dim=-1, keepdim=True)
    above = ir >= threshold * torch.clamp(peak, min=_EDC_FLOOR)
    # argmax returns the first of equal maxima
    return torch.argmax(above.to(torch.uint8), dim=-1)


def direct_arrival_time(ir: torch.Tensor, sample_rate: int,
                        threshold: float = 1e-2) -> torch.Tensor:
    b = direct_arrival_bin(ir, threshold).to(torch.float32)
    return b / b.new_tensor(float(sample_rate))


def _as_tensor(x, device) -> torch.Tensor:
    """A tensor keeps its device; anything else goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve(device))


def analyze_ir(ir, sample_rate: int, speed_of_sound: float = 343.0,
               device=None) -> Dict[str, np.ndarray]:
    """All metrics of an IR ``[T]``, ``[T, K]`` or ``[L, T, K]`` (the
    :class:`IRState` layout): a dict of numpy arrays shaped ``[]``,
    ``[K]`` or ``[L, K]``. A tensor is analysed on its device, an array
    on ``device``. ``direct_distance_m`` is the path length of the first
    arrival at ``speed_of_sound``."""
    x = _as_tensor(ir, device)
    nd = x.dim()
    if nd == 1:
        x = x[None, :, None]
    elif nd == 2:
        x = x[None]
    if x.dim() != 3:
        raise ValueError(f"expected [T] / [T,K] / [L,T,K], got "
                         f"{tuple(x.shape)}")
    out = _metrics(torch.movedim(x, 1, -1), sample_rate, speed_of_sound)
    result = {}
    for k, v in out.items():
        a = v.detach().cpu().numpy()
        if nd == 1:
            a = a[0, 0]
        elif nd == 2:
            a = a[0]
        result[k] = a
    return result


def analyze_dataset(irs, sample_rate: int, speed_of_sound: float = 343.0,
                    device=None) -> Dict[str, np.ndarray]:
    """Metrics of an IR dataset ``[n_rooms, L, T, K]`` (the sweep's
    layout) in one batched pass: ``[n_rooms, L, K]`` arrays under the keys
    of :func:`analyze_ir`."""
    x = torch.movedim(_as_tensor(irs, device), 2, -1)        # [N, L, K, T]
    return {k: v.detach().cpu().numpy()
            for k, v in _metrics(x, sample_rate, speed_of_sound).items()}


def _metrics(x: torch.Tensor, sample_rate: int,
             speed_of_sound: float) -> Dict[str, torch.Tensor]:
    """All metrics of ``x`` ``[..., T]``, keeping the leading axes."""
    t_direct = direct_arrival_time(x, sample_rate)
    return {
        "rt60_t20_s": rt60_t20(x, sample_rate),
        "rt60_t30_s": rt60_t30(x, sample_rate),
        "edt_s": early_decay_time(x, sample_rate),
        "c50_db": clarity(x, sample_rate, 50.0),
        "c80_db": clarity(x, sample_rate, 80.0),
        "d50": definition(x, sample_rate, 50.0),
        "centre_time_s": centre_time(x, sample_rate),
        "direct_time_s": t_direct,
        "direct_distance_m": t_direct * speed_of_sound,
        "total_energy": torch.sum(x, dim=-1),
    }
