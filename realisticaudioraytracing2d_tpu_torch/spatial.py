"""Spatial impulse responses: per-bin 2D acoustic intensity (W/X/Y), and
the binaural decode built on them (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/spatial.py``. The reference
keeps only delay and energy per hit (``Raytrace2D.compute:74-84,
101-119``); this module records where the sound arrives from, as the 2D
analogue of a first-order Ambisonics / intensity measurement:

* ``W[t] = sum_h e_h`` (the ordinary omni IR),
* ``X[t] = sum_h e_h cos(theta_h)``, ``Y[t] = sum_h e_h sin(theta_h)``,

over the hits ``h`` of bin ``t`` arriving from ``theta_h``. Each listener
is traced as three coincident virtual microphones through the
per-listener ``mic_directivity`` table, omni ``g = 1``, cardioid at 0
``g = 1 + cos``, cardioid at pi/2 ``g = 1 + sin``, so ``X = C0 - W`` and
``Y = C90 - W`` hold per hit and hence per bin (``order=2`` adds ``1 +
cos 2theta`` and ``1 + sin 2theta`` for the second moments). On the card
the capture is a directive trace like any other: ``engine.
trace_accumulate`` routes it to K4 (a seed) or K3 (host uniforms) up to
5,280 walls, to K8 (one band) or K7 (bands) past them. Steering and the
analysis of the moments are plain tensor code, as in JAX, where they are
``jnp``; the decode is plain tensor code on the CPU and one hand-written
kernel on the card (JAX's is ``jnp`` too).

Two things the card changes, both stated where they happen:

* the kernels bin in u64 fixed point at a scale set by the loudest
  microphone gain (``ops/cuda/bounce_kernel.py::pattern_gain_bound``):
  2 for the cardioids, so the W row of a capture quantizes at twice the
  step of an omni trace's and is not the omni IR bit for bit there. The
  plain path's float scatter gives the per-hit identity exactly;
* the decode's two-bin splat collides (a shift of up to ``r / c * sr``
  bins), and float atomics would sum the collisions in any order. The
  plain decode (:func:`binaural_plain`, the CPU path) sends its deposits
  through ``ops/ir.py::add_rows`` in JAX's order, the ``lo`` deposits of
  an ear before its ``hi`` ones; on the card one kernel gathers each
  bin's deposits in that order (``ops/cuda/binaural_kernel.py``), so a
  rerun gives the same bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ops import ir as irm
from .ops.trace import TraceParams

#: Virtual-microphone rows (Fourier power-gain series ``[c0, c_cos,
#: c_sin]``): omni, cardioid aimed at 0, cardioid at pi/2.
_PATTERNS = ((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (1.0, 0.0, 1.0))

#: Order 2, ``[c0, cos, sin, cos2, sin2]``: the three above plus ``1 +
#: cos(2 theta)`` and ``1 + sin(2 theta)``, non-negative per hit.
_PATTERNS2 = ((1.0, 0.0, 0.0, 0.0, 0.0),
              (1.0, 1.0, 0.0, 0.0, 0.0),
              (1.0, 0.0, 1.0, 0.0, 0.0),
              (1.0, 0.0, 0.0, 1.0, 0.0),
              (1.0, 0.0, 0.0, 0.0, 1.0))


def _ear_signs(n_t: int, ear_seed: int) -> np.ndarray:
    """The deterministic per-bin random signs ``[T]`` (float32 +-1) of
    one ear's diffuse-stream decorrelator: random-phase re-synthesis of
    the late field, whose per-bin magnitude stays as it is. The same
    numpy generator and seed as the JAX module, so the same signs."""
    rng = np.random.default_rng(0xD1FF05E ^ (ear_seed * 0x9E3779B9))
    return (rng.integers(0, 2, n_t) * 2.0 - 1.0).astype(np.float32)


_SIGNS = {}


def _ear_signs_tensor(n_t: int, ear_seed: int,
                      device: torch.device) -> torch.Tensor:
    """:func:`_ear_signs` as a ``[1, T, 1]`` tensor on ``device``, made
    once per (T, ear, device): JAX bakes the signs into the compiled step
    as a constant, and a copy to the card per chunk would add a transfer
    to a stream that is host-bound already."""
    key = (n_t, ear_seed, str(device))
    if key not in _SIGNS:
        _SIGNS[key] = torch.from_numpy(_ear_signs(n_t, ear_seed)).to(
            device)[None, :, None]
    return _SIGNS[key]


def _steer_min(a: float, b: float, c: float) -> float:
    """Exact minimum of ``a + b cos(u) + c cos(2u)`` over ``u``: with ``t =
    cos(u)``, ``f(t) = a - c + b t + 2 c t^2`` on ``[-1, 1]``, the least of
    the endpoints and the stationary point ``t* = -b / (4c)``."""
    cands = [a + b + c, a - b + c]
    if c != 0.0:
        t = -b / (4.0 * c)
        if -1.0 <= t <= 1.0:
            cands.append(a - c + b * t + 2.0 * c * t * t)
    return min(cands)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SpatialIR(NamedTuple):
    """Per-bin spatial energy IR; every channel ``[L, T, K]``. ``x2`` and
    ``y2`` (second circular moments) exist for an ``order=2`` capture."""

    w: torch.Tensor  # omni energy (the ordinary IR)
    x: torch.Tensor  # energy-weighted sum of cos(arrival angle)
    y: torch.Tensor  # energy-weighted sum of sin(arrival angle)
    x2: Optional[torch.Tensor] = None  # sum of e cos(2 angle) (order 2)
    y2: Optional[torch.Tensor] = None  # sum of e sin(2 angle) (order 2)

    @property
    def order(self) -> int:
        return 2 if self.x2 is not None else 1

    @property
    def n_listeners(self) -> int:
        return self.w.shape[0]

    def steer(self, aim, b: float = 1.0, a: float = 1.0,
              c: float = 0.0) -> torch.Tensor:
        """IR ``[L, T, K]`` of a virtual mic ``g = a + b cos(theta - aim)
        + c cos(2 (theta - aim))`` at the same positions: exactly a
        retrace with that pattern while it is non-negative per hit
        (a pattern that dips below zero raises). ``c != 0`` needs an
        ``order=2`` capture."""
        if _steer_min(a, b, c) < -1e-6 * max(abs(a), abs(b), abs(c), 1.0):
            raise ValueError(
                f"invalid power pattern (a={a}, b={b}, c={c}): "
                f"g = a + b cos + c cos2 goes negative per hit")
        if c and self.x2 is None:
            raise ValueError("second-harmonic steering (c != 0) needs an "
                             "order=2 capture: spatial_params(order=2)")
        aim = torch.as_tensor(aim, dtype=torch.float32, device=self.w.device)
        out = a * self.w + b * (torch.cos(aim) * self.x
                                + torch.sin(aim) * self.y)
        if c:
            out = out + c * (torch.cos(2.0 * aim) * self.x2
                             + torch.sin(2.0 * aim) * self.y2)
        return out

    def stereo(self, aim=0.0, spread: float = math.pi / 2
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(left, right) cardioid-pair IRs aimed ``aim +- spread/2``: the
        XY pair of the CLI's ``--stereo-aim``, steered after the trace."""
        half = spread / 2.0
        return self.steer(aim + half), self.steer(aim - half)

    def binaural(self, sample_rate: int, facing=0.0,
                 head_radius: float = 0.0875, shadow: float = 0.6,
                 speed_of_sound=343.0, decorrelate: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(left, right) ear IRs ``[L, T, K]`` with interaural time and
        level differences, a DirAC-style decode of the intensity IR.

        Each bin's coherent part ``|(X, Y)|`` (at most ``W``) arrives from
        ``atan2(Y, X)``; at the ear at ``facing +- pi/2`` (left ``+``) it
        gets the plane-wave delay ``-+ (r / c) sin(phi)`` as a fractional
        two-bin splat and the head-shadow gain ``1 +- shadow sin(phi)``
        (``phi`` the bearing relative to ``facing``; the target bin is
        clamped to the IR before the fraction is taken). The diffuse rest
        ``W - coherent`` reaches each ear whole, through the ear's random
        signs (:func:`_ear_signs`) unless ``decorrelate`` is off or the
        head is degenerate (``head_radius == 0 and shadow == 0``: both
        ears are then ``W``).

        ``facing`` is radians, a number or a 0-d tensor. ``speed_of_sound``
        as a 0-d float32 tensor gives ``max_shift = r / c * sample_rate``
        in float32 operations, as the JAX stream step computes it on its
        traced ``params.speed_of_sound``; as a number, in Python floats,
        as the JAX CLI's eager bake does.

        On the card: one launch of the decode kernel
        (``ops/cuda/binaural_kernel.py::binaural_decode``); on the CPU the
        plain chain, :func:`binaural_plain`."""
        from .ops.cuda.binaural_kernel import binaural_decode
        ears = binaural_decode(self, sample_rate, facing, head_radius,
                               shadow, speed_of_sound, decorrelate)
        n_l = self.w.shape[0]
        return ears[:n_l], ears[n_l:]

    def arrival_angle(self) -> torch.Tensor:
        """Dominant arrival bearing per bin, ``atan2(Y, X)``, ``[L, T,
        K]``; meaningful where the bin holds energy and
        :meth:`diffuseness` is low."""
        return torch.atan2(self.y, self.x)

    def diffuseness(self) -> torch.Tensor:
        """``1 - |(X, Y)| / W`` per bin in [0, 1] (1 where the bin is
        empty), ``[L, T, K]``."""
        r = torch.sqrt(self.x * self.x + self.y * self.y)
        lit = self.w > 0.0
        psi = 1.0 - r / torch.where(lit, self.w, torch.ones_like(self.w))
        return torch.clamp(torch.where(lit, psi, torch.ones_like(psi)),
                           0.0, 1.0)


def spatial_params(params: TraceParams, order: int = 1) -> TraceParams:
    """Expand each of the ``L`` listeners of ``params`` into the
    coincident virtual microphones of the moment capture, pattern-major
    (rows ``[0, L)`` omni, ``[L, 2L)`` cardioid 0, ``[2L, 3L)`` cardioid
    90, then for ``order=2`` the two second-harmonic rows): listeners
    ``[3L or 5L, 2]`` and the ``mic_directivity`` table ``[3L or 5L, 3 or
    5]``. Raises if ``params`` already has a microphone pattern."""
    if params.mic_directivity is not None:
        raise ValueError("spatial capture replaces mic_directivity; "
                         "steer the SpatialIR afterwards instead")
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    pats = _PATTERNS if order == 1 else _PATTERNS2
    listeners = params.listeners                       # [L, 2]
    table = torch.tensor(pats, dtype=torch.float32,
                         device=listeners.device).repeat_interleave(
                             listeners.shape[0], dim=0)
    return params._replace(listeners=listeners.repeat(len(pats), 1),
                           mic_directivity=table)


def binaural_trace_params(params: TraceParams,
                          n_channels: int) -> TraceParams:
    """Check and expand for the binaural chunk step: ``params`` carries
    ONE listener (the head), the stream state ``n_channels == 2`` ear
    channels; returns the three-microphone :func:`spatial_params`."""
    if params.listeners.shape[0] != 1 or n_channels != 2:
        raise ValueError("binaural chunk step: params carry the one "
                         "head listener and the stream state two ear "
                         "channels (n_listeners=2)")
    return spatial_params(params)


def _decorrelated(decorrelate: bool, head_radius: float,
                  shadow: float) -> bool:
    """Whether the diffuse stream goes through the ear signs: not for a
    degenerate head, whose ears are both ``W``."""
    return decorrelate and not (head_radius == 0.0 and shadow == 0.0)


def binaural_entries(sp: SpatialIR, sample_rate: int, facing=0.0,
                     head_radius: float = 0.0875, shadow: float = 0.6,
                     speed_of_sound=343.0):
    """The splat of :func:`binaural_plain`: ``(rows [4 L T K] int64,
    values [4 L T K] float32, diffuse [L, T, K])``. The entries run ear 0's
    ``lo`` deposits, ear 0's ``hi`` ones, then ear 1's, each flat over
    ``(l, t, k)``; a row indexes the flat ``[2, L, T, K]`` two-ear IR."""
    if not 0.0 <= shadow <= 1.0:
        raise ValueError(f"shadow must be in [0, 1], got {shadow}")
    r = torch.sqrt(sp.x * sp.x + sp.y * sp.y)       # coherent
    coh = torch.minimum(r, sp.w)
    diffuse = sp.w - coh                            # per ear, full
    s = torch.sin(torch.atan2(sp.y, sp.x) - facing)
    n_l, n_t, n_k = sp.w.shape
    dev = sp.w.device
    bins = torch.arange(n_t, dtype=torch.float32, device=dev)[None, :, None]
    if isinstance(speed_of_sound, torch.Tensor):
        max_shift = (torch.full_like(speed_of_sound, head_radius)
                     / speed_of_sound) * float(sample_rate)
    else:
        max_shift = head_radius / speed_of_sound * sample_rate
    # flat row of (l, t, k); the two ears stacked ear-major
    lk = (torch.arange(n_l, device=dev)[:, None, None] * n_t * n_k
          + torch.arange(n_k, device=dev)[None, None, :])
    rows, values = [], []
    for ear, sign in enumerate((1.0, -1.0)):
        # sign = +1 left ear, -1 right ear
        gain = 1.0 + sign * shadow * s
        # clamp BEFORE the fraction: an unclamped t < 0 would give
        # (1 - frac) > 1 and frac < 0
        t = torch.clamp(bins - sign * max_shift * s, 0.0, float(n_t - 1))
        lo_f = torch.floor(t)
        frac = t - lo_f
        lo = lo_f.to(torch.int64)
        hi = torch.clamp(lo + 1, max=n_t - 1)
        e = coh * gain
        off = ear * n_l * n_t * n_k
        rows += [(lo * n_k + lk + off).reshape(-1),
                 (hi * n_k + lk + off).reshape(-1)]
        values += [(e * (1.0 - frac)).reshape(-1),
                   (e * frac).reshape(-1)]
    return torch.cat(rows), torch.cat(values), diffuse


def binaural_ears(deposits: torch.Tensor, diffuse: torch.Tensor,
                  decorr: bool) -> torch.Tensor:
    """The two-ear IR ``[2L, T, K]`` from the summed splat ``deposits``
    (``2 L T K`` values, the rows of :func:`binaural_entries`) and the
    diffuse rest, through each ear's signs where ``decorr``."""
    n_l, n_t, n_k = diffuse.shape
    ears = deposits.reshape(2, n_l, n_t, n_k)
    out = []
    for ear in range(2):
        if decorr:
            out.append(ears[ear] + diffuse
                       * _ear_signs_tensor(n_t, ear, diffuse.device))
        else:
            out.append(ears[ear] + diffuse)
    return torch.cat(out, dim=0)


def binaural_plain(sp: SpatialIR, sample_rate: int, facing=0.0,
                   head_radius: float = 0.0875, shadow: float = 0.6,
                   speed_of_sound=343.0, decorrelate: bool = True
                   ) -> torch.Tensor:
    """The plain decode of :meth:`SpatialIR.binaural`, ``[2L, T, K]``
    (left ear first): the PyTorch chain of :func:`binaural_entries`, the
    splat through ``ops/ir.py::add_rows`` in the entries' order (``lo``
    deposits of an ear before its ``hi`` ones: ``index_add_`` on the CPU,
    the deterministic accumulate on the card), and :func:`binaural_ears`.
    The CPU path of the decode and the oracle of its kernel."""
    rows, values, diffuse = binaural_entries(sp, sample_rate, facing,
                                             head_radius, shadow,
                                             speed_of_sound)
    deposits = irm.add_rows(2 * diffuse.numel(), rows, values)
    return binaural_ears(deposits, diffuse,
                         _decorrelated(decorrelate, head_radius, shadow))


def binaural_decode_ir(cur_ir: torch.Tensor, sample_rate: int, facing,
                       head_radius: float, shadow: float, speed_of_sound,
                       decorrelate: bool = True) -> torch.Tensor:
    """Split a fresh ``[3, T, K]`` spatial IR and decode it to the two-ear
    ``[2, T, K]`` IR: the binaural chunk step. On the card one launch of
    the decode kernel, which takes the capture's rows as they lie
    (``ops/cuda/binaural_kernel.py``); on the CPU :func:`spatial_from_ir`
    and :func:`binaural_plain`."""
    from .ops.cuda.binaural_kernel import binaural_decode
    return binaural_decode(cur_ir, sample_rate, facing, head_radius, shadow,
                           speed_of_sound, decorrelate)


def spatial_from_ir(ir: torch.Tensor, order: int = 1) -> SpatialIR:
    """Split an IR traced under :func:`spatial_params`, ``[3L, T, K]`` or
    ``[5L, T, K]`` (normalized or a raw sum: the split is linear), into
    :class:`SpatialIR` channels ``[L, T, K]``."""
    n_pat = 3 if order == 1 else 5
    if ir.dim() != 3 or ir.shape[0] % n_pat != 0:
        raise ValueError(f"expected [{n_pat}L, T, K] from "
                         f"spatial_params(order={order}), got "
                         f"{tuple(ir.shape)}")
    n_l = ir.shape[0] // n_pat
    w = ir[:n_l]
    out = SpatialIR(w=w, x=ir[n_l:2 * n_l] - w, y=ir[2 * n_l:3 * n_l] - w)
    if order == 2:
        out = out._replace(x2=ir[3 * n_l:4 * n_l] - w,
                           y2=ir[4 * n_l:5 * n_l] - w)
    return out


def dominant_arrivals(sp_ir: SpatialIR, sample_rate: int, *,
                      listener: int = 0, band: int = 0, n: int = 5,
                      window_bins: int = 16, min_fraction: float = 0.02):
    """The strongest distinct arrivals of one listener and band, and where
    each came from (host numpy, as in JAX): take the most energetic bin,
    sum the intensity vector over ``+- window_bins``, zero that window in
    W, X and Y, repeat up to ``n`` times or until a peak is under
    ``min_fraction`` of the strongest. Dicts of ``time_s``,
    ``bearing_rad`` (world frame, where the sound comes FROM),
    ``diffuseness`` and ``energy``."""
    w = _numpy(sp_ir.w)[listener, :, band].copy()
    x = _numpy(sp_ir.x)[listener, :, band].copy()
    y = _numpy(sp_ir.y)[listener, :, band].copy()
    out = []
    floor = float(w.max()) * min_fraction
    for _ in range(n):
        peak = int(w.argmax())
        if w[peak] <= max(floor, 0.0):
            break
        lo, hi = max(0, peak - window_bins), peak + window_bins + 1
        ew, ex, ey = w[lo:hi].sum(), x[lo:hi].sum(), y[lo:hi].sum()
        out.append({
            "time_s": peak / sample_rate,
            "bearing_rad": float(math.atan2(ey, ex)),
            "diffuseness": float(1.0 - min(1.0, math.hypot(ex, ey) /
                                           max(ew, 1e-30))),
            "energy": float(ew),
        })
        w[lo:hi] = 0.0
        x[lo:hi] = 0.0
        y[lo:hi] = 0.0
    return out


def onset_bearing(sp_ir: SpatialIR, time_s: float, sample_rate: int, *,
                  listener: int = 0, band: int = 0, onset_bins: int = 4,
                  background_bins: int = 8, guard_bins: int = 2) -> float:
    """Bearing (radians) of the arrival whose energy onset is at
    ``time_s``, with the pre-arrival field subtracted: the mean intensity
    vector over ``background_bins`` bins ending ``guard_bins`` before the
    onset, scaled to ``onset_bins``, comes off the onset's sum (host
    numpy). Pass the rim-corrected onset ``(d - r) / c`` for a listener
    disc of radius ``r``, and keep ``onset_bins`` short."""
    x = _numpy(sp_ir.x)[listener, :, band]
    y = _numpy(sp_ir.y)[listener, :, band]
    t0 = int(round(time_s * sample_rate))
    lo = max(0, t0 - guard_bins - background_bins)
    hi = max(0, t0 - guard_bins)
    n_bg = max(1, hi - lo)
    bg_x = x[lo:hi].sum() / n_bg
    bg_y = y[lo:hi].sum() / n_bg
    vx = x[t0:t0 + onset_bins].sum() - onset_bins * bg_x
    vy = y[t0:t0 + onset_bins].sum() - onset_bins * bg_y
    return float(math.atan2(vy, vx))


def trace_spatial(scene, params: TraceParams, seed: int = 0, *,
                  n_rays: int, max_bounces: int, sample_rate: int,
                  ir_length: int, n_frames: int = 1,
                  state: Optional[irm.IRState] = None, order: int = 1,
                  uniforms=None, backend: str = "auto"
                  ) -> Tuple[SpatialIR, irm.IRState]:
    """Accumulate ``n_frames`` frames of the virtual-microphone capture
    (3 microphones, 5 with ``order=2``) through
    :func:`..engine.trace_accumulate` (``seed``, ``uniforms`` and
    ``backend`` as it takes them) and split the frame average. Returns
    ``(SpatialIR, IRState)``; pass the state back as ``state=`` to
    accumulate more frames."""
    from .engine import trace_accumulate
    sp = spatial_params(params, order=order)
    if state is None:
        state = irm.IRState.zeros(ir_length, sp.listeners.shape[0],
                                  scene.n_bands, device=scene.device)
    state = trace_accumulate(scene, sp, state, n_rays=n_rays,
                             max_bounces=max_bounces,
                             sample_rate=sample_rate, n_frames=n_frames,
                             seed=seed, uniforms=uniforms, backend=backend)
    return spatial_from_ir(state.normalized(), order=order), state


def two_arrival_bearings(sp_ir: SpatialIR, lo_bin: int, hi_bin: int, *,
                         listener: int = 0, band: int = 0,
                         grid: int = 360, refine: int = 3):
    """Two simultaneous arrivals in one window ``[lo_bin, hi_bin)`` from
    the circular moments of an ``order=2`` capture (host numpy, as in
    JAX): the moments ``m0 = e1 + e2``, ``m1 = e1 u(t1) + e2 u(t2)``,
    ``m2 = e1 u(2 t1) + e2 u(2 t2)`` fitted by separable least squares,
    a bearing grid, then ``refine`` local passes. Returns
    ``[(bearing_rad, energy), (bearing_rad, energy)]``, the stronger
    first."""
    if sp_ir.x2 is None:
        raise ValueError("two_arrival_bearings needs an order=2 capture")
    sl = (listener, slice(lo_bin, hi_bin), band)
    m0 = float(_numpy(sp_ir.w)[sl].sum())
    m1 = np.array([_numpy(sp_ir.x)[sl].sum(), _numpy(sp_ir.y)[sl].sum()])
    m2 = np.array([_numpy(sp_ir.x2)[sl].sum(), _numpy(sp_ir.y2)[sl].sum()])

    def residual(t1, t2):
        # design matrix: each arrival contributes (1, u(t), u(2t))
        a = np.array([[1.0, 1.0],
                      [np.cos(t1), np.cos(t2)],
                      [np.sin(t1), np.sin(t2)],
                      [np.cos(2 * t1), np.cos(2 * t2)],
                      [np.sin(2 * t1), np.sin(2 * t2)]])
        b = np.array([m0, m1[0], m1[1], m2[0], m2[1]])
        e, *_ = np.linalg.lstsq(a, b, rcond=None)
        e = np.maximum(e, 0.0)
        return float(((a @ e - b) ** 2).sum()), e

    # coarse pass over all bearing pairs: the closed-form 2x2 normal
    # equations (unclamped; the refine passes use the clamped lstsq)
    ts = np.linspace(-np.pi, np.pi, grid, endpoint=False)
    cols = np.stack([np.ones(grid), np.cos(ts), np.sin(ts),
                     np.cos(2 * ts), np.sin(2 * ts)], axis=1)   # [G, 5]
    b = np.array([m0, m1[0], m1[1], m2[0], m2[1]])
    gram = cols @ cols.T
    cb = cols @ b
    ii, jj = np.triu_indices(grid)
    g11 = np.diag(gram)[ii]
    g22 = np.diag(gram)[jj]
    g12 = gram[ii, jj]
    det = g11 * g22 - g12 * g12
    det = np.where(np.abs(det) < 1e-12, np.inf, det)  # t1 == t2: singular
    e1 = (g22 * cb[ii] - g12 * cb[jj]) / det
    e2 = (g11 * cb[jj] - g12 * cb[ii]) / det
    # residual of the exact (unclamped) solve: |b|^2 - e . (A^T b)
    res = (b @ b) - (e1 * cb[ii] + e2 * cb[jj])
    res = np.where(np.isfinite(res), res, np.inf)
    k = int(np.argmin(res))
    r0, e0 = residual(ts[ii[k]], ts[jj[k]])
    best = (r0, ts[ii[k]], ts[jj[k]], e0)
    step = 2 * np.pi / grid
    for _ in range(refine):
        step /= 4.0
        _, t1, t2, _ = best
        for d1 in (-step, 0.0, step):
            for d2 in (-step, 0.0, step):
                r, e = residual(t1 + d1, t2 + d2)
                if r < best[0]:
                    best = (r, t1 + d1, t2 + d2, e)
    _, t1, t2, e = best
    return sorted([(float(np.arctan2(np.sin(t), np.cos(t))), float(en))
                   for t, en in ((t1, e[0]), (t2, e[1]))],
                  key=lambda p: -p[1])
