"""The plain reference of a banded stream's physics addenda: banded wall
materials, edge diffraction (Maekawa), air absorption (ISO 9613-1) and the
octave-band crossfade, in plain PyTorch.

Written from the published descriptions:

* **Banded materials.** A box's walls take the absorption of each band
  that the configuration lists for its material (``band_absorption``);
  the trace itself is :func:`.physics.trace_ir`, which carries an energy
  per band and cuts a ray or a shadow ray on its loudest band.
* **Edge table.** The candidate edges are the end points of the real
  walls. A corner that several walls share appears once per wall end,
  each with weight 1 / multiplicity (ends closer than 1e-4 m are one
  corner), so a corner counts once; an end where another wall continues
  in a straight line (a collinear seam: directions into the two walls
  opposite, ``|cross| < 1e-3``) is no edge.
* **Visibility.** A segment ``p -> q`` is clear where no wall crosses the
  ray from ``p`` towards ``q`` before ``|q - p| - 1e-3`` (the far-end
  slack: a segment that ends on a corner does not count that corner's
  walls); the ray-segment test is :func:`.physics._hit_distance`'s
  (distances from 1e-4 on, a segment parameter in [0, 1], parallels
  miss).
* **Maekawa paths** (Z. Maekawa, Noise reduction by screens, Applied
  Acoustics 1 (1968) 157-173). Only where the straight source-listener
  segment is blocked: order 1, source -> edge -> listener with both legs
  clear; order 2, source -> E1 -> E2 -> listener with all three legs clear
  and E1, E2 distinct. Energy: the trace's spreading law over the bent
  length (``gain / max(d^2, 1)``), the edges' weights, and one factor
  ``1 / (3 + 20 N)`` per wedge, ``N = 2 delta f / c`` at each band's centre
  ``f``, ``delta`` the wedge's detour (order 1: bent length less the
  straight one; order 2: at E1 the detour of S -> E1 -> E2 over S -> E2, at
  E2 that of E1 -> E2 -> L over E1 -> L). Each path lands in bin
  ``floor(length / c * sample_rate)``.
* **Air** (ISO 9613-1:1993 section 6.2): the pure-tone attenuation
  coefficient ``alpha`` in dB/m at each band's centre, and each IR bin of
  delay ``t`` multiplied by ``10^(-alpha c t / 10)`` (an energy IR; the
  bin's delay is its path's time), after the diffraction is added.
* **Octave-band crossfade.** Band k of a K-band IR plays the bins of the
  convolution's FFT whose frequency ``j sr / n_fft`` lies from the geometric
  midpoint below its centre up to the one above (octaves: ``f_k 2^(-1/2)``
  to ``f_k 2^(1/2)``), band 0 from 0 Hz, band K - 1 to Nyquist; the
  chunk is convolved with the previous and the current IR, blended by
  the linear ramp over the chunk with the tail on the current IR, and
  overlap-added (:mod:`.audio`'s stream).

Departures, each on purpose:

* The geometry of the addenda (visibility, path lengths, the bin of a
  path) runs in ``dtype``, the configuration's float32 on the sound side,
  so that a path whose length lies within a float32 rounding of a bin
  edge falls in the bin the float32 deployment puts it in; energies, the
  Maekawa factors, the air curve and the crossfade run in ``acc_dtype``
  (float64). The control runs all of it in bfloat16.
* The brickwall masks are defined on the FFT of the convolution, of
  ``n_fft`` the power of two at or above ``N + T`` points, as a banded
  stream applies them; a longer FFT would give another time aliasing of
  the brickwall's response.
* The visibility tests of a pose whose direct segment is clear are
  skipped: no path is valid there.

It imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import audio, physics, scenes

SLACK = 1e-3            # the far-end slack of a visibility segment, m
COINCIDENT = 1e-4       # wall ends closer than this are one corner, m
COLLINEAR = 1e-3        # |cross| of unit directions below this: a seam


class Work(NamedTuple):
    """:class:`.physics.Work` and the visibility segments the addenda
    needed (each tested against every wall)."""

    alive: float
    heard: float
    segments: float


def band_walls(config: dict) -> scenes.Walls:
    """The walls of a configuration's ``scene.boxes`` with the band
    absorptions of their materials (``band_absorption`` ``[K]``)."""
    sc = config["scene"]
    boxes = scenes.boxes_from_config(sc)
    bands = np.array([sc["materials"][b["material"]]["band_absorption"]
                      for b in sc["boxes"]], np.float32)
    walls = scenes.walls(boxes, bands.shape[1])
    return walls._replace(absorption=np.repeat(bands, 4, axis=0))


def edge_table(walls: scenes.Walls):
    """``(points [E, 2] float32, weight [E] float64)`` of the walls' ends,
    ``E = 2 W`` (starts, then ends); weight 0 for a collinear seam."""
    pts = np.concatenate([walls.a, walls.b]).astype(np.float64)
    into = np.concatenate([walls.b - walls.a, walls.a - walls.b]
                          ).astype(np.float64)
    length = np.hypot(into[:, 0], into[:, 1])
    valid = length > 0
    unit = into / np.where(length > 0, length, 1.0)[:, None]
    gap = np.hypot(*(pts[:, None, :] - pts[None, :, :]).transpose(2, 0, 1))
    same = (gap < COINCIDENT) & valid[None, :]
    cross = unit[:, None, 0] * unit[None, :, 1] \
        - unit[:, None, 1] * unit[None, :, 0]
    dot = unit @ unit.T
    other = ~np.eye(len(pts), dtype=bool)
    seam = (same & other & (np.abs(cross) < COLLINEAR) & (dot < 0)).any(1)
    valid &= ~seam
    mult = (same & valid[None, :]).sum(1)
    weight = np.where(valid & (mult > 0), 1.0 / np.maximum(mult, 1), 0.0)
    return np.concatenate([walls.a, walls.b]), weight


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def clear(p: torch.Tensor, q: torch.Tensor, tab: physics.Tables
          ) -> torch.Tensor:
    """True where segment ``p -> q`` (``[n, 2]`` each, in the tables'
    dtype) crosses no wall before its far end less :data:`SLACK`."""
    d = q - p
    length = _norm(d)
    dn = d / torch.clamp(length, min=physics.EPS)[:, None]
    t = physics._hit_distance(p[:, 0:1], p[:, 1:2], dn[:, 0:1], dn[:, 1:2],
                              tab, None)                     # [n, W]
    return t.min(dim=-1).values >= length - SLACK


def air_alpha(freqs_hz, temperature_c: float, rel_humidity: float,
              pressure_kpa: float) -> np.ndarray:
    """ISO 9613-1:1993 section 6.2: the pure-tone attenuation coefficient
    in dB/m at ``freqs_hz`` (equations 3-5 and B.1-B.3), float64."""
    f = np.asarray(freqs_hz, np.float64)
    t = temperature_c + 273.15
    t0, t01, pr = 293.15, 273.16, 101.325
    pa = pressure_kpa / pr
    tr = t / t0
    c = -6.8346 * (t01 / t) ** 1.261 + 4.6151
    h = rel_humidity * 10.0 ** c / pa        # molar concentration of vapour, %
    fro = pa * (24.0 + 4.04e4 * h * (0.02 + h) / (0.391 + h))
    frn = pa * tr ** -0.5 * (9.0 + 280.0 * h
                             * np.exp(-4.170 * (tr ** (-1.0 / 3.0) - 1.0)))
    return 8.686 * f ** 2 * (
        1.84e-11 / pa * tr ** 0.5
        + tr ** -2.5 * (0.01275 * np.exp(-2239.1 / t) / (fro + f ** 2 / fro)
                        + 0.1068 * np.exp(-3352.0 / t) / (frn + f ** 2 / frn)))


def air_curve(n_bins: int, sample_rate: int, alpha, speed: float,
              dtype, device) -> torch.Tensor:
    """Energy factors ``[T, K]``: ``10^(-alpha_k c t / 10)`` at bin delay
    ``t = i / sample_rate``."""
    t = torch.arange(n_bins, dtype=torch.float64, device=device) / sample_rate
    a = torch.as_tensor(np.asarray(alpha, np.float64), device=device)
    return torch.pow(10.0, -(t[:, None] * speed) * a[None, :] / 10.0
                     ).to(dtype)


class Addenda:
    """A scene's diffraction, fixed for a run: its tables, its edge table,
    the band centres and the constants of the paths."""

    def __init__(self, walls: scenes.Walls, centres_hz, *, speed: float,
                 gain: float, sample_rate: int, ir_length: int, dtype,
                 acc_dtype, device):
        self.tab = physics.tables([walls], dtype, device)
        pts, weight = edge_table(walls)
        keep = weight > 0
        self.pts = torch.as_tensor(pts[keep]).to(device=device, dtype=dtype)
        self.weight = torch.as_tensor(weight[keep], device=device
                                      ).to(acc_dtype)
        self.freqs = torch.as_tensor(np.asarray(centres_hz, np.float64),
                                     device=device).to(acc_dtype)
        self.speed, self.gain = speed, gain
        self.sr, self.t = sample_rate, ir_length
        self.dtype, self.acc = dtype, acc_dtype
        self.dev = device

    def blocked(self, source, listener) -> bool:
        """Whether the walls block the straight source-listener segment."""
        s = torch.as_tensor(np.asarray(source)).to(self.dev, self.dtype)
        q = torch.as_tensor(np.asarray(listener)).to(self.dev, self.dtype)
        return not bool(clear(s[None], q[None], self.tab)[0])

    def paths(self, source, listener):
        """Every valid path of orders 1 and 2: ``(lengths [P] in dtype,
        energies [P, K] in acc_dtype, segments tested)``."""
        s = torch.as_tensor(np.asarray(source)).to(self.dev, self.dtype)
        q = torch.as_tensor(np.asarray(listener)).to(self.dev, self.dtype)
        if bool(clear(s[None], q[None], self.tab)[0]):
            empty = torch.zeros(0, dtype=self.dtype, device=self.dev)
            return empty, torch.zeros(0, len(self.freqs), dtype=self.acc,
                                      device=self.dev), 1
        e = self.pts.shape[0]
        p = self.pts
        src_ok = clear(s.expand(e, 2), p, self.tab)              # [E]
        leg_ok = clear(p, q.expand(e, 2), self.tab)              # [E]
        i1, i2 = torch.meshgrid(torch.arange(e, device=self.dev),
                                torch.arange(e, device=self.dev),
                                indexing="ij")
        d12_lo = _norm(p[i1] - p[i2])
        distinct = (d12_lo > COINCIDENT).reshape(-1)
        a, b = i1.reshape(-1)[distinct], i2.reshape(-1)[distinct]
        pair_ok = clear(p[a], p[b], self.tab)
        segments = 1 + 2 * e + int(a.numel())

        # lengths in dtype (the bins), again in acc_dtype (the energies)
        d1, d2 = _norm(p - s), _norm(q - p)
        pa, sa, qa = p.to(self.acc), s.to(self.acc), q.to(self.acc)
        d1a, d2a = _norm(pa - sa), _norm(qa - pa)
        d_dir = _norm(qa - sa)
        d12a = _norm(pa[a] - pa[b])
        c = torch.tensor(self.speed, dtype=self.acc, device=self.dev)

        def maekawa(delta):                                     # [P, K]
            n = 2.0 * torch.clamp(delta, min=0.0)[:, None] * self.freqs / c
            return 1.0 / (3.0 + 20.0 * n)

        def spread(length):
            return self.gain / torch.clamp(length * length, min=1.0)

        one = src_ok & leg_ok
        len1 = (d1 + d2)[one]
        tot1 = (d1a + d2a)[one]
        en1 = (self.weight * spread(d1a + d2a))[one][:, None] \
            * maekawa(tot1 - d_dir)
        two = src_ok[a] & pair_ok & leg_ok[b]
        a2, b2 = a[two], b[two]
        d12 = _norm(p[a2] - p[b2])
        len2 = d1[a2] + d12 + d2[b2]
        tot2 = d1a[a2] + d12a[two] + d2a[b2]
        en2 = (self.weight[a2] * self.weight[b2] * spread(tot2))[:, None] \
            * maekawa(d1a[a2] + d12a[two] - d1a[b2]) \
            * maekawa(d12a[two] + d2a[b2] - d2a[a2])
        return torch.cat([len1, len2]), torch.cat([en1, en2]), segments

    def ir(self, source, listener):
        """The diffraction IR ``[T, K]`` (acc_dtype) of one pose, and the
        segments its visibility tests needed."""
        length, energy, segments = self.paths(source, listener)
        out = torch.zeros(self.t + 1, len(self.freqs), dtype=self.acc,
                          device=self.dev)
        c = torch.tensor(self.speed, dtype=self.dtype, device=self.dev)
        bins = torch.floor(length / c * self.sr).to(torch.int64)
        ok = (bins >= 0) & (bins < self.t)
        out.index_add_(0, torch.where(ok, bins, self.t), energy)
        return out[:self.t], segments


def band_masks(centres_hz, n_fft: int, sample_rate: int, dtype,
               device) -> torch.Tensor:
    """Brickwall masks ``[K, F]`` of the log-spaced bands about
    ``centres_hz`` on an ``n_fft``-point rfft's bins."""
    f = np.asarray(centres_hz, np.float64)
    edges = np.sqrt(f[:-1] * f[1:])
    freqs = np.arange(n_fft // 2 + 1) * sample_rate / n_fft
    band = (freqs[:, None] >= edges[None, :]).sum(1)         # [F]
    return torch.as_tensor(band[None, :] == np.arange(len(f))[:, None]
                           ).to(device=device, dtype=dtype)


def wet(dry: torch.Tensor, ir_prev: torch.Tensor, ir_cur: torch.Tensor,
        masks_of: Callable[[int], torch.Tensor],
        dtype=torch.float64) -> torch.Tensor:
    """One chunk's wet samples ``[N + T]`` from dry ``[N]`` and banded IRs
    ``[T, K]``: each band of the gated dry convolved with its band of each
    IR (``masks_of(n_fft)`` the bands on the FFT's bins), crossfaded by
    the linear ramp over the chunk, the tail on the current IR."""
    x = audio._round(dry, dtype)
    x = torch.where(x.abs() > audio.GATE, x, 0.0)
    n, t = x.shape[-1], ir_cur.shape[0]
    out = n + t
    n_fft = audio._pow2(out)
    spec = torch.fft.rfft(x, n_fft)
    masks = masks_of(n_fft).to(spec.real.dtype)

    def conv(ir):
        h = (torch.fft.rfft(audio._round(ir, dtype).T, n_fft) * masks).sum(0)
        return audio._round(torch.fft.irfft(spec * h, n_fft)[:out], dtype)

    y_prev, y_cur = conv(ir_prev), conv(ir_cur)
    ramp = torch.clamp(torch.arange(out, dtype=y_cur.dtype,
                                    device=y_cur.device) / n, max=1.0)
    return audio._round(y_prev * (1.0 - ramp) + y_cur * ramp, dtype)


def output_chunk(j: int, n: int, t: int,
                 dry_of: Callable[[int], torch.Tensor],
                 ir_of: Callable[[int], torch.Tensor],
                 masks_of: Callable[[int], torch.Tensor],
                 dtype=torch.float64) -> torch.Tensor:
    """Output chunk ``j`` ``[1, N]`` (float64): the wet pieces of every
    chunk whose tail reaches it, overlap-added; chunk 0 fades in from its
    own IR."""
    reach = (n + t - 1) // n
    total = torch.zeros(n, dtype=torch.float64,
                        device=dry_of(j).device)
    for k in range(max(0, j - reach), j + 1):
        prev = ir_of(k - 1) if k > 0 else ir_of(k)
        piece = wet(dry_of(k), prev, ir_of(k), masks_of, dtype)[
            (j - k) * n:(j - k + 1) * n].to(torch.float64)
        total[:piece.shape[-1]] += piece
    return total[None]


def chunk_ir(tab: physics.Tables, add: Addenda, source, listener,
             seed: int, *, n_rays: int, n_bounces: int, radius: float,
             alpha, dtype, acc_dtype, curve: Optional[torch.Tensor] = None):
    """One chunk's IR ``[T, K]`` (acc_dtype): the banded trace (one frame),
    plus its diffraction, times the air curve; and its :class:`Work`."""
    pose = physics.Pose(torch.as_tensor(np.asarray(source))[None],
                        torch.as_tensor(np.asarray(listener))[None, None],
                        radius, add.speed, add.gain)
    ir, work = physics.trace_ir(
        tab, pose, seed, n_rays=n_rays, n_bounces=n_bounces, n_frames=1,
        sample_rate=add.sr, ir_length=add.t, dtype=dtype,
        acc_dtype=acc_dtype)
    d_ir, segments = add.ir(source, listener)
    if curve is None:
        curve = air_curve(add.t, add.sr, alpha, add.speed, acc_dtype,
                          add.dev)
    out = (ir[0, 0] + d_ir.to(ir.dtype)) * curve.to(ir.dtype)
    return out, Work(work.alive, work.heard, segments)
