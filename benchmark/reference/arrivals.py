"""The plain reference of per-arrival Doppler on a binaural stream (the
"composed" stream), in plain PyTorch.

Per chunk ``k`` (``N`` dry samples; a capture ``W/X/Y`` of ``T`` bins from
:mod:`.binaural`):

* **The tap table** (:func:`table`): the ``A`` dominant early arrivals of
  ``W``, each a local maximum (``w[b] >= w[b-1]``, ``w[b] > w[b+1]``,
  ``w[b] > 0``) in the first ``early`` bins, ranked by ``w[b-1] + w[b] +
  w[b+1]`` (descending, the lower bin first among equal scores), with its
  3-bin window ``g3 = W[b-1 : b+2]`` (0 past the IR's ends). A tap is kept
  if its score is positive and its window gain is above 1e-3 of the
  strongest tap's, and dropped if a kept-before-suppression tap within 2
  bins is stronger (or as strong and ranked earlier). ``early`` is the
  history window less the chunk, 2 bins, and an ITD pad of ``ceil(r *
  sample_rate / 100)`` bins.
* **The residual**: ``W``, ``X`` and ``Y`` with every kept tap's 3-bin
  window zeroed, decoded to the two ears at the chunk's facing
  (:func:`.binaural.decode`), crossfaded from the previous chunk's
  residual ears to these over the chunk and overlap-added into the ring
  (:func:`.audio.output_chunk`; the first chunk fades from its own).
* **Matching** (:func:`match`): each tap of chunk ``k`` takes the nearest
  valid tap of chunk ``k - 1`` (ties to the lower index); the pair is
  matched if it is mutual (that tap's nearest valid tap of chunk ``k`` is
  this one, ties to the lower index) and at most ``match_bins`` apart.
* **Ear taps** (:func:`ear_taps`): each window bin ``b`` of a tap, with
  its ``W``, ``X``, ``Y``, becomes per ear a coherent tap of gain
  ``min(|XY|, W) (1 +- shadow sin(phi))`` at delay ``clamp(b -+ shift
  sin(phi), 0, T - 1)`` and a diffuse tap of gain ``(W - min(|XY|, W))``
  times the ear's sign at bin ``clamp(b)``, at delay ``clamp(b)``: the
  decode's deposits of the removed bins.
* **Synthesis** (:func:`tap_signal`): over the chunk's output samples
  ``s`` a matched tap glides linearly from the previous chunk's delay and
  gain to its own, an unmatched one fades in from gain 0 at its own
  delay, and a previous tap no current tap matched fades out at its own
  delay; each reads the gated dry history at ``s - tau(s)`` with linear
  interpolation (silence outside the window). The taps add to the chunk's
  own ``N`` output samples.

Everything runs in the dtype of the capture it is given (float64 for the
comparison, bfloat16 for the control). One band. No code of the measured
program is imported.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from . import audio, binaural


class Table(NamedTuple):
    """A chunk's taps: bins ``idx [A]`` (int64), ``valid [A]`` and the
    3-bin windows ``w3``, ``x3``, ``y3 [A, 3]`` of ``W``, ``X``, ``Y``."""

    idx: torch.Tensor
    valid: torch.Tensor
    w3: torch.Tensor
    x3: torch.Tensor
    y3: torch.Tensor


def early_bins(window: int, n: int, sample_rate: int,
               head_radius: float) -> int:
    """The bins the taps may live in, for a history window of ``window``
    samples and chunks of ``n``."""
    pad = int(math.ceil(head_radius * sample_rate / 100.0))
    return max(1, window - n - 2 - pad)


def window3(chan: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``chan[idx - 1 : idx + 2]`` for each tap, ``[A, 3]``; 0 past the
    channel's ends."""
    n_t = chan.shape[-1]
    cols = idx[:, None] + torch.arange(-1, 2, device=idx.device)
    inside = (cols >= 0) & (cols < n_t)
    return torch.where(inside, chan[cols.clamp(0, n_t - 1)],
                       chan.new_zeros(()))


def table(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, early: int,
          n_taps: int, rel_floor: float = 1e-3) -> Table:
    zero = w.new_zeros(1)
    left = torch.cat([zero, w[:-1]])[:early]
    right = torch.cat([w[1:], zero])[:early]
    e = w[:early]
    peak = (e >= left) & (e > right) & (e > 0)
    score = torch.where(peak, left + e + right, -torch.ones_like(e))
    _, order = torch.sort(score, descending=True, stable=True)
    idx = order[:n_taps]
    w3 = window3(w, idx)
    gain = w3.sum(-1)
    kept = (score[idx] > 0) & (gain > rel_floor * gain.max())
    rank = torch.arange(idx.numel(), device=idx.device)
    # [a, b]: tap b is stronger than tap a, or as strong and ranked first
    stronger = (gain[None, :] > gain[:, None]) | (
        (gain[None, :] == gain[:, None]) & (rank[None, :] < rank[:, None]))
    near = (idx[:, None] - idx[None, :]).abs() <= 2
    valid = kept & ~(near & stronger & kept[None, :]).any(-1)
    return Table(idx, valid, w3, window3(x, idx), window3(y, idx))


def remove(chan: torch.Tensor, tab: Table) -> torch.Tensor:
    """``chan`` ``[T]`` with the 3-bin windows of ``tab``'s valid taps
    zeroed."""
    n_t = chan.shape[-1]
    cols = (tab.idx[:, None] + torch.arange(-1, 2, device=chan.device))
    cols = cols[tab.valid].reshape(-1)
    cols = cols[(cols >= 0) & (cols < n_t)]
    out = chan.clone()
    out[cols] = 0.0
    return out


class Match(NamedTuple):
    """Per current tap: the previous tap it is nearest to (``j``) and
    whether the pair is matched (``mutual``); per previous tap whether a
    current tap matched it (``taken``)."""

    j: torch.Tensor
    mutual: torch.Tensor
    taken: torch.Tensor


def match(cur: Table, prev: Table, match_bins: float) -> Match:
    d = (cur.idx[:, None] - prev.idx[None, :]).abs().to(torch.float64)
    inf = torch.full_like(d, math.inf)
    best, j = torch.where(prev.valid[None, :], d, inf).min(dim=1)
    back = torch.where(cur.valid[:, None], d, inf).argmin(dim=0)
    a = torch.arange(cur.idx.numel(), device=d.device)
    mutual = cur.valid & (best <= match_bins) & (back[j] == a)
    taken = torch.zeros_like(prev.valid)
    taken[j[mutual]] = True
    return Match(j, mutual, taken)


class EarTaps(NamedTuple):
    """One ear's taps of one table, each ``[A, 3]`` (tap, window bin):
    coherent delay and gain, diffuse delay and gain."""

    tau_coh: torch.Tensor
    g_coh: torch.Tensor
    tau_dif: torch.Tensor
    g_dif: torch.Tensor


def ear_taps(tab: Table, facing: float, ear: int, n_t: int, *,
             sample_rate: int, head_radius: float, shadow: float,
             speed: float, decorrelate: bool = True) -> EarTaps:
    sign = 1.0 if ear == 0 else -1.0
    coh = torch.minimum(torch.sqrt(tab.x3 * tab.x3 + tab.y3 * tab.y3),
                        tab.w3)
    dif = tab.w3 - coh
    s = torch.sin(torch.atan2(tab.y3, tab.x3) - facing)
    raw = tab.idx[:, None] + torch.arange(-1, 2, device=tab.idx.device)
    at = raw.clamp(0, n_t - 1)
    bins = raw.to(tab.w3.dtype)
    shift = binaural.max_shift(sample_rate, head_radius, speed)
    tau_coh = torch.clamp(bins - sign * shift * s, 0.0, float(n_t - 1))
    g_coh = coh * (1.0 + sign * shadow * s)
    tau_dif = torch.clamp(bins, 0.0, float(n_t - 1))
    g_dif = dif * binaural.signs(n_t, ear, dif)[at] if decorrelate else dif
    return EarTaps(tau_coh, g_coh, tau_dif, g_dif)


def tap_signal(window: torch.Tensor, n: int, tau0, tau1, g0, g1
               ) -> torch.Tensor:
    """``[n]`` output samples of taps whose delays glide ``tau0 -> tau1``
    and gains ``g0 -> g1`` (each ``[m]``) over the chunk, reading the dry
    history ``window`` ``[Wd]`` (its last ``n`` samples are the chunk's)
    with linear interpolation, silence outside it."""
    wd = window.shape[-1]
    r = torch.arange(n, device=window.device).to(window.dtype) / n
    tau = tau0[:, None] + (tau1 - tau0)[:, None] * r
    g = g0[:, None] + (g1 - g0)[:, None] * r
    p = (wd - n) + torch.arange(n, device=window.device).to(
        window.dtype) - tau
    inside = (p >= 0) & (p <= wd - 1)
    p = torch.where(inside, p, torch.zeros_like(p))
    lo = torch.floor(p)
    frac = p - lo
    lo = lo.to(torch.int64)
    padded = torch.cat([window, window.new_zeros(1)])
    y = padded[lo] * (1.0 - frac) + padded[lo + 1] * frac
    return torch.where(inside, g * y, torch.zeros_like(y)).sum(0)


def chunk_taps(window: torch.Tensor, n: int, cur: Table, prev: Table,
               facing: float, prev_facing: float, n_t: int,
               match_bins: float, **head) -> torch.Tensor:
    """The two ears' tap signal ``[2, n]`` of a chunk whose table is
    ``cur``, after a chunk whose table is ``prev``."""
    m = match(cur, prev, match_bins)
    fade_out = prev.valid & ~m.taken
    out = []
    for ear in (0, 1):
        c = ear_taps(cur, facing, ear, n_t, **head)
        p = ear_taps(prev, prev_facing, ear, n_t, **head)
        mu = m.mutual[:, None]
        tau0, tau1, g0, g1 = [], [], [], []
        for pick_c, pick_p in ((c.tau_coh, p.tau_coh), (c.tau_dif, p.tau_dif)):
            tau0.append(torch.where(mu, pick_p[m.j], pick_c)[cur.valid])
            tau1.append(pick_c[cur.valid])
        for pick_c, pick_p in ((c.g_coh, p.g_coh), (c.g_dif, p.g_dif)):
            g0.append(torch.where(mu, pick_p[m.j],
                                  torch.zeros_like(pick_c))[cur.valid])
            g1.append(pick_c[cur.valid])
        for tau, g in ((p.tau_coh, p.g_coh), (p.tau_dif, p.g_dif)):
            tau0.append(tau[fade_out])
            tau1.append(tau[fade_out])
            g0.append(g[fade_out])
            g1.append(torch.zeros_like(g[fade_out]))
        out.append(tap_signal(window, n, *(torch.cat(v).reshape(-1)
                                           for v in (tau0, tau1, g0, g1))))
    return torch.stack(out)


def history(dry_at: Callable[[torch.Tensor], torch.Tensor], j: int, n: int,
            wd: int, device) -> torch.Tensor:
    """The gated dry history ``[wd]`` ending at chunk ``j``'s end;
    ``dry_at(positions)`` gives the dry samples at absolute stream
    positions (silence before the stream)."""
    pos = (j + 1) * n - wd + torch.arange(wd, device=device)
    x = dry_at(pos)
    return torch.where(x.abs() > audio.GATE, x, torch.zeros_like(x))


class Chunk(NamedTuple):
    """What one chunk's capture gives: its tap table, its decoded residual
    ears ``[2, T]`` and the facing it was heard with."""

    table: Table
    residual: torch.Tensor
    facing: float


def chunk(cap: torch.Tensor, facing: float, early: int, n_taps: int,
          **head) -> Chunk:
    """The table and residual ears of a capture ``[3, T]`` (omni, cardioid
    0, cardioid 90)."""
    w, x, y = cap[0], cap[1] - cap[0], cap[2] - cap[0]
    tab = table(w, x, y, early, n_taps)
    res = binaural.decode(remove(w, tab), remove(x, tab), remove(y, tab),
                          facing, **head)
    return Chunk(tab, res, facing)


def output_chunk(j: int, n: int, n_t: int, wd: int,
                 dry_of: Callable[[int], torch.Tensor],
                 dry_at: Callable[[torch.Tensor], torch.Tensor],
                 chunk_of: Callable[[int], Chunk], match_bins: float,
                 dtype=torch.float64, **head) -> torch.Tensor:
    """Output chunk ``j`` ``[2, N]`` of the composed stream: the ring of
    the residuals' crossfaded convolutions plus chunk ``j``'s taps.
    ``dry_of(k)`` gives chunk ``k``'s dry samples, ``chunk_of(k)`` its
    :class:`Chunk`."""
    ring = audio.output_chunk(j, n, n_t, dry_of,
                              lambda k: chunk_of(k).residual, dtype)
    cur = chunk_of(j)
    prev = chunk_of(j - 1) if j > 0 else cur
    window = history(dry_at, j, n, wd, ring.device).to(cur.residual.dtype)
    taps = chunk_taps(window, n, cur.table, prev.table, cur.facing,
                      prev.facing, n_t, match_bins, **head)
    return ring + taps.to(ring.dtype)
