"""Real-time streaming: chunked convolution with live IR updates (PyTorch:
plain, binaural and Doppler modes).

Port of ``realisticaudioraytracing2d_tpu/streaming.py`` (the reference's
``FixedUpdate`` chunk clock + ``ProcessChunk`` coroutine,
``Assets/Script/RayTraceManager.cs:64-123``, and the ``AudioManager``
overlap-add ring, ``Assets/Script/AudioManager.cs:45-69``). Per chunk,
:func:`stream_chunk`:

1. traces ``frames_per_chunk`` Monte-Carlo frames into a fresh IR (on the
   card through the hand kernel, see ``engine.trace_accumulate``);
2. convolves the dry chunk against the previous chunk's IR and the new
   one (one input FFT) and crossfades between them;
3. overlap-adds the wet chunk with its reverb tail into the ring and
   drains exactly one chunk (add-then-zero).

The fresh chunk IR takes the JAX step's physics addenda before the
crossfade (:func:`_augment_ir`): edge diffraction (``ops/diffraction.py``,
its visibility sweeps through the kernel K2 on the card) and ISO 9613-1
air absorption (``ops/air.py``). Directive sources and microphones ride
in ``params``. A banded IR's convolutions split the spectrum as the
stream's ``band_split`` says: into K equal bands (the JAX package's
split, the default) or into bands about the centres the banded physics
is computed at (``ops/convolve.py::octave_filterbank``). Where the JAX
step donates its state buffers, this one updates the preallocated
:class:`StreamState` in place.

In binaural mode (``binaural_facing``) the chunk traces the head's
three-microphone spatial capture (``spatial.binaural_trace_params``: K4
for a seed, K3 for host uniforms, K8/K7 past 5,280 walls), takes the
addenda on it, and decodes it to the two ears (``spatial.
binaural_decode_ir``) before the crossfade; the head's facing may turn
every chunk.

Two Doppler modes (``Streamer.stream_clip(doppler=...)``):

* ``doppler=True``, the shared rate: the dry feed is read at ``1 - v/c``
  dry samples per output sample (:func:`warp_chunk`, :class:`DopplerFeed`),
  ``v`` the radial velocity of the first source toward the first listener
  from consecutive poses;
* ``doppler="per_arrival"``: the dominant early arrivals of each chunk's
  IR leave the convolution and become 3-bin fractional-delay taps whose
  delays glide chunk to chunk (:func:`_per_arrival_parts`), so the direct
  sound and each early reflection carry their own rate. It composes with
  banded scenes (each tap reads band-split dry, :func:`_band_windows`) and
  with binaural streams (taps from the capture's W channel, each becoming
  four ear taps with ITD and ILD from its X/Y bearing,
  :func:`_per_arrival_binaural`). The previous chunk's tap table and
  residual ride in :class:`ArrivalCarry`.

Each stage of a chunk is a span of the port's (``utils/profiling.py::
span``), recorded while a profiler runs (``utils.profiling.device_trace``):
``art.stream.retrace`` (holding the trace route's ``art.trace.*``),
``art.stream.addenda`` (holding ``art.addenda.diffraction`` and
``art.addenda.air`` where those addenda are on), ``art.stream.decode``
(binaural),
``art.stream.crossfade`` (or the per-arrival branch) and, in
:func:`stream_chunk`, ``art.stream.ring``. The per-arrival branch splits
its crossfade span four ways: ``art.arrival.extract`` (the tap table and
the taps' removal from the IR), ``art.arrival.residual`` (binaural: the
residual capture's decode), ``art.arrival.taps`` (the history window,
matching, ear fields and tap synthesis) and ``art.arrival.convolve`` (the
residual's crossfaded convolution).

The trace of a Doppler chunk is that of the plain or binaural chunk (the
same kernels). On the card the taps are hand-written kernels
(``ops/cuda/arrival_taps_kernel.py``): the tap synthesis of every
per-arrival stream, which at one band reads the dry history straight
from the clip (:class:`DryWindow`), and the binaural ear-tap table
(matching, ear fields and rows). The arrival tables and the warp are
plain tensor code on the stream's device, as they are ``jnp`` code in
JAX; on the CPU the taps are too (:func:`_tap_chunk_plain`,
:func:`_ear_taps`). None of it reads a tensor back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import EngineConfig
from .device import resolve
from .models.scene import Scene
from .ops import convolve as cv
from .ops import ir as irm
from .ops.cuda import arrival_taps_kernel as atk
from .ops.rng import mix_seed
from .ops.trace import TraceParams
from .utils.profiling import span

# per-arrival Doppler defaults (Streamer kwargs and CLI flags)
_ARRIVAL_TAPS = 6         # taps tracked per listener
_ARRIVAL_WINDOW_S = 0.12  # early window the taps may live in
_ARRIVAL_MATCH_BINS = 64.0  # max bin drift matched chunk-to-chunk


def _augment_ir(cur_ir: torch.Tensor, scene: Scene, params: TraceParams,
                sample_rate: int, diffraction, air_alpha,
                plain: bool = False) -> torch.Tensor:
    """The optional physics addenda on a freshly traced, normalized chunk
    IR (the JAX package's ``streaming.py::_augment_ir``): edge diffraction
    (``diffraction`` falsy, 1, or 2 = edge-to-edge double diffraction),
    then ISO 9613-1 air absorption (``air_alpha``: dB/m, per band or a
    number; None for none), which attenuates the diffracted paths too.
    The air curve multiplies by the float32 reciprocals of the sample
    rate and 10, as XLA computes the jitted JAX step with a static
    sample rate. On a CUDA scene the diffraction is added into
    ``cur_ir`` in place by the hand kernels; ``plain`` runs its plain
    chain instead (``backend="plain"``). Each
    addendum that is on runs in a span of its own,
    ``art.addenda.diffraction`` and ``art.addenda.air``."""
    if diffraction:
        from .ops.diffraction import add_diffraction
        with span("addenda.diffraction"):
            # cur_ir is normalized()'s fresh quotient: the card's kernels
            # add the paths into it in place
            cur_ir = add_diffraction(
                cur_ir, scene, params, sample_rate=sample_rate,
                order=int(diffraction), use_kernels=False if plain else None)
    if air_alpha is not None:
        from .ops.air import apply_air_absorption
        with span("addenda.air"):
            cur_ir = apply_air_absorption(cur_ir, sample_rate, air_alpha,
                                          params.speed_of_sound,
                                          reciprocal=True)
    return cur_ir


class RingBuffer:
    """Additive ring buffer ``[L, S]`` (``AudioManager.cs:45-69``: writes
    add, reads zero what they consume). Updated in place."""

    def __init__(self, data: torch.Tensor, read_head: int = 0):
        self.data = data
        self.read_head = int(read_head)

    @staticmethod
    def zeros(size: int, n_listeners: int = 1, device=None) -> "RingBuffer":
        return RingBuffer(torch.zeros((n_listeners, size), dtype=torch.float32,
                                      device=resolve(device)))

    @property
    def size(self) -> int:
        return self.data.shape[-1]

    def _spans(self, start: int, n: int):
        """``[start, start + n)`` mod size as at most two contiguous
        ``(ring slice, source offset)`` pairs."""
        if n > self.size:
            raise ValueError(f"{n} samples exceed the ring size {self.size}")
        start %= self.size
        first = min(n, self.size - start)
        spans = [(slice(start, start + first), 0)]
        if first < n:
            spans.append((slice(0, n - first), first))
        return spans

    def push(self, samples: torch.Tensor, offset: int) -> "RingBuffer":
        """Overlap-add ``samples[L, N]`` at absolute sample ``offset``
        (wrapped mod size): ``PushSamples`` (``AudioManager.cs:45-54``)."""
        n = samples.shape[-1]
        for ring, src in self._spans(int(offset), n):
            self.data[:, ring] += samples[:, src:src + ring.stop - ring.start]
        return self

    def drain(self, n: int) -> torch.Tensor:
        """Read and zero ``n`` samples from the read head, then advance it:
        ``OnAudioFilterRead`` (``AudioManager.cs:56-69``)."""
        parts = []
        for ring, _ in self._spans(self.read_head, n):
            parts.append(self.data[:, ring].clone())
            self.data[:, ring] = 0.0
        self.read_head = (self.read_head + n) % self.size
        return torch.cat(parts, dim=-1)


@dataclass
class ArrivalCarry:
    """The previous chunk's per-arrival Doppler products, so that chunk
    ``i`` recomputes nothing chunk ``i - 1`` produced: the previous IR's
    arrival table is the last chunk's current one, and the crossfade's
    prev-side residual is the last chunk's cur-side residual (binaural:
    its decoded ears).

    ``res`` is the tap-removed residual the crossfade reads ``[L, T, K]``
    (binaural: the decoded two-ear residual ``[2, T, K]``); ``idx``
    (int64), ``g3`` and ``val`` the arrival table (binaural: of the W
    channel, so the leading axis is 1); ``x3``/``y3`` the X/Y intensity
    windows at the tap bins (binaural only: each tap's bearing). Updated
    in place by :func:`stream_chunk`."""

    res: torch.Tensor                  # [L, T, K]
    idx: torch.Tensor                  # [Lw, A] int64 tap bins
    g3: torch.Tensor                   # [Lw, A, 3, K] tap window gains
    val: torch.Tensor                  # [Lw, A] bool
    x3: Optional[torch.Tensor] = None  # [Lw, A, 3, K] (binaural only)
    y3: Optional[torch.Tensor] = None  # [Lw, A, 3, K] (binaural only)

    def tensors(self):
        """The carry's tensors (``x3``/``y3`` where present), in field
        order."""
        return [t for t in (getattr(self, f.name) for f in fields(self))
                if t is not None]

    def copy_(self, other: "ArrivalCarry") -> "ArrivalCarry":
        """Copy ``other``'s tensors into this carry's, in place."""
        for dst, src in zip(self.tensors(), other.tensors()):
            dst.copy_(src)
        return self


def init_arrival_carry(ir_length: int, n_listeners: int = 1,
                       n_bands: int = 1, n_taps: int = _ARRIVAL_TAPS,
                       binaural: bool = False, device=None) -> ArrivalCarry:
    """All-zero carry (``val`` all False): the next chunk's taps fade in
    fresh and its crossfade rises from silence, the first-chunk and
    post-``reset_ir`` state."""
    device = resolve(device)
    lw = 1 if binaural else n_listeners

    def zt():
        return torch.zeros((lw, n_taps, 3, n_bands), dtype=torch.float32,
                           device=device)

    return ArrivalCarry(
        res=torch.zeros((n_listeners, ir_length, n_bands),
                        dtype=torch.float32, device=device),
        idx=torch.zeros((lw, n_taps), dtype=torch.int64, device=device),
        g3=zt(),
        val=torch.zeros((lw, n_taps), dtype=torch.bool, device=device),
        x3=zt() if binaural else None,
        y3=zt() if binaural else None)


@dataclass
class StreamState:
    """Carried state of the stream: the previous chunk's normalized IR, the
    ring (its read head is the stream position), the chunk counter and,
    for a binaural stream only, the head facing (radians, a 0-d float32
    tensor) the previous chunk was decoded with; for a per-arrival
    Doppler stream only, the previous chunk's :class:`ArrivalCarry`."""

    prev_ir: torch.Tensor   # [L, T, K]
    ring: RingBuffer
    chunk_index: int = 0
    prev_facing: Optional[torch.Tensor] = None
    arrival: Optional[ArrivalCarry] = None


def init_stream(ir_length: int, chunk_samples: int, n_listeners: int = 1,
                n_bands: int = 1, binaural: bool = False,
                arrival_taps: Optional[int] = None,
                device=None) -> StreamState:
    """Ring sized to hold a chunk + its reverb tail with slack:
    ``ir_length + 2 * chunk_samples`` (the JAX package's rule);
    ``binaural`` allocates the facing carry, ``arrival_taps`` the
    per-arrival Doppler carry (:meth:`Streamer.process` allocates it on
    the first per-arrival chunk, so plain streams never carry it)."""
    device = resolve(device)
    return StreamState(
        prev_ir=torch.zeros((n_listeners, ir_length, n_bands),
                            dtype=torch.float32, device=device),
        ring=RingBuffer.zeros(ir_length + 2 * chunk_samples, n_listeners,
                              device),
        prev_facing=(torch.zeros((), dtype=torch.float32, device=device)
                     if binaural else None),
        arrival=(init_arrival_carry(ir_length, n_listeners, n_bands,
                                    arrival_taps, binaural, device)
                 if arrival_taps is not None else None))


def _crossfaded_wet(chunk: torch.Tensor, ir_prev: torch.Tensor,
                    ir_cur: torch.Tensor, split: str = "linear",
                    sample_rate: Optional[int] = None) -> torch.Tensor:
    """Wet chunk ``[L, N+T]``: convolve against both IRs (one input FFT,
    two transfer functions) and crossfade prev->cur linearly across the
    chunk; the reverb tail uses the current IR only. A banded IR's bands
    are those of ``split`` (``ops/convolve.py::split_masks``; the octave
    split's bins at ``sample_rate``)."""
    chunk = cv.gate_input(chunk)
    n = chunk.shape[-1]
    out_length = n + ir_prev.shape[-2]
    n_fft = cv._next_pow2(out_length)
    x = torch.fft.rfft(chunk, n_fft)
    h = torch.stack([cv.combined_transfer(ir_prev, n_fft, split, sample_rate),
                     cv.combined_transfer(ir_cur, n_fft, split,
                                          sample_rate)])        # [2, L, F]
    y = torch.fft.irfft(x * h, n_fft)[..., :out_length]         # [2, L, O]
    ramp = torch.clamp(cv._divide(torch.arange(out_length,
                                               dtype=torch.float32,
                                               device=chunk.device),
                                  float(max(1, n))), max=1.0)
    return y[0] * (1.0 - ramp) + y[1] * ramp


# ---- per-arrival Doppler (doppler="per_arrival") ---------------------------
#
# The shared-rate feed (DopplerFeed) warps the whole dry stream at the
# direct path's rate, which is wrong for reflections: their path lengths
# change at their own rates (a source approaching the listener but
# receding from the back wall shifts the direct sound up and the echo
# down). These helpers give each dominant early arrival its own glide: the
# top-A early peaks of the chunk IR become 3-bin taps (the peak bin and its
# two neighbours, with their own gains, so tap + residual reproduce the
# full IR's convolution exactly whatever the window holds), matched
# mutual-nearest against the previous chunk's taps and synthesized as
# time-varying fractional-delay reads of the dry history, the window delay
# and per-bin gains gliding linearly across the chunk: the delay glide is
# the per-path Doppler. The tap bins leave both IRs, so the residual (late
# field, unmatched transients) rides the ordinary crossfaded convolution,
# unwarped: a diffuse late field arrives from every direction, so its net
# shift is about zero.

def _window3(chan: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """3-bin windows ``[L, A, 3, K]`` of channel ``[L, T, K]`` at tap bins
    ``idx[L, A]``. Neighbours out of range are 0, not the clipped edge bin
    (an idx = 0 or T - 1 tap would otherwise synthesize more energy than
    :func:`_remove_taps` zeroes)."""
    t = chan.shape[1]
    li = torch.arange(chan.shape[0], device=chan.device)[:, None, None]
    raw = idx[:, :, None] + torch.arange(-1, 2, device=idx.device)
    in_range = (raw >= 0) & (raw < t)
    return torch.where(in_range[..., None], chan[li, raw.clamp(0, t - 1)],
                       0.0)


def _arrival_table(ir: torch.Tensor, early_bins: int, n_taps: int,
                   rel_floor: float = 1e-3):
    """Top-``n_taps`` early arrivals of an IR ``[L, T, K]``: ``(idx[L, A]
    int64, g3[L, A, 3, K], valid[L, A])``.

    A tap is a local maximum of the band-summed energy in the first
    ``early_bins`` bins (the bands share one delay: an arrival is one
    path), carrying its per-band 3-bin window ``g3 = ir[idx-1 : idx+2]``,
    exactly the bins :func:`_remove_taps` zeroes. Neighbours come from the
    full IR, so a peak just past the window spawns no rising-edge tap. The
    ranking is ``jax.lax.top_k``'s: descending, the lower bin first among
    equal scores (a symmetric room ties, and every non-maximum scores
    -1), which a stable descending sort gives and ``torch.topk`` does not
    promise. Taps within 2 bins of a stronger (or an earlier-ranked equal)
    one are suppressed, since their windows would overlap, and taps below
    ``rel_floor`` of the listener's strongest are dropped."""
    e = ir.sum(dim=-1)                                   # [L, T]
    left_e = torch.nn.functional.pad(e, (1, 0))[:, :-1]
    right_e = torch.nn.functional.pad(e, (0, 1))[:, 1:]
    w = e[:, :early_bins]
    left = left_e[:, :early_bins]
    right = right_e[:, :early_bins]
    ismax = (w >= left) & (w > right) & (w > 0)
    score = torch.where(ismax, w + left + right, -1.0)
    val, idx = torch.sort(score, dim=1, descending=True, stable=True)
    val, idx = val[:, :n_taps], idx[:, :n_taps]          # [L, A]
    g3 = _window3(ir, idx)                               # [L, A, 3, K]
    gain = g3.sum(dim=(-1, -2))
    valid = (val > 0) & (gain > rel_floor
                         * gain.amax(dim=1, keepdim=True))
    d = (idx[:, :, None] - idx[:, None, :]).abs()
    rank = torch.arange(n_taps, device=ir.device)
    stronger = (gain[:, None, :] > gain[:, :, None]) | (
        (gain[:, None, :] == gain[:, :, None])
        & (rank[None, None, :] < rank[None, :, None]))
    clash = (d <= 2) & stronger & valid[:, None, :]
    return idx, g3, valid & ~clash.any(dim=2)


def _match_arrivals(idx_c, valid_c, idx_p, g3_p, valid_p,
                    match_bins: float):
    """Mutual-nearest matching of this chunk's taps to the previous
    chunk's within ``match_bins``. Returns ``(tau0, g0[.., 3, K],
    matched_prev, j, mutual)``: per current tap the previous tap (delay
    and window gains) it glides from; an unmatched current tap fades in
    from gain 0 at its own delay. ``j[L, A]`` is the matched previous
    tap's index (meaningful where ``mutual``). Previous taps no current
    tap matched (``~matched_prev``) vanished, and the caller fades them
    out as taps at their own delay: the previous chunk pushed its tail
    without their bins, so leaving them to the residual crossfade would
    click at the boundary. Ties go to the lower index, as JAX's
    ``argmin``; ``matched_prev`` is a scatter of maxima, whose result does
    not depend on the order."""
    tau_c = idx_c.to(torch.float32)
    tau_p = idx_p.to(torch.float32)
    d = (tau_c[:, :, None] - tau_p[:, None, :]).abs()   # [L, A, A]
    d_cp = torch.where(valid_p[:, None, :], d, math.inf)
    best, j = d_cp.min(dim=2)                            # cur -> prev
    i_back = torch.where(valid_c[:, :, None], d, math.inf).argmin(dim=1)
    li = torch.arange(tau_c.shape[0], device=d.device)[:, None]
    a = torch.arange(tau_c.shape[1], device=d.device)[None, :]
    mutual = (i_back[li, j] == a) & (best <= match_bins) & valid_c
    tau0 = torch.where(mutual, tau_p[li, j], tau_c)
    g0 = torch.where(mutual[..., None, None], g3_p[li, j], 0.0)
    matched_prev = torch.zeros_like(idx_p).scatter_reduce_(
        1, j, mutual.to(idx_p.dtype), "amax")
    return tau0, g0, matched_prev.bool(), j, mutual


def _remove_taps(ir: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor
                 ) -> torch.Tensor:
    """Zero the 3-bin windows of the valid taps across all K bands of an IR
    ``[L, T, K]``: the residual the crossfaded convolution handles. Row by
    row, so a spatial capture ``[3, T, K]`` is cleaned by repeating the
    head's ``idx``/``valid`` over the 3 pattern rows. The mask is a
    scatter of minima (order-independent)."""
    l, t = ir.shape[:2]
    cols = (idx[:, :, None] + torch.arange(-1, 2, device=idx.device)
            ).clamp(0, t - 1)
    keep = (~valid).to(ir.dtype)[:, :, None].expand(cols.shape)
    mask = torch.ones((l, t), dtype=ir.dtype, device=ir.device
                      ).scatter_reduce_(1, cols.reshape(l, -1),
                                        keep.reshape(l, -1), "amin")
    return ir * mask[..., None]


def _band_windows(window: torch.Tensor, k: int, split: str = "linear",
                  sample_rate: Optional[int] = None) -> torch.Tensor:
    """Split a mono dry-history window ``[Wd]`` into the ``[K, Wd]`` band
    signals that banded taps read: a banded IR convolves each brickwall
    band of the dry with that band's IR (:func:`..ops.convolve.
    combined_transfer`), so a tap with per-band gains reads band-filtered
    dry, in the bands of ``split`` (the crossfade's). Zero-padding to
    ``>= 2 Wd`` keeps the brickwall's circular wrap out of the window.
    K == 1 passes the raw window through."""
    if k == 1:
        return window[None, :]
    wd = window.shape[-1]
    n_fft = cv._next_pow2(2 * wd)
    x = torch.fft.rfft(window, n_fft)
    masks = cv.split_masks(k, n_fft, window.device, split,
                           sample_rate)                      # [K, F]
    return torch.fft.irfft(x[None, :] * masks, n_fft)[:, :wd]


def _tap_chunk(dry_window, tau0, tau1, g0, g1, valid, n: int
               ) -> torch.Tensor:
    """``[L, n]`` sum of time-varying 3-bin taps, arguments as
    :func:`_tap_chunk_plain`'s; ``dry_window`` may also be a
    :class:`DryWindow`, read gated. On the card one launch of the tap
    synthesis kernel (``ops/cuda/arrival_taps_kernel.py::
    tap_synthesis``), whatever form the delays and gains take; on the CPU
    :func:`_tap_chunk_plain`."""
    return atk.tap_synthesis(dry_window, tau0, tau1, g0, g1, valid, n)


def _tap_chunk_plain(dry_window: torch.Tensor, tau0, tau1, g0, g1, valid,
                     n: int) -> torch.Tensor:
    """``[L, n]`` sum of time-varying 3-bin taps (the gather form of JAX's
    ``_tap_chunk``): the CPU path of :func:`_tap_chunk` and the oracle of
    its kernel. ``dry_window`` is ``[Wd]`` mono or ``[K, Wd]``
    band-split (:func:`_band_windows`), ending at the chunk end: its sample
    ``Wd - n + s`` is the chunk's output sample ``s``. Delays and gains
    come as ``tau[L, A]`` + ``g[L, A, 3]`` (one window delay per tap,
    per-bin gains at offsets -1, 0, 1: the scalar tap) or ``tau/g[L, A,
    3, K]`` (per-bin, per-band delays and gains: the binaural ear taps),
    promoted to the full form.

    Everything glides linearly ``tau0 -> tau1``, ``g0 -> g1`` across the
    chunk, as the crossfade's ramp; bin ``(a, d, k)`` reads band ``k`` at
    ``Wd - n + s - tau(s)`` with linear interpolation. With ``tau0 ==
    tau1`` integer the reads are exact samples; a gliding delay advances
    ``1 - dtau / n`` dry samples per output sample, the per-path Doppler
    rate. Reads before the window are 0. The ramp ``s / n`` multiplies by
    the float32 ``1 / n``, as XLA compiles the jitted JAX step (eager JAX
    divides)."""
    dry_bands = dry_window[None, :] if dry_window.dim() == 1 else dry_window
    dev = dry_bands.device
    if tau0.dim() == 2:
        off = torch.arange(-1, 2, dtype=torch.float32, device=dev)
        tau0 = tau0[:, :, None] + off
        tau1 = tau1[:, :, None] + off
    if tau0.dim() == 3:
        tau0 = tau0[..., None]
        tau1 = tau1[..., None]
    if g0.dim() == 3:
        g0 = g0[..., None]
        g1 = g1[..., None]
    k, wd = dry_bands.shape
    s = torch.arange(n, dtype=torch.float32, device=dev)
    r = s * float(np.float32(1.0) / np.float32(max(1, n)))
    tau = tau0[..., None] + (tau1 - tau0)[..., None] * r  # [L, A, 3, K, n]
    g = g0[..., None] + (g1 - g0)[..., None] * r
    p = (wd - n) + s - tau
    lo = torch.floor(p)
    frac = p - lo
    lo_i = lo.to(torch.int64).clamp(0, wd - 1)
    hi_i = (lo_i + 1).clamp(0, wd - 1)
    kk = torch.arange(k, device=dev)[None, None, None, :, None]
    y = dry_bands[kk, lo_i] * (1.0 - frac) + dry_bands[kk, hi_i] * frac
    y = torch.where((p >= 0) & (p <= wd - 1), y, 0.0)
    return torch.where(valid[:, :, None, None, None], g * y,
                       0.0).sum(dim=(1, 2, 3))


def _window_length(dry_window) -> int:
    """The samples of a dry-history window (a tensor or a
    :class:`DryWindow`)."""
    return (dry_window.wd if isinstance(dry_window, DryWindow)
            else dry_window.shape[-1])


def _window_taps(dry_window, k: int, tau0, tau1, g0, g1, valid, n: int,
                 split: str = "linear", sample_rate: Optional[int] = None
                 ) -> torch.Tensor:
    """A chunk's taps from its dry-history window (a tensor or a
    :class:`DryWindow`): the input gate, the band split
    (:func:`_band_windows` in ``split``'s bands), :func:`_tap_chunk`. A
    one-band DryWindow on the card goes to :func:`_tap_chunk` as it is:
    the synthesis kernel reads it from the clip, gated, and no window
    tensor is built."""
    if isinstance(dry_window, DryWindow):
        if k == 1 and dry_window.dry.device.type == "cuda":
            return _tap_chunk(dry_window, tau0, tau1, g0, g1, valid, n)
        dry_window = dry_window.tensor()
    return _tap_chunk(_band_windows(cv.gate_input(dry_window), k, split,
                                    sample_rate), tau0, tau1, g0, g1, valid,
                      n)


def _per_arrival_parts(dry_piece: torch.Tensor, dry_window,
                       carry: ArrivalCarry, cur_ir: torch.Tensor,
                       is_first: bool, n: int, k: int,
                       n_taps: int = _ARRIVAL_TAPS,
                       match_bins: float = _ARRIVAL_MATCH_BINS,
                       split: str = "linear",
                       sample_rate: Optional[int] = None):
    """The per-arrival chunk step: extract, match and synthesize the taps
    and convolve the residuals. Returns ``(wet[L, N+T], taps[L, n],
    new_carry)``: ``wet`` the crossfaded residual convolution, ``taps``
    the per-path Doppler signal of this chunk's output samples,
    ``new_carry`` this chunk's table and residual for the next chunk.
    The previous chunk's products arrive in ``carry``; on the first chunk
    (``is_first``, a host bool) they are this chunk's own, the fade-in
    rule of every stream mode. Banded IRs (K > 1) share one delay glide
    per arrival with per-band window gains, read from band-split dry
    (the bands of ``split`` at ``sample_rate``, as the crossfade's).
    ``dry_window`` is the history window, a tensor or a
    :class:`DryWindow`."""
    early_bins = _window_length(dry_window) - n - 2
    with span("arrival.extract"):
        idx_c, g3_c, val_c = _arrival_table(cur_ir, early_bins, n_taps)
        cur_res = _remove_taps(cur_ir, idx_c, val_c)
    new_carry = ArrivalCarry(cur_res, idx_c, g3_c, val_c)
    prev = new_carry if is_first else carry
    with span("arrival.taps"):
        tau0, g0, matched_prev, _, _ = _match_arrivals(
            idx_c, val_c, prev.idx, prev.g3, prev.val, match_bins)
        # A vanished arrival (valid in prev, matched by no current tap)
        # fades out as a tap at its own delay: the previous chunk's tail
        # was pushed without its bins, and the residual crossfade
        # convolves only this chunk's dry. The fade-outs ride the same
        # _tap_chunk call as the current taps (concatenated along the tap
        # axis).
        tau_p = prev.idx.to(torch.float32)
        vanished = prev.val & ~matched_prev
        taps = _window_taps(
            dry_window, k, torch.cat([tau0, tau_p], dim=1),
            torch.cat([idx_c.to(torch.float32), tau_p], dim=1),
            torch.cat([g0, prev.g3], dim=1),
            torch.cat([g3_c, torch.zeros_like(prev.g3)], dim=1),
            torch.cat([val_c, vanished], dim=1), n, split, sample_rate)
    with span("arrival.convolve"):
        wet = _crossfaded_wet(dry_piece, prev.res, cur_res, split,
                              sample_rate)
    return wet, taps, new_carry


def _ear_fields(w3, x3, y3, idx, facing, sign: float, sample_rate: int,
                head_radius: float, shadow: float, speed_of_sound,
                n_t: int, decorr: bool):
    """Per-ear DirAC decode of one tap table's window bins, the per-bin
    rule of :meth:`..spatial.SpatialIR.binaural` applied to the 3-bin
    windows ``w3/x3/y3 [L, A, 3, K]`` at bins ``idx[L, A]`` (``sign`` +1
    left ear, -1 right). Each window bin's coherent part ``min(|XY|, W)``
    sits at the ITD-shifted ``clip(b - sign * max_shift * sin(phi))`` with
    the head-shadow gain, the diffuse rest at the unshifted bin through
    the ear's random signs. Returns ``(tau_coh, g_coh, tau_dif, g_dif)``,
    each ``[L, A, 3, K]``: tap parameters whose synthesis reproduces the
    removed bins' ear deposits (the tap's interpolated read is the
    decode's two-bin splat, through the convolution). ``max_shift``
    divides by the stream's float32 speed of sound, as JAX's traced
    step does."""
    from . import spatial as spm
    r = torch.sqrt(x3 * x3 + y3 * y3)
    coh = torch.minimum(r, w3)
    dif = w3 - coh
    s = torch.sin(torch.atan2(y3, x3) - facing)
    raw = idx[:, :, None] + torch.arange(-1, 2, device=idx.device)
    bins = raw.to(torch.float32)[..., None]               # [L, A, 3, 1]
    max_shift = (torch.full_like(speed_of_sound, head_radius)
                 / speed_of_sound) * float(sample_rate)
    tau_coh = torch.clamp(bins - sign * max_shift * s, 0.0, float(n_t - 1))
    g_coh = coh * (1.0 + sign * shadow * s)
    tau_dif = torch.clamp(bins, 0.0, float(n_t - 1)).expand(g_coh.shape)
    if decorr:
        signs = spm._ear_signs_tensor(n_t, 0 if sign > 0 else 1,
                                      w3.device)[0, :, 0]
        g_dif = dif * signs[raw.clamp(0, n_t - 1)][..., None]
    else:
        g_dif = dif
    return tau_coh, g_coh, tau_dif, g_dif


class EarTaps(NamedTuple):
    """A binaural chunk's ear-tap rows: ``tau0``/``tau1``/``g0``/``g1``
    ``[2L, 4A, 3, K]`` (left ear's rows first; per ear this chunk's taps
    coherent, then diffuse, then the vanished taps' fade-outs, coherent
    and diffuse) and their ``valid [2L, 4A]``; the match behind them,
    ``j``/``mutual``/``vanished [L, A]`` (:func:`_match_arrivals`)."""

    tau0: torch.Tensor
    tau1: torch.Tensor
    g0: torch.Tensor
    g1: torch.Tensor
    valid: torch.Tensor
    j: torch.Tensor
    mutual: torch.Tensor
    vanished: torch.Tensor


def _ear_taps(cur: ArrivalCarry, prev: ArrivalCarry, facing, prev_facing,
              n_t: int, sample_rate: int, head_radius: float, shadow: float,
              speed_of_sound, decorrelate: bool, match_bins: float
              ) -> EarTaps:
    """The ear-tap rows of this chunk's binaural tap table ``cur`` (at
    ``facing``) gliding from the previous chunk's ``prev`` (at
    ``prev_facing``): the taps matched (:func:`_match_arrivals`), each
    path tap four ear taps (:func:`_ear_fields`), a matched tap's rows
    starting from its previous tap's fields, a new one fading in at its
    own, and the previous taps no current one matched fading out. The CPU
    path of ``ops/cuda/arrival_taps_kernel.py::ear_taps`` and the oracle
    of its kernel."""
    _, _, matched_prev, j, mutual = _match_arrivals(
        cur.idx, cur.val, prev.idx, prev.g3, prev.val, match_bins)
    vanished = prev.val & ~matched_prev
    decorr = decorrelate and not (head_radius == 0.0 and shadow == 0.0)
    li = torch.arange(cur.idx.shape[0], device=cur.idx.device)[:, None]
    mu = mutual[:, :, None, None]
    ear_tau0, ear_tau1, ear_g0, ear_g1 = [], [], [], []
    for sign in (1.0, -1.0):
        tc_c, gc_c, td_c, gd_c = _ear_fields(
            cur.g3, cur.x3, cur.y3, cur.idx, facing, sign, sample_rate,
            head_radius, shadow, speed_of_sound, n_t, decorr)
        tc_p, gc_p, td_p, gd_p = _ear_fields(
            prev.g3, prev.x3, prev.y3, prev.idx, prev_facing, sign,
            sample_rate, head_radius, shadow, speed_of_sound, n_t, decorr)
        # rows: cur coherent, cur diffuse, fade-out coherent, diffuse
        ear_tau0.append(torch.cat(
            [torch.where(mu, tc_p[li, j], tc_c),
             torch.where(mu, td_p[li, j], td_c), tc_p, td_p], dim=1))
        ear_tau1.append(torch.cat([tc_c, td_c, tc_p, td_p], dim=1))
        ear_g0.append(torch.cat(
            [torch.where(mu, gc_p[li, j], 0.0),
             torch.where(mu, gd_p[li, j], 0.0), gc_p, gd_p], dim=1))
        ear_g1.append(torch.cat(
            [gc_c, gd_c, torch.zeros_like(gc_p), torch.zeros_like(gd_p)],
            dim=1))
    rows_valid = torch.cat([cur.val, cur.val, vanished, vanished], dim=1)
    return EarTaps(torch.cat(ear_tau0), torch.cat(ear_tau1),
                   torch.cat(ear_g0), torch.cat(ear_g1),
                   torch.cat([rows_valid, rows_valid]), j, mutual, vanished)


def _per_arrival_binaural(dry_piece: torch.Tensor, dry_window,
                          carry: ArrivalCarry, cur_sp: torch.Tensor,
                          prev_facing, cur_facing, is_first: bool, n: int,
                          sample_rate: int, head_radius: float,
                          shadow: float, speed_of_sound, decorrelate: bool,
                          n_taps: int = _ARRIVAL_TAPS,
                          match_bins: float = _ARRIVAL_MATCH_BINS,
                          split: str = "linear"):
    """Binaural per-arrival Doppler: the per-path glides and the two-ear
    decode together. Taps come from the spatial capture's W channel
    ``[3, T, K] -> w`` and are matched as in :func:`_per_arrival_parts`;
    each path tap becomes four ear taps (2 ears x coherent/diffuse) whose
    per-bin delays carry the path's glide plus the ear's ITD from X/Y at
    the tap bins and whose gains carry the ILD (:func:`_ear_fields`). The
    residual capture (tap bins zeroed in all three pattern rows) goes
    through the ordinary binaural decode and the crossfade. Returns
    ``(wet[2, N+T], taps[2, n], new_carry)``. The previous chunk's side
    arrives in ``carry`` (its W table, X/Y windows and decoded residual),
    so the only full-IR work per chunk is the current capture's: one
    table, one removal, one decode. The ear-tap rows are
    :func:`_ear_taps`' (on the card one launch of its kernel,
    ``ops/cuda/arrival_taps_kernel.py::ear_taps``); ``dry_window`` is the
    history window, a tensor or a :class:`DryWindow`; ``split`` the band
    split of the taps and the crossfade."""
    from . import spatial as spm
    k = cur_sp.shape[-1]
    n_t = cur_sp.shape[-2]
    # The far ear's ITD shift adds to a tap's delay, but the history
    # window has only 2 bins of slack past the tap window: shrink the
    # extraction window by a host ITD pad (c >= 100 m/s) so arrivals in its
    # last bins stay in the residual, which renders any delay exactly.
    itd_pad = int(np.ceil(head_radius * sample_rate / 100.0))
    early_bins = max(1, _window_length(dry_window) - n - 2 - itd_pad)
    with span("arrival.extract"):
        sp_c = spm.spatial_from_ir(cur_sp)
        idx_c, g3_c, val_c = _arrival_table(sp_c.w, early_bins, n_taps)
        x3_c = _window3(sp_c.x, idx_c)
        y3_c = _window3(sp_c.y, idx_c)
        rem_c = _remove_taps(cur_sp, idx_c.repeat(3, 1), val_c.repeat(3, 1))
    with span("arrival.residual"):
        res_c = spm.binaural_decode_ir(rem_c, sample_rate, cur_facing,
                                       head_radius, shadow, speed_of_sound,
                                       decorrelate=decorrelate)
    new_carry = ArrivalCarry(res_c, idx_c, g3_c, val_c, x3_c, y3_c)
    prev = new_carry if is_first else carry
    with span("arrival.taps"):
        ears = atk.ear_taps(new_carry, prev, cur_facing, prev_facing, n_t,
                            sample_rate, head_radius, shadow, speed_of_sound,
                            decorrelate, match_bins)
        taps = _window_taps(dry_window, k, ears.tau0, ears.tau1, ears.g0,
                            ears.g1, ears.valid, n, split,
                            sample_rate)                          # [2, n]
    with span("arrival.convolve"):
        wet = _crossfaded_wet(dry_piece, prev.res, res_c, split,
                              sample_rate)
    return wet, taps, new_carry


@dataclass(frozen=True)
class DryWindow:
    """A chunk's dry-history window, not built: ``wd`` samples of the mono
    clip ``dry`` (on the stream's device) from the host ints of
    :func:`window_scalars`, as :func:`_device_window` takes them. On the
    card the tap synthesis kernel reads it straight from the clip, gated
    (``ops/cuda/arrival_taps_kernel.py``); :meth:`tensor` builds it."""

    dry: torch.Tensor
    wd: int
    start: int
    prefix: int
    cut: int
    loop: bool

    def tensor(self) -> torch.Tensor:
        """The window ``[wd]`` (:func:`_device_window`)."""
        return _device_window(self.dry, self.wd, self.start, self.prefix,
                              self.cut, self.loop)


def _device_window(dry: torch.Tensor, wd: int, win_start: int,
                   win_prefix: int, win_cut: int, loop: bool
                   ) -> torch.Tensor:
    """The dry-history window on the clip's device: ``wd`` samples ending
    at the current chunk's end, from the host ints of
    :func:`window_scalars` (already bounded: ``win_start`` mod the clip,
    or clamped to ``[-wd, total]``), so no index array crosses to the
    device. ``win_prefix`` leading samples are pre-stream silence, and
    samples from ``win_cut`` on are post-stop silence."""
    total = dry.shape[-1]
    pos = torch.arange(wd, device=dry.device)
    ok = (pos >= win_prefix) & (pos < win_cut)
    if loop:
        idx = (pos + win_start) % total
    else:
        g = pos + win_start
        ok = ok & (g >= 0) & (g < total)
        idx = g.clamp(0, total - 1)
    return torch.where(ok, dry[..., idx], 0.0)


def window_scalars(i: int, n: int, wd: int, total: int, loop: bool,
                   stop_at: Optional[int] = None):
    """Host (Python int) ``(win_start, win_prefix, win_cut)`` of chunk
    ``i``'s history window for :func:`_device_window`. ``stop_at`` (the
    absolute dry sample of a mid-stream stop) silences everything from
    that point: arrivals in flight keep reading the history before it, so
    the stop flushes instead of clicking. Python ints do not overflow
    however long the stream runs."""
    end = (i + 1) * n
    start = end - wd
    if loop:
        win_start = start % total
        win_prefix = max(0, -start)
    else:
        win_start = max(-wd, min(start, total))
        win_prefix = 0
    win_cut = wd if stop_at is None else max(0, min(wd, stop_at - start))
    return win_start, win_prefix, win_cut


def dry_history_window(dry: torch.Tensor, i: int, n: int, early_bins: int,
                       loop: bool) -> torch.Tensor:
    """The ``early_bins + 2 + n`` dry samples ending at chunk ``i``'s end,
    the read window of :func:`_tap_chunk` (+2: the window's +-1 bin and
    the interpolation's +1 sample). Positions before the clip are
    silence; ``loop`` wraps at the clip's end only, as :func:`dry_chunk`
    does (the history before the stream began is silence, not the tail of
    a clip not yet played)."""
    wd = n + early_bins + 2
    return _device_window(dry, wd, *window_scalars(i, n, wd, dry.shape[-1],
                                                   loop), loop)


def wet_chunk(scene: Scene, params: TraceParams, prev_ir: torch.Tensor,
              dry_chunk: torch.Tensor, chunk_index: int, *, seed: int,
              n_rays: int, max_bounces: int, sample_rate: int,
              frames_per_chunk: int = 1, diffraction=False,
              air_alpha=None, uniforms=None, backend: str = "auto",
              binaural_facing=None, head_radius: float = 0.0875,
              shadow: float = 0.6, decorrelate: bool = True,
              dry_full: Optional[torch.Tensor] = None,
              win_start: Optional[int] = None,
              win_prefix: Optional[int] = None,
              win_cut: Optional[int] = None, arrival_early: int = 0,
              arrival_taps: int = _ARRIVAL_TAPS,
              arrival_match_bins: float = _ARRIVAL_MATCH_BINS,
              window_loop: bool = False,
              arrival: Optional[ArrivalCarry] = None, prev_facing=None,
              band_split: str = "linear"):
    """The chunk step before the ring (the JAX live player's
    ``wet_chunk``, shared here by the stream and the live player):
    retrace -> physics addenda -> crossfaded convolution, and per-arrival
    Doppler's taps. Returns ``(wet[L, N+T], taps[L, N] or None,
    cur_ir[L, T, K], new_carry or None)``: the wet chunk with its reverb
    tail, the taps of the chunk's own N output samples, the chunk's IR
    and the new per-arrival carry. It reads but does not change the
    carried ``prev_ir``, ``arrival`` and ``prev_facing`` (the previous
    chunk's IR, per-arrival carry and binaural facing). The caller
    overlap-adds ``wet`` at the chunk's head and then adds the taps to
    its first N samples: :func:`stream_chunk` through the tensor ring,
    ``live.LivePlayer`` through the host ring, in the same order, so the
    two agree bit for bit. Arguments as :func:`stream_chunk`'s;
    ``chunk_index`` seeds the chunk's draws and marks the first chunk;
    ``band_split`` (``ops/convolve.py::BAND_SPLITS``) names the bands of
    a banded IR in every convolution of the chunk: the crossfade and
    per-arrival Doppler's band-split dry."""
    from . import spatial as spm
    from .engine import trace_accumulate
    n = dry_chunk.shape[-1]
    l, t, k = prev_ir.shape
    binaural = binaural_facing is not None

    # 1. retrace: a fresh IR for this chunk (RayTraceManager.cs:82-85)
    with span("stream.retrace"):
        tp = spm.binaural_trace_params(params, l) if binaural else params
        ir_state = trace_accumulate(
            scene, tp, irm.IRState.zeros(t, tp.listeners.shape[0], k,
                                         device=scene.device),
            n_rays=n_rays, max_bounces=max_bounces, sample_rate=sample_rate,
            n_frames=frames_per_chunk, seed=mix_seed(seed, chunk_index),
            uniforms=uniforms, backend=backend)
    with span("stream.addenda"):
        cur_ir = _augment_ir(ir_state.normalized(), scene, tp, sample_rate,
                             diffraction, air_alpha,
                             plain=backend == "plain")        # [L, T, K]
    cur_sp = None
    if binaural:                                  # [3, T, K] -> [2, T, K]
        with span("stream.decode"):
            cur_sp = cur_ir
            cur_ir = spm.binaural_decode_ir(
                cur_sp, sample_rate, binaural_facing, head_radius, shadow,
                params.speed_of_sound, decorrelate=decorrelate)

    # The first chunk has no predecessor: fade in from the current IR.
    is_first = chunk_index == 0

    # 2. convolve + crossfade (per-arrival: the taps leave the convolution)
    with span("stream.crossfade"):
        if dry_full is None:
            prev = cur_ir if is_first else prev_ir
            return (_crossfaded_wet(dry_chunk, prev, cur_ir, band_split,
                                    sample_rate), None, cur_ir, None)
        if arrival is None:
            raise ValueError("per-arrival Doppler needs the arrival "
                             "carry: init_stream(..., arrival_taps=A) "
                             "(Streamer.process allocates it lazily)")
        window = DryWindow(dry_full, n + arrival_early + 2, win_start,
                           win_prefix, win_cut, window_loop)
        if binaural:
            if prev_facing is None:
                raise ValueError("binaural per-arrival Doppler needs the "
                                 "facing carry: init_stream(..., "
                                 "binaural=True)")
            prev_fac = binaural_facing if is_first else prev_facing
            wet, taps, new_carry = _per_arrival_binaural(
                dry_chunk, window, arrival, cur_sp, prev_fac,
                binaural_facing, is_first, n, sample_rate, head_radius,
                shadow, params.speed_of_sound, decorrelate, arrival_taps,
                arrival_match_bins, band_split)
        else:
            wet, taps, new_carry = _per_arrival_parts(
                dry_chunk, window, arrival, cur_ir, is_first, n, k,
                arrival_taps, arrival_match_bins, band_split, sample_rate)
    return wet, taps, cur_ir, new_carry


def _reset_carry(state: StreamState) -> None:
    """Drop the carried IR memory: the crossfade's previous IR and the
    per-arrival carry, so the next chunk fades in from silence."""
    state.prev_ir.zero_()
    if state.arrival is not None:
        for x in state.arrival.tensors():
            x.zero_()


def _advance(state: StreamState, cur_ir: torch.Tensor,
             new_carry: Optional[ArrivalCarry], facing) -> None:
    """Carry a chunk's IR, per-arrival products and binaural ``facing``
    (None for a stream that is not binaural) to the next chunk, in place:
    :func:`stream_chunk` inside its ring span, ``live.LivePlayer`` after
    :func:`wet_chunk`."""
    state.prev_ir.copy_(cur_ir)
    if new_carry is not None:
        state.arrival.copy_(new_carry)
    if facing is not None and state.prev_facing is not None:
        state.prev_facing.fill_(facing)
    state.chunk_index += 1


def stream_chunk(scene: Scene, params: TraceParams, state: StreamState,
                 dry_chunk: torch.Tensor, **kw
                 ) -> Tuple[torch.Tensor, StreamState]:
    """One streaming step: retrace -> physics addenda -> crossfaded
    convolution -> overlap-add -> drain. Returns ``(out_chunk[L, N],
    state)``; ``state`` is updated in place. Keyword arguments (those of
    :func:`wet_chunk`): ``seed``, ``n_rays``, ``max_bounces``,
    ``sample_rate`` (required) and the rest below. Chunk ``i`` traces
    with seed ``mix_seed(seed, i)`` unless ``uniforms`` (``emit[F, R]``,
    ``u[F, B, R, 3]``) are given. ``diffraction`` (falsy, 1 or 2) and
    ``air_alpha`` (dB/m, or None) as in :func:`_augment_ir`.
    ``band_split`` ("linear", the default, or "octave") names the bands
    of a banded IR in the chunk's convolutions (:func:`wet_chunk`).

    ``binaural_facing`` (radians, a number or a 0-d tensor) makes the
    step binaural: ``params`` carry ONE listener (the head) and ``state``
    TWO channels (the ears); the chunk traces the three-microphone
    capture ``[3, T, K]``, takes the addenda on it, and decodes it to
    ``[2, T, K]`` (:func:`..spatial.binaural_decode_ir` with
    ``head_radius``, ``shadow``, ``decorrelate`` and the traced
    ``params.speed_of_sound``) before the crossfade.

    ``dry_full`` (the clip, on the stream's device) switches on
    per-arrival Doppler: the chunk's dry-history window of ``n +
    arrival_early + 2`` samples is cut from it with the host ints
    ``win_start``, ``win_prefix`` and ``win_cut`` (:func:`window_scalars`;
    ``window_loop`` wraps it), the ``arrival_taps`` dominant early
    arrivals leave the convolution and become per-path Doppler taps
    (matched within ``arrival_match_bins``), added after the drain, and
    the residual IRs ride the crossfade. ``state.arrival`` must hold the
    carry. It composes with ``binaural_facing`` (taps from the W channel,
    per-tap bearings from X/Y driving per-ear ITD/ILD glides:
    :func:`_per_arrival_binaural`) and with banded scenes."""
    wet, taps, cur_ir, new_carry = wet_chunk(
        scene, params, state.prev_ir, dry_chunk, state.chunk_index,
        arrival=state.arrival, prev_facing=state.prev_facing, **kw)

    # 3. overlap-add at the stream position (the read head: both advance
    #    one chunk per step), drain one chunk; the taps belong to exactly
    #    this chunk's output samples
    with span("stream.ring"):
        out = state.ring.push(wet, state.ring.read_head).drain(
            dry_chunk.shape[-1])
        if taps is not None:
            out = out + taps
        _advance(state, cur_ir, new_carry, kw.get("binaural_facing"))
    return out, state


class _StreamSettings:
    """What :class:`Streamer` and ``live.LivePlayer`` share: the stream's
    fixed settings, checked once, with the constant part of
    :func:`wet_chunk`'s keywords built once; the per-chunk keywords
    (:meth:`_chunk_kw`); and the chunk loop's dry feed and controls
    (:meth:`_chunks`). The two drivers differ only in where a wet chunk
    goes: the tensor ring of :func:`stream_chunk`, or the player's host
    ring."""

    def __init__(self, scene: Scene, config: EngineConfig, seed: int = 0,
                 n_listeners: int = 1, frames_per_chunk: int = 1,
                 uniforms_fn=None, backend: str = "auto",
                 diffraction: bool = False, air_alpha=None,
                 binaural: bool = False, head_radius: float = 0.0875,
                 shadow: float = 0.6, decorrelate: bool = True,
                 arrival_taps: int = _ARRIVAL_TAPS,
                 arrival_window_s: float = _ARRIVAL_WINDOW_S,
                 arrival_match_bins: float = _ARRIVAL_MATCH_BINS,
                 band_split: str = "linear"):
        if binaural and n_listeners != 1:
            raise ValueError("binaural streaming takes one head listener")
        if arrival_taps < 1:
            raise ValueError("arrival_taps must be >= 1")
        if band_split not in cv.BAND_SPLITS:
            raise ValueError(f"band_split must be one of {cv.BAND_SPLITS}, "
                             f"got {band_split!r}")
        audio = config.audio
        self.scene = scene
        self.config = config
        self.seed = int(seed)
        self.n_listeners = 2 if binaural else n_listeners
        self.frames_per_chunk = frames_per_chunk
        self.uniforms_fn = uniforms_fn
        self.binaural = binaural
        self.head_radius = head_radius
        self.arrival_taps = int(arrival_taps)
        self.band_split = band_split
        # the early window the taps may live in (bins; fixed per stream)
        self.arrival_early = min(
            audio.ir_length,
            int(round(arrival_window_s * audio.sample_rate)))
        # chunks that flush the reverb tail once the feed ends or stops
        self._tail_chunks = (audio.ir_length + audio.chunk_samples - 1) \
            // audio.chunk_samples
        self._kw = dict(
            seed=self.seed, n_rays=config.sim.ray_count,
            max_bounces=config.sim.max_bounces,
            sample_rate=audio.sample_rate,
            frames_per_chunk=frames_per_chunk, diffraction=diffraction,
            air_alpha=air_alpha, backend=backend, head_radius=head_radius,
            shadow=shadow, decorrelate=decorrelate,
            arrival_taps=self.arrival_taps,
            arrival_match_bins=float(arrival_match_bins),
            band_split=band_split)
        self.state = self._init_state()

    def _init_state(self) -> StreamState:
        """A fresh carried state (the arrival carry comes with the first
        per-arrival chunk, :meth:`_chunk_kw`)."""
        audio = self.config.audio
        return init_stream(audio.ir_length, audio.chunk_samples,
                           self.n_listeners, self.scene.n_bands,
                           binaural=self.binaural, device=self.scene.device)

    def _chunk_kw(self, state: StreamState, facing, window) -> dict:
        """:func:`wet_chunk`'s keywords for chunk ``state.chunk_index``:
        the settings', its uniforms, its binaural facing and, for
        per-arrival Doppler, its ``window`` ``(dry_full, win_start,
        win_prefix, win_cut, loop)``. The first per-arrival chunk
        allocates ``state.arrival``, so other streams never carry it."""
        i = state.chunk_index
        kw = dict(self._kw,
                  uniforms=self.uniforms_fn(i) if self.uniforms_fn else None,
                  binaural_facing=float(facing) if self.binaural else None)
        if window is not None:
            if state.arrival is None:
                state.arrival = init_arrival_carry(
                    self.config.audio.ir_length, self.n_listeners,
                    self.scene.n_bands, self.arrival_taps, self.binaural,
                    self.scene.device)
            dry_full, win_start, win_prefix, win_cut, loop = window
            kw.update(dry_full=dry_full, win_start=win_start,
                      win_prefix=win_prefix, win_cut=win_cut,
                      arrival_early=self.arrival_early, window_loop=loop)
        return kw

    def _window(self, dry: torch.Tensor, i: int, loop: bool,
                stop_at: Optional[int] = None) -> tuple:
        """Chunk ``i``'s per-arrival ``window`` for :meth:`_chunk_kw`: the
        clip and the host ints of :func:`window_scalars`."""
        n = self.config.audio.chunk_samples
        return (dry,) + window_scalars(i, n, n + self.arrival_early + 2,
                                       dry.shape[-1], loop, stop_at) + (loop,)

    def _chunks(self, state: StreamState, dry: torch.Tensor, params_fn,
                n_steps: int, loop: bool, doppler, control_fn, scene_fn,
                facing_fn, on_stop=None):
        """The chunk loop's feed: yields ``(i, dry piece, params, scene,
        facing, window)`` for chunk ``i`` of ``n_steps``, ``window``
        :meth:`_window`'s (None unless ``doppler="per_arrival"``). The dry piece is :class:`DopplerFeed`'s
        for ``doppler=True``, else :func:`dry_chunk`'s. ``control_fn(i)``
        comes first: ``"reset_ir"`` resets ``state``'s carry; ``"stop"``
        silences the feed from sample ``i * n`` and ends the loop after
        the reverb tail's chunks, calling ``on_stop(end_step)``."""
        n = self.config.audio.chunk_samples
        per_arrival = doppler == "per_arrival"
        feed = DopplerFeed(dry, params_fn, n, self.config.audio.sample_rate,
                           n_steps, loop) if (doppler and not per_arrival) \
            else None
        stop_at = None
        i, end_step = 0, n_steps
        while i < end_step:
            if control_fn is not None:
                ctrl = control_fn(i) or {}
                if ctrl.get("reset_ir"):
                    _reset_carry(state)
                if ctrl.get("stop") and stop_at is None:
                    stop_at = i * n
                    end_step = min(end_step, i + self._tail_chunks)
                    if on_stop is not None:
                        on_stop(end_step)
            if stop_at is not None:
                piece = torch.zeros(n, dtype=dry.dtype, device=dry.device)
            else:
                piece = (feed.chunk(i) if feed is not None
                         else dry_chunk(dry, i, n, loop))
            window = (self._window(dry, i, loop, stop_at) if per_arrival
                      else None)
            scene = scene_fn(i) if scene_fn is not None else self.scene
            facing = facing_fn(i) if facing_fn is not None else 0.0
            yield i, piece, params_fn(i), scene, facing, window
            i += 1


class Streamer(_StreamSettings):
    """Host-side driver of the streaming loop (the reference's
    ``StartStreaming``, ``RayTraceManager.cs:125-133``). Poses may change
    every chunk. ``seed`` names the random stream; ``uniforms_fn(i) ->
    (emit[F, R], u[F, B, R, 3])`` replaces chunk ``i``'s draws.
    ``diffraction`` (False, 1 or 2) and ``air_alpha`` add edge
    diffraction and air absorption to every chunk's IR. ``binaural``
    streams one head listener to two ear channels (``n_listeners`` is 2
    then), decoded with ``head_radius``, ``shadow`` and ``decorrelate``
    at the facing :meth:`process` is given. ``arrival_taps`` (taps per
    listener), ``arrival_window_s`` (the early window they may live in)
    and ``arrival_match_bins`` (the largest drift matched chunk to chunk)
    tune per-arrival Doppler. ``band_split`` names the bands of a banded
    scene's convolutions: "linear" (K equal bands of [0, Nyquist], the
    JAX package's) or "octave" (bands about the centres the air, the
    diffraction and the banded materials are computed at,
    ``ops/convolve.py::octave_filterbank``)."""

    def reset_ir(self) -> None:
        """The reference's R key (``RayTraceManager.cs:58-61``): drop the IR
        memory, the crossfade's previous IR and the per-arrival carry, so
        the next chunk fades in from silence. Audio already in the ring
        keeps playing."""
        _reset_carry(self.state)

    def process(self, dry_chunk: torch.Tensor, params: TraceParams,
                scene: Optional[Scene] = None, facing: float = 0.0,
                window=None) -> torch.Tensor:
        """One chunk; ``scene`` overrides the bound scene for this chunk
        (dynamic obstacles, ``RayTraceManager.cs:67``); ``facing``
        (radians) steers the decode of a binaural streamer. ``window``
        (per-arrival Doppler) is ``(dry_full, win_start, win_prefix,
        win_cut, loop)``: the clip on the stream's device and the history
        window's host ints from :func:`window_scalars`."""
        out, self.state = stream_chunk(
            scene if scene is not None else self.scene, params, self.state,
            dry_chunk, **self._chunk_kw(self.state, facing, window))
        return out

    def stream_clip(self, dry: torch.Tensor, params_fn, scene_fn=None,
                    pad_tail: bool = True, loop: Optional[bool] = None,
                    total_chunks: Optional[int] = None, on_chunk=None,
                    facing_fn=None, doppler=False,
                    control_fn=None) -> torch.Tensor:
        """Stream a whole clip; ``params_fn(i) -> TraceParams`` supplies the
        poses and ``scene_fn(i) -> Scene`` optional per-chunk geometry.
        Returns wet audio ``[L, total]``.

        ``loop`` (``RayTraceManager.cs:74-77``): when set, the dry feed
        restarts at the clip head for ``total_chunks`` chunks (required);
        when clear, the clip plays once and ``pad_tail`` flushes the reverb
        tail. ``None`` honors ``config.audio.loop`` for timed streams.
        ``on_chunk(i, state)`` runs after every chunk. ``facing_fn(i)``
        gives a binaural streamer's head facing (radians) at chunk ``i``.
        ``control_fn(i) -> dict``: a truthy ``"reset_ir"`` applies
        :meth:`reset_ir` before chunk ``i``; a truthy ``"stop"`` silences
        the dry feed from chunk ``i``, flushes ``ir_length`` worth of
        chunks and ends the stream (the per-arrival taps keep reading the
        history before the stop, so it flushes without a click).

        ``doppler=True`` adds the pitch shift of a moving pose: the dry
        feed is read at ``1 - v/c`` dry samples per output sample
        (:class:`DopplerFeed`), ``v`` the radial velocity of the first
        source toward the first listener from consecutive ``params_fn``
        poses; every path shares the direct path's rate. The last chunk
        reuses the previous chunk's rate, and a one-chunk stream plays at
        rate 1.

        ``doppler="per_arrival"``: the dominant early arrivals of each
        chunk's IR become per-path fractional-delay taps whose delays
        glide chunk to chunk, so the direct sound and each early
        reflection carry their own rates (a source approaching the
        listener but receding from the back wall shifts the direct sound
        up and the echo down); the late field stays in the crossfaded
        convolution. The rates come from the IRs, so no pose lookahead is
        needed and geometry-driven delay changes (a moving obstacle) are
        heard too. It works on mono, multi-listener, banded and binaural
        streams."""
        if loop is None:
            loop = self.config.audio.loop and total_chunks is not None
        if loop and total_chunks is None:
            raise ValueError("loop=True streams forever; pass total_chunks")
        n_steps = total_chunks
        if n_steps is None:
            n = self.config.audio.chunk_samples
            n_steps = (dry.shape[-1] + n - 1) // n + (
                self._tail_chunks if pad_tail else 0)
        chunks = []
        for i, piece, params, scene, facing, window in self._chunks(
                self.state, dry, params_fn, n_steps, loop, doppler,
                control_fn, scene_fn, facing_fn):
            chunks.append(self.process(piece, params, scene, facing=facing,
                                       window=window))
            if on_chunk is not None:
                on_chunk(i, self.state)
        return torch.cat(chunks, dim=-1)


def warp_chunk(dry: torch.Tensor, base: int, frac0: float, rate: float,
               n: int, loop: bool = False) -> torch.Tensor:
    """Read ``n`` output samples from the dry clip from the fractional
    position ``base + frac0`` (``base`` whole samples, a host int;
    ``frac0`` in [0, 1)), advancing ``rate`` dry samples per output sample
    with linear interpolation: the Doppler dry feed. ``frac0`` and
    ``rate`` are handed over as float32, as JAX's jitted step takes them.

    A pose moving at radial velocity ``v`` (positive = receding) warps the
    received signal ``y(t) = x(t (1 - v/c) - d0/c)``: the delay ``d0/c``
    lives in the traced IR's direct bin, the rate ``1 - v/c`` here. The
    split position keeps every float small (``frac0 + rate * n`` is under
    a chunk); the host carries the absolute position in float64
    (:class:`DopplerFeed`). ``loop`` wraps the read modulo the clip;
    otherwise reads past the end are silence (tail flush).

    The read position ``frac0 + rate * s`` and the interpolation ``a (1 -
    frac) + b frac`` are each rounded once to float32 from a float64
    value: the fused multiply-adds XLA makes of them in the jitted JAX
    step on the CPU, where float32 throughout differs by an ulp in ~40%
    of the samples. The float64 work is a few vectors of ``n``."""
    total = dry.shape[-1]
    s = torch.arange(n, dtype=torch.float64, device=dry.device)
    idx = (s * float(np.float32(rate))
           + float(np.float32(frac0))).to(torch.float32)
    lo = torch.floor(idx)
    frac = idx - lo
    lo_i = lo.to(torch.int64) + int(base)
    if loop:
        a = dry[..., lo_i % total]
        b = dry[..., (lo_i + 1) % total]
    else:
        a = torch.where((lo_i >= 0) & (lo_i < total),
                        dry[..., lo_i.clamp(0, total - 1)], 0.0)
        b = torch.where((lo_i + 1 >= 0) & (lo_i + 1 < total),
                        dry[..., (lo_i + 1).clamp(0, total - 1)], 0.0)
    return (a.to(torch.float64) * (1.0 - frac).to(torch.float64)
            + (b * frac).to(torch.float64)).to(torch.float32)


def _host_f32(x) -> np.ndarray:
    """``x`` as a float32 numpy array on the host (a copy from the card
    where ``x`` lives there)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class DopplerFeed:
    """The Doppler dry feed of :meth:`Streamer.stream_clip` (JAX shares it
    with its live player, so the two agree sample for sample).

    Per chunk ``i`` the radial velocity of the first source toward the
    first listener comes from consecutive ``params_fn`` poses: ``rate = 1
    - (d(i+1) - d(i)) * sr / (n * c)`` dry samples per output sample, in
    float64 on the host (the last chunk reuses the last rate, since
    ``params_fn``'s domain is ``[0, n_steps)``; a one-chunk stream has no
    pose pair and plays unshifted). The absolute read position
    accumulates in float64 and goes to :func:`warp_chunk` as an exact int
    and a float32 fraction.

    The poses are read on the host, as JAX's ``np.asarray`` reads them:
    where they are CUDA tensors that is a small copy from the card (and a
    wait for it) each chunk."""

    def __init__(self, dry: torch.Tensor, params_fn, n: int,
                 sample_rate: int, n_steps: int, loop: bool):
        self.dry = dry
        self.params_fn = params_fn
        self.n = n
        self.sample_rate = sample_rate
        self.n_steps = n_steps
        self.loop = loop
        self.total = dry.shape[-1]
        self.pos = 0.0            # float64 absolute dry read position
        self.rate = 1.0
        self._d_prev = self._pose_distance(0)

    def _pose_distance(self, i: int) -> float:
        p = self.params_fn(i)
        src = _host_f32(p.source).reshape(-1, 2)[0]
        lis = _host_f32(p.listeners).reshape(-1, 2)[0]
        return float(np.hypot(*(src - lis)))

    def chunk(self, i: int) -> torch.Tensor:
        """The ``n`` warped dry samples of chunk ``i`` (call in order)."""
        if i + 1 < self.n_steps:
            c = float(_host_f32(self.params_fn(i).speed_of_sound))
            d_next = self._pose_distance(i + 1)
            self.rate = 1.0 - ((d_next - self._d_prev) * self.sample_rate
                               / (self.n * c))
            self._d_prev = d_next
        pos = self.pos
        if self.loop:
            pos %= float(self.total)
        else:
            # past-the-end reads are silence however far past; the cap
            # keeps the base small on endless streams
            pos = min(pos, float(self.total) + 1.0)
        base = math.floor(pos)
        piece = warp_chunk(self.dry, base, pos - base, self.rate, self.n,
                           loop=self.loop)
        self.pos += self.rate * self.n
        if self.loop:
            self.pos %= float(self.total)
        return piece


def dry_chunk(dry: torch.Tensor, i: int, n: int, loop: bool
              ) -> torch.Tensor:
    """Chunk ``i`` of the dry feed. Looping wraps the clip modulo its
    length (``RayTraceManager.cs:74-77``); without loop the post-clip feed
    is silence (tail flush)."""
    total = dry.shape[-1]
    lo = i * n
    if loop:
        idx = ((lo % total) + torch.arange(n, device=dry.device)) % total
        return dry[..., idx]
    piece = dry[..., lo:lo + n]
    if piece.shape[-1] < n:
        piece = torch.nn.functional.pad(piece, (0, n - piece.shape[-1]))
    return piece
