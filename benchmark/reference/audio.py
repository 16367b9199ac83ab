"""The plain reference of a stream's output: each chunk convolved with the
previous and the current chunk's IR and crossfaded, overlap-added into a
ring that plays one chunk at a time.

Chunk ``k`` (dry samples ``x_k``, ``N`` of them; IRs of ``T`` bins) is
gated (samples of magnitude at most 1e-4 are dropped, the reference
Unity project's ``AudioConvolve.compute:25``), convolved in full against
``IR_{k-1}`` and ``IR_k`` (``IR_0`` for both at the first chunk), and the
two are blended by a ramp that rises from 0 to 1 over the chunk's ``N``
samples and stays at 1 over the tail: ``wet_k[n] = (1 - ramp[n]) y_prev[n]
+ ramp[n] y_cur[n]``, ``N + T`` samples. Chunk ``j`` of the output is the
sum, over every earlier chunk whose tail reaches it, of ``wet_k[(j - k) N
: (j - k + 1) N]``. Computed in float64 by FFT.
"""

from __future__ import annotations

from typing import Callable

import torch

GATE = 1e-4


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to a type the FFT takes: the
    FFT has no bfloat16, so the lower-precision control rounds every
    input and output of it to bfloat16."""
    if dtype in (torch.float32, torch.float64):
        return x.to(dtype)
    return x.to(dtype).to(torch.float32)


def wet(dry: torch.Tensor, ir_prev: torch.Tensor, ir_cur: torch.Tensor,
        dtype=torch.float64) -> torch.Tensor:
    """One chunk's wet samples ``[L, N + T]`` from dry ``[N]`` and the IRs
    ``[L, T]``."""
    x = _round(dry, dtype)
    x = torch.where(x.abs() > GATE, x, 0.0)
    n, t = x.shape[-1], ir_cur.shape[-1]
    out = n + t
    n_fft = _pow2(out)
    spec = torch.fft.rfft(x, n_fft)
    y_prev = torch.fft.irfft(spec * torch.fft.rfft(_round(ir_prev, dtype),
                                                   n_fft), n_fft)[..., :out]
    y_cur = torch.fft.irfft(spec * torch.fft.rfft(_round(ir_cur, dtype),
                                                  n_fft), n_fft)[..., :out]
    y_prev, y_cur = _round(y_prev, dtype), _round(y_cur, dtype)
    ramp = torch.clamp(torch.arange(out, dtype=y_cur.dtype,
                                    device=y_cur.device) / n, max=1.0)
    return _round(y_prev * (1.0 - ramp) + y_cur * ramp, dtype)


def output_chunk(j: int, n: int, t: int,
                 dry_of: Callable[[int], torch.Tensor],
                 ir_of: Callable[[int], torch.Tensor],
                 dtype=torch.float64) -> torch.Tensor:
    """Output chunk ``j`` ``[L, N]``: ``dry_of(k)`` gives chunk ``k``'s dry
    samples, ``ir_of(k)`` its IR ``[L, T]``."""
    reach = (n + t - 1) // n               # earlier chunks whose tail reaches
    total = None
    for k in range(max(0, j - reach), j + 1):
        prev = ir_of(k - 1) if k > 0 else ir_of(k)
        part = wet(dry_of(k), prev, ir_of(k), dtype)
        piece = part[..., (j - k) * n:(j - k + 1) * n].to(torch.float64)
        piece = torch.nn.functional.pad(piece, (0, n - piece.shape[-1]))
        total = piece if total is None else total + piece
    return total
