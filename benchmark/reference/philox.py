"""Counter-based random numbers of the trace, worked out independently.

Every ray's numbers are named by a Philox-4x32-10 counter (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC'11): words (ray, frame,
bounce, entry) under a key made of the 64-bit seed's two halves. Words
0-2 of counter bounce ``b`` are that bounce's three uniforms (transmission
test, refraction jitter, diffuse angle) and word 0 of counter bounce ``B``
is the ray's emission jitter; a uniform is a word's top 24 bits times
2^-24. A stream chunk ``i`` traces under the seed ``mix_seed(seed, i)``
(SplitMix64's finalizer).

Plain integer arithmetic on int64 tensors holding uint32 words; no code of
the measured program.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def mix_seed(seed: int, *values: int) -> int:
    """SplitMix64's finalizer folded over ``values``."""
    h = int(seed) & M64
    for v in values:
        h = (h + 0x9E3779B97F4A7C15 + (int(v) & M64)) & M64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & M64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & M64
        h ^= h >> 31
    return h


def _mul_hi_lo(a: int, b: torch.Tensor):
    """The high and low words of the 64-bit product of the constant ``a``
    and the uint32 words ``b``, without leaving int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    upper = a_hi * b
    lower = a_lo * b
    mid = upper + (lower >> 16)
    return (mid >> 16) & M32, ((mid & 0xFFFF) << 16) | (lower & 0xFFFF)


def philox(c0, c1, c2, c3, seed: int):
    """Ten Philox-4x32 rounds on the counter words under ``seed``'s key."""
    s = int(seed) & M64
    k0, k1 = s & M32, s >> 32
    for r in range(10):
        hi0, lo0 = _mul_hi_lo(PHILOX_M0, c0)
        hi1, lo1 = _mul_hi_lo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0 = (k0 + PHILOX_W0) & M32
            k1 = (k1 + PHILOX_W1) & M32
    return c0, c1, c2, c3


def to_unit(word: torch.Tensor) -> torch.Tensor:
    """A word's top 24 bits as a float32 in [0, 1)."""
    return (word >> 8).to(torch.float32) * (2.0 ** -24)


def ray_uniforms(seed: int, ray: torch.Tensor, frame: torch.Tensor,
                 entry: torch.Tensor, bounce: int) -> torch.Tensor:
    """``[n, 3]`` float32 uniforms of bounce ``bounce`` for the rays named
    by the int64 tensors ``ray``, ``frame`` and ``entry``."""
    w0, w1, w2, _ = philox(ray, frame, torch.full_like(ray, bounce),
                           entry & M32, seed)
    return torch.stack([to_unit(w0), to_unit(w1), to_unit(w2)], dim=-1)


def emission_jitter(seed: int, ray: torch.Tensor, frame: torch.Tensor,
                    entry: torch.Tensor, n_bounces: int) -> torch.Tensor:
    """``[n]`` float32 emission jitter: word 0 at counter bounce
    ``n_bounces``."""
    w0, _, _, _ = philox(ray, frame, torch.full_like(ray, n_bounces),
                         entry & M32, seed)
    return to_unit(w0)
