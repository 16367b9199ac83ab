"""Counter-based random numbers (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/ops/rng.py``. JAX's threefry
keys are not reproduced: the trace takes its uniforms as an argument, so
the parity tests hand it JAX's own draws. Two sources make them here:

* :func:`bounce_uniforms` draws from an explicit ``torch.Generator``;
* :func:`philox_uniforms` computes the Philox-4x32-10 stream that the
  hand kernel (``csrc/bounce_kernel.cu``, K4 and K9 modes) draws on the
  card, bit for bit, from an integer seed and a batch-entry id. The plain path uses it for seeded
  traces, so a seed names the same rays on the CPU and on the card.

:func:`hlsl_random` is the reference's PCG-style hash
(``Assets/Script/Common.hlsl:8-12``), bit-exact. torch's uint32 support
is partial, so all 32-bit integer arithmetic here runs in int64 with a
``& 0xFFFFFFFF`` mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import resolve

_M32 = 0xFFFFFFFF
_MUL1 = 747796405
_INC = 2891336453
_MUL2 = 277803737
_U32_MAX = 4294967295.0

# Philox-4x32-10 constants (Salmon et al., SC'11; the same values as the
# kernel's).
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def hlsl_random(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the reference's inout-state hash RNG.

    ``state`` holds uint32 values in any integer tensor. Returns
    ``(value in [0, 1] float32, new_state int64)``:
        state = state * 747796405 + 2891336453
        res   = ((state >> ((state >> 28) + 4)) ^ state) * 277803737
        value = ((res >> 22) ^ res) / 4294967295
    """
    state = state.to(torch.int64) & _M32
    state = (state * _MUL1 + _INC) & _M32
    shift = (state >> 28) + 4
    res = (((state >> shift) ^ state) * _MUL2) & _M32
    res = (res >> 22) ^ res
    return (res.to(torch.float32) / torch.tensor(_U32_MAX, dtype=torch.float32),
            state)


def ray_init_state(n_rays: int, frame: int, device=None) -> torch.Tensor:
    """Reference per-ray seed: ``id.x + rngStateOffset * 719393``
    (``Raytrace2D.compute:51``), as uint32 values in int64."""
    ids = torch.arange(n_rays, dtype=torch.int64, device=resolve(device))
    return (ids + 719393 * int(frame)) & _M32


def mix_seed(seed: int, *values: int) -> int:
    """Fold integers into a 64-bit seed with SplitMix64's finalizer: the
    stream derives chunk ``i``'s seed as ``mix_seed(seed, i)``."""
    h = int(seed) & 0xFFFFFFFFFFFFFFFF
    for v in values:
        h = (h + 0x9E3779B97F4A7C15 + (int(v) & 0xFFFFFFFFFFFFFFFF)) \
            & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h


def seed_key(seed: int) -> Tuple[int, int]:
    """The two 32-bit Philox key words of an integer seed."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s & _M32, s >> 32


def _mulhilo(a: int, b: torch.Tensor):
    """32x32 -> 64-bit product split into (hi, lo) words, in int64 without
    overflow: ``a`` is split into 16-bit halves."""
    ah, al = a >> 16, a & 0xFFFF
    p_hi = ah * b                      # < 2^48
    p_lo = al * b                      # < 2^48
    mid = p_hi + (p_lo >> 16)          # product = mid * 2^16 + (p_lo & 0xFFFF)
    return (mid >> 16) & _M32, (((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF))


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 on int64 tensors holding uint32 words; returns the
    four output words."""
    for r in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r < 9:
            k0 = (k0 + PHILOX_W0) & _M32
            k1 = (k1 + PHILOX_W1) & _M32
    return c0, c1, c2, c3


def _u24(word: torch.Tensor) -> torch.Tensor:
    """Top 24 bits scaled to [0, 1), as the TPU kernels' ``_draw_uniforms``."""
    return (word >> 8).to(torch.float32) * (2.0 ** -24)


def philox_uniforms(seed: int, n_frames: int, max_bounces: int,
                    n_rays: int, device=None, entry: int = 0,
                    first_frame: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The uniforms the hand kernel draws for ``seed`` in batch entry
    ``entry``: ``emit[F, R]`` and ``u[F, B, R, 3]``.

    Counter ``(ray, frame, bounce, entry)`` under the key of ``seed``;
    words 0-2 of bounce ``b`` are that bounce's three draws, and word 0 of
    counter bounce ``B`` is the emission jitter. ``entry`` is the global
    id of a room of a sweep or a source of a mixdown (K9); the
    single-scene trace (K4) is entry 0. Streams of different entries are
    disjoint by construction. The frames are ``first_frame ..
    first_frame + F - 1``."""
    k0, k1 = seed_key(seed)
    device = resolve(device)
    ray = torch.arange(n_rays, dtype=torch.int64, device=device)
    frame = torch.arange(first_frame, first_frame + n_frames,
                         dtype=torch.int64, device=device)
    bounce = torch.arange(max_bounces + 1, dtype=torch.int64, device=device)
    c0 = ray.expand(n_frames, max_bounces + 1, n_rays)
    c1 = frame[:, None, None].expand_as(c0)
    c2 = bounce[None, :, None].expand_as(c0)
    c3 = torch.full_like(c0, int(entry) & _M32)
    w0, w1, w2, _ = philox4x32(c0, c1, c2, c3, k0, k1)
    emit = _u24(w0[:, max_bounces])
    u = torch.stack([_u24(w0[:, :max_bounces]), _u24(w1[:, :max_bounces]),
                     _u24(w2[:, :max_bounces])], dim=-1)
    return emit, u


def bounce_uniforms(generator: torch.Generator, n_frames: int,
                    max_bounces: int, n_rays: int, device=None, *,
                    n_listeners: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-draw every uniform ``n_frames`` traces consume from a torch
    Generator: ``(emit[F, R], u[F, B, R, 3])``, the 3 slots per bounce
    being transmission test, refraction jitter and diffuse angle
    (``Raytrace2D.compute:129, 137, 150``). The draws are the same for
    any ``n_listeners``, as in the JAX package's function of this name:
    every listener hears the same rays."""
    device = resolve(device)
    emit = torch.rand((n_frames, n_rays), generator=generator,
                      device=device, dtype=torch.float32)
    u = torch.rand((n_frames, max_bounces, n_rays, 3), generator=generator,
                   device=device, dtype=torch.float32)
    return emit, u
