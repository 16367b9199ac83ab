"""The binaural decode in one launch: ``binaural_decode_kernel``
(``csrc/binaural_decode_kernel.cu``).

:func:`binaural_decode` takes a ``[3L, T, K]`` spatial capture (the rows
of ``spatial.spatial_params``: W, the cardioid at 0, the cardioid at
pi/2) or a ``spatial.SpatialIR`` and returns the two-ear IR ``[2L, T,
K]``, left ear first: ``SpatialIR.binaural`` and ``binaural_decode_ir``
on every caller (the composed and plain binaural streams, the live
player, ``cli bake --binaural``). A CUDA input runs the kernel, one
launch on the current stream with no host sync, counted in
``binaural_decode.launches``, or raises ``ValueError`` on what the kernel
does not take; nothing falls back. A CPU input runs the plain chain,
``spatial.binaural_plain``, which is the oracle: the kernel computes each
source bin's splat positions and deposits with the chain's float32
operations in the chain's order, and sums each output bin's deposits in
the order of the chain's ``index_add_`` (the CPU order), so given the same
per-bin inputs it equals the CPU chain bit for bit. On the card the
chain's deterministic ``index_put_`` sums a row of 32 or more deposits in
a warp reduction instead, a few ulps away.

The kernel gathers: each output bin reads the sources within
:func:`window_half_width` bins, the window of ``max_shift`` as the card
computes it. A block keeps its tile's sources plus as much of that window
as :func:`shared_halo` holds on each side in shared memory; a source past
that is computed from global memory with the same bits.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import Optional

import numpy as np
import torch

from . import build

# output bins of a block, one a thread (csrc kDecodeTile)
TILE = 256
# the most shared source bins each side of a tile (kMaxSharedHalo: 16 B a
# source, within the 48 KB a block has without opting in)
MAX_SHARED_HALO = 1280
# float32 bin indices stay exact up to 2^24 bins (kMaxBins)
MAX_BINS = 1 << 24
# the slowest speed of sound (m/s) the shared halo covers when the speed
# is a card tensor the host cannot read without a sync (streaming's ITD
# pad assumes the same); a slower one reads past the halo from global
# memory
HALO_MIN_SPEED = 100.0


def window_half_width(max_shift: float, n_t: int) -> int:
    """The source bins each side of an output bin whose deposits can reach
    it, as the kernel computes it (``window_half_width`` there, float32):
    the target ``t = b - shift * s`` is within ``D = |max_shift| + (T +
    |max_shift|) 2^-24`` of its source ``b``, ``lo > t - 1`` and ``hi <=
    lo + 1``, so a deposit lands within ``ceil(D) + 1`` bins of its
    source; one more for the float32 rounding of ``D`` itself. The whole
    IR where ``max_shift`` is not finite or not below ``T``."""
    f32 = np.float32
    a = abs(f32(max_shift))
    if not a < f32(n_t):
        return n_t
    d = f32(a + f32(f32(n_t) + a) * f32(6.0e-8))
    return min(int(np.ceil(d)) + 2, n_t)


def max_shift_known(head_radius: float, sample_rate, speed_of_sound
                    ) -> Optional[float]:
    """The float32 ``max_shift`` of the chain where the host knows it
    without a card read: ``r / c * sample_rate`` in Python floats for a
    number ``c`` (rounded to float32 where the chain multiplies), in the
    chain's tensor operations for a CPU tensor. None for a card tensor."""
    if isinstance(speed_of_sound, torch.Tensor):
        if speed_of_sound.device.type != "cpu":
            return None
        ms = (torch.full_like(speed_of_sound, head_radius)
              / speed_of_sound) * float(sample_rate)
        return float(ms.reshape(()).to(torch.float32))
    return float(np.float32(head_radius / speed_of_sound * sample_rate))


def shared_halo(head_radius: float, sample_rate, speed_of_sound,
                n_t: int) -> int:
    """The shared source bins each side of a tile: the window of the
    ``max_shift`` the host knows, else of :data:`HALO_MIN_SPEED`, at most
    :data:`MAX_SHARED_HALO`."""
    ms = max_shift_known(head_radius, sample_rate, speed_of_sound)
    if ms is None:
        ms = head_radius / HALO_MIN_SPEED * sample_rate
    return min(window_half_width(ms, n_t), MAX_SHARED_HALO)


def _scalar(name: str, v, dev: torch.device, dtypes):
    """A number (as it is), or a one-element floating tensor: on ``dev``
    (of one of ``dtypes``) it is read by pointer, on the CPU as a host
    number. Returns ``(host number or None, card tensor or None)``."""
    if isinstance(v, numbers.Real) and not isinstance(v, bool):
        return float(v), None
    if not isinstance(v, torch.Tensor):
        raise ValueError(f"{name} must be a number or a one-element "
                         f"tensor, got {type(v).__name__}")
    if v.numel() != 1 or not v.is_floating_point():
        raise ValueError(f"{name} must be one floating element, got "
                         f"{tuple(v.shape)} {v.dtype}")
    if v.device.type == "cpu" and dev.type != "cpu":
        return float(v.reshape(())), None
    if v.device != dev:
        raise ValueError(f"{name} is on {v.device}, the IR on {dev}")
    if v.dtype not in dtypes:
        raise ValueError(f"{name} on {dev} must be one of {dtypes}, got "
                         f"{v.dtype}")
    return None, v.reshape(()).contiguous()


def decode_inputs(spatial, facing, speed_of_sound, shadow: float):
    """The inputs of one ``binaural_decode_kernel`` launch, checked before
    it: the channels ``(w, x, y)``, each ``[L, T, K]`` float32 contiguous
    on one device (views of the rows of a ``[3L, T, K]`` capture, with
    ``capture`` True: the kernel subtracts W from the cardioid rows, as
    ``spatial_from_ir`` does), ``1 <= T <= 2^24``; ``facing`` a number or
    one float32 element on that device (a CPU tensor is read as a number);
    ``speed_of_sound`` a number or one float32 or float64 element (on the
    CPU: a host value); ``shadow`` in [0, 1]. Raises ``ValueError``.
    Returns ``(w, x, y, capture, facing, facing_t, speed_t)``: the host
    facing (or None) and the card tensors (or None)."""
    if not 0.0 <= shadow <= 1.0:
        raise ValueError(f"shadow must be in [0, 1], got {shadow}")
    if isinstance(spatial, torch.Tensor):
        if spatial.dim() != 3 or spatial.shape[0] % 3 != 0 \
                or spatial.shape[0] == 0:
            raise ValueError(f"expected a [3L, T, K] capture from "
                             f"spatial_params(order=1), got "
                             f"{tuple(spatial.shape)}")
        if spatial.dtype != torch.float32:
            raise ValueError(f"the capture must be torch.float32, got "
                             f"{spatial.dtype}")
        cap = spatial.contiguous()
        n_l = cap.shape[0] // 3
        w, x, y = cap[:n_l], cap[n_l:2 * n_l], cap[2 * n_l:]
        capture = True
    else:
        w, x, y = spatial.w, spatial.x, spatial.y
        for name, ch in (("w", w), ("x", x), ("y", y)):
            if ch.dim() != 3 or ch.shape != w.shape:
                raise ValueError(f"{name} must be [L, T, K] like w "
                                 f"{tuple(w.shape)}, got {tuple(ch.shape)}")
            if ch.dtype != torch.float32:
                raise ValueError(f"{name} must be torch.float32, got "
                                 f"{ch.dtype}")
            if ch.device != w.device:
                raise ValueError(f"{name} is on {ch.device}, w on "
                                 f"{w.device}")
        w, x, y = w.contiguous(), x.contiguous(), y.contiguous()
        capture = False
    n_l, n_t, n_k = w.shape
    if n_l < 1 or n_k < 1 or not 1 <= n_t <= MAX_BINS:
        raise ValueError(f"the decode takes L >= 1, K >= 1 and 1 <= T <= "
                         f"{MAX_BINS} bins, got {tuple(w.shape)}")
    if -(-n_t // TILE) * n_l * n_k > 0x7fffffff:
        raise ValueError(f"{tuple(w.shape)}: too many blocks for one grid")
    facing_h, facing_t = _scalar("facing", facing, w.device,
                                 (torch.float32,))
    _, speed_t = _scalar("speed_of_sound", speed_of_sound, w.device,
                         (torch.float32, torch.float64))
    return w, x, y, capture, facing_h, facing_t, speed_t


_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
             + (ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p))


def _decode_fn():
    fn = build.load_library().art_binaural_decode
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def binaural_decode(spatial, sample_rate: int, facing=0.0,
                    head_radius: float = 0.0875, shadow: float = 0.6,
                    speed_of_sound=343.0, decorrelate: bool = True
                    ) -> torch.Tensor:
    """The two-ear IR ``[2L, T, K]`` (left ear first) of a ``[3L, T, K]``
    capture or a ``SpatialIR``, arguments as ``SpatialIR.binaural``. A
    CUDA input: one launch of ``binaural_decode_kernel`` (the checks of
    :func:`decode_inputs` first), counted in ``.launches``. A CPU input:
    the plain chain, ``spatial.binaural_plain``."""
    from ... import spatial as spm
    dev = (spatial if isinstance(spatial, torch.Tensor) else spatial.w).device
    if dev.type != "cuda":
        sp = spm.spatial_from_ir(spatial) \
            if isinstance(spatial, torch.Tensor) else spatial
        return spm.binaural_plain(sp, sample_rate, facing, head_radius,
                                  shadow, speed_of_sound, decorrelate)
    w, x, y, capture, facing_h, facing_t, speed_t = decode_inputs(
        spatial, facing, speed_of_sound, shadow)
    n_l, n_t, n_k = w.shape
    ms = max_shift_known(head_radius, sample_rate, speed_of_sound)
    signs = ((spm._ear_signs_tensor(n_t, 0, dev),
              spm._ear_signs_tensor(n_t, 1, dev))
             if spm._decorrelated(decorrelate, head_radius, shadow)
             else (None, None))
    out = torch.empty((2 * n_l, n_t, n_k), dtype=torch.float32, device=dev)
    err = _decode_fn()(
        w.data_ptr(), x.data_ptr(), y.data_ptr(), int(capture), n_l, n_t,
        n_k, _ptr(facing_t), 0.0 if facing_h is None else facing_h,
        _ptr(speed_t), int(speed_t is not None
                           and speed_t.dtype == torch.float64),
        float(head_radius), float(sample_rate),
        0.0 if ms is None else ms, float(shadow), _ptr(signs[0]),
        _ptr(signs[1]),
        shared_halo(head_radius, sample_rate, speed_of_sound, n_t),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"binaural decode launch failed: cudaError {err}")
    binaural_decode.launches += 1
    return out


binaural_decode.launches = 0
