"""Per-arrival Doppler's taps in two launches: ``ear_taps_kernel`` and
``tap_synthesis_kernel`` (``csrc/arrival_taps_kernel.cu``).

:func:`ear_taps` takes this chunk's and the previous chunk's binaural tap
tables (``streaming.ArrivalCarry``: ``idx``, ``val``, ``g3``, ``x3``,
``y3``) and returns the ear-tap rows (``streaming.EarTaps``): the
mutual-nearest match, the four ear-field sets and their assembly.
:func:`tap_synthesis` sums a chunk's taps ``[L, n]`` from tap rows in
every form ``streaming._tap_chunk`` takes (scalar ``[L, A]`` delays with
``[L, A, 3]`` gains, banded ``[L, A, 3, K]`` gains, ear ``[L, A, 3, K]``
delays and gains), reading a ``[Wd]`` or ``[K, Wd]`` window as it is, or
a ``streaming.DryWindow``: the mono clip through the history window's
rule and the input gate, so no window tensor is built.

A CUDA input runs the kernel, one launch on the current stream with no
host sync, counted in ``ear_taps.launches`` / ``tap_synthesis.launches``,
or raises ``ValueError`` on what the kernel does not take; nothing falls
back. A CPU input runs the plain chain (``streaming._ear_taps``,
``streaming._tap_chunk_plain``), which is the oracle: the table kernel
makes the chain's float32 operations in the chain's order, so its rows
equal the card's chain bit for bit; the synthesis sums its terms in row
order where the chain sums them in torch's reduction order.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .binaural_kernel import _scalar, max_shift_known

# float32 window positions and bin indices stay exact up to 2^24
MAX_BINS = 1 << 24
# row groups (listeners or ears) of one synthesis grid (its y extent)
MAX_GROUPS = 65535


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _same_device(dev: torch.device, **tensors) -> None:
    for name, x in tensors.items():
        _check(x.device == dev, f"{name} is on {x.device}, not {dev}")


def ear_inputs(cur, prev, facing, prev_facing, n_t: int, sample_rate: int,
               head_radius: float, shadow: float, speed_of_sound,
               decorrelate: bool, match_bins: float) -> list:
    """The checks of one ``ear_taps_kernel`` launch: ``cur`` and ``prev``
    tables of one device and shape, ``idx`` int64 ``[L, A]``, ``val``
    bool ``[L, A]``, ``g3`` / ``x3`` / ``y3`` float32 ``[L, A, 3, K]``;
    ``1 <= T <= 2^24``; ``shadow`` in [0, 1]; ``facing`` and
    ``prev_facing`` numbers or one float32 element on that device (a CPU
    tensor is read as a number), ``speed_of_sound`` a number or one
    float32 or float64 element. Raises ``ValueError``. Returns the
    kernel's arguments before its outputs, tensors (contiguous) in the
    pointers' places and None for a null pointer."""
    from ... import spatial as spm
    _check(0.0 <= shadow <= 1.0, f"shadow must be in [0, 1], got {shadow}")
    _check(1 <= n_t <= MAX_BINS, f"T must be in [1, {MAX_BINS}], got {n_t}")
    dev = cur.idx.device
    tables = []
    for side, t in (("cur", cur), ("prev", prev)):
        for name, dtype in (("idx", torch.int64), ("val", torch.bool),
                            ("g3", torch.float32), ("x3", torch.float32),
                            ("y3", torch.float32)):
            x = getattr(t, name)
            _check(isinstance(x, torch.Tensor),
                   f"{side}.{name} must be a tensor, got {type(x).__name__}")
            _check(x.dtype == dtype, f"{side}.{name} must be {dtype}, got "
                                     f"{x.dtype}")
            _same_device(dev, **{f"{side}.{name}": x})
            tables.append(x.contiguous())
    idx, g3 = tables[0], tables[2]
    _check(idx.dim() == 2 and idx.shape[0] >= 1 and idx.shape[1] >= 1,
           f"idx must be [L, A], got {tuple(idx.shape)}")
    _check(g3.dim() == 4 and g3.shape[:3] == (*idx.shape, 3)
           and g3.shape[3] >= 1,
           f"g3 must be [L, A, 3, K] for idx {tuple(idx.shape)}, got "
           f"{tuple(g3.shape)}")
    for i, x in enumerate(tables):
        want = idx.shape if i % 5 < 2 else g3.shape
        _check(x.shape == want, f"{('cur', 'prev')[i // 5]}."
                                f"{('idx', 'val', 'g3', 'x3', 'y3')[i % 5]}"
                                f" must be {tuple(want)}, got "
                                f"{tuple(x.shape)}")
    facing_h, facing_t = _scalar("facing", facing, dev, (torch.float32,))
    prev_h, prev_t = _scalar("prev_facing", prev_facing, dev,
                             (torch.float32,))
    _, speed_t = _scalar("speed_of_sound", speed_of_sound, dev,
                         (torch.float32, torch.float64))
    ms = max_shift_known(head_radius, sample_rate, speed_of_sound)
    signs = ((spm._ear_signs_tensor(n_t, 0, dev),
              spm._ear_signs_tensor(n_t, 1, dev))
             if spm._decorrelated(decorrelate, head_radius, shadow)
             else (None, None))
    n_l, n_a, _, n_k = g3.shape
    return [*tables, n_l, n_a, n_k, n_t, facing_t,
            0.0 if facing_h is None else facing_h, prev_t,
            0.0 if prev_h is None else prev_h, speed_t,
            int(speed_t is not None and speed_t.dtype == torch.float64),
            float(head_radius), float(sample_rate),
            0.0 if ms is None else ms, float(shadow), signs[0], signs[1],
            float(match_bins)]


def ear_outputs(n_l: int, n_a: int, n_k: int, dev: torch.device):
    """The buffers ``ear_taps_kernel`` writes: the rows ``[4, 2L, 4A, 3,
    K]`` (tau0, tau1, g0, g1), the flags ``[2L 4A + 2 L A]`` (valid,
    mutual, vanished) and ``j [L, A]``, uninitialized."""
    return (torch.empty((4, 2 * n_l, 4 * n_a, 3, n_k), dtype=torch.float32,
                        device=dev),
            torch.empty(8 * n_l * n_a + 2 * n_l * n_a, dtype=torch.bool,
                        device=dev),
            torch.empty((n_l, n_a), dtype=torch.int64, device=dev))


def ear_result(rows: torch.Tensor, flags: torch.Tensor, j: torch.Tensor):
    """``streaming.EarTaps`` of the kernel's written buffers (views)."""
    from ... import streaming as st
    n_l, n_a = j.shape
    n_valid = 8 * n_l * n_a
    return st.EarTaps(*rows.unbind(0),
                      flags[:n_valid].view(2 * n_l, 4 * n_a), j,
                      flags[n_valid:n_valid + n_l * n_a].view(n_l, n_a),
                      flags[n_valid + n_l * n_a:].view(n_l, n_a))


def pointers(args) -> list:
    """A launch's arguments with each tensor as its address (None stays
    a null pointer)."""
    return [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]


_EAR_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 4
                 + (ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                    ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_double, ctypes.c_double, ctypes.c_float,
                    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_float)
                 + (ctypes.c_void_p,) * 4)

_SYNTH_ARGTYPES = ((ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_longlong) + (ctypes.c_int,) * 4
                   + (ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
                   + (ctypes.c_int,) * 4
                   + (ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p))


@functools.lru_cache(maxsize=None)
def bind(lib: ctypes.CDLL) -> dict:
    """The library's two launch functions with their argument types."""
    fns = {}
    for name, argtypes in (("art_ear_taps", _EAR_ARGTYPES),
                           ("art_tap_synthesis", _SYNTH_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def ear_taps(cur, prev, facing, prev_facing, n_t: int, sample_rate: int,
             head_radius: float, shadow: float, speed_of_sound,
             decorrelate: bool, match_bins: float):
    """The binaural ear-tap rows (``streaming.EarTaps``) of this chunk's
    table ``cur`` at ``facing`` and the previous chunk's ``prev`` at
    ``prev_facing`` (each a number or a one-element float32 tensor), for
    a ``T = n_t``-bin IR. A CUDA table: one launch of ``ear_taps_kernel``
    (the checks of :func:`ear_inputs` first), counted in ``.launches``. A
    CPU table: the plain chain, ``streaming._ear_taps``."""
    from ... import streaming as st
    args = (cur, prev, facing, prev_facing, n_t, sample_rate, head_radius,
            shadow, speed_of_sound, decorrelate, match_bins)
    dev = cur.idx.device
    if dev.type != "cuda":
        return st._ear_taps(*args)
    inputs = ear_inputs(*args)
    out = ear_outputs(*inputs[10:13], dev)
    err = bind(build.load_library())["art_ear_taps"](
        *pointers(inputs + list(out)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ear-tap table launch failed: cudaError {err}")
    ear_taps.launches += 1
    return ear_result(*out)


ear_taps.launches = 0


def synthesis_inputs(dry, tau0, tau1, g0, g1, valid, n: int) -> list:
    """The checks of one ``tap_synthesis_kernel`` launch. ``dry``: a
    float32 ``[Wd]`` or ``[Kd, Wd]`` window, or a ``streaming.DryWindow``
    of a float32 ``[total]`` clip; ``tau0`` / ``tau1`` float32 of one
    shape, ``[L, R]``, ``[L, R, 3]`` or ``[L, R, 3, Kt]``; ``g0`` / ``g1``
    float32 of one shape, ``[L, R, 3]`` or ``[L, R, 3, Kg]``; ``valid``
    bool ``[L, R]``; each of ``Kd``, ``Kt``, ``Kg`` 1 or their largest,
    ``K``; ``n >= 1``; ``Wd <= 2^24``; ``L <= 65,535``; one device.
    Raises ``ValueError``. Returns the kernel's arguments before ``out``,
    tensors (contiguous) in the pointers' places: the dry rows ``[Kd,
    total]`` or the clip, ``Kd``, ``total``, the window's ``wd, start,
    prefix, cut, loop, gate`` and the gate's ``eps``, ``tau0, tau1,
    tau_scalar, Kt, g0, g1, Kg, valid, L, R, K, n`` and ``f32(1 / n)``.
    A ``[L, R, 3]`` delay or gain is the chain's ``[L, R, 3, 1]``."""
    from ... import streaming as st
    from .. import convolve as cv
    if isinstance(dry, st.DryWindow):
        src = dry.dry
        _check(isinstance(src, torch.Tensor) and src.dim() == 1
               and src.numel() >= 1,
               f"a DryWindow reads a [total] clip, got "
               f"{getattr(src, 'shape', type(src).__name__)}")
        wd = dry.wd
        _check(1 <= wd <= MAX_BINS, f"the window must hold 1 .. "
                                    f"{MAX_BINS} samples, got {wd}")
        _check(0 <= dry.start < src.numel() if dry.loop
               else abs(dry.start) < 1 << 62,
               f"a looping window starts inside the clip, any other within "
               f"2^62 of it: got {dry.start} for a clip of {src.numel()}")
        # the kernel compares window positions 0 .. wd - 1 with prefix and
        # cut: clamped to [0, wd], they compare alike
        window = [wd, dry.start, min(max(dry.prefix, 0), wd),
                  min(max(dry.cut, 0), wd), int(dry.loop), 1]
        rows = src.contiguous()
        n_dry, total = 1, src.numel()
    else:
        _check(isinstance(dry, torch.Tensor) and dry.dim() in (1, 2)
               and dry.numel() >= 1,
               f"dry must be a [Wd] or [K, Wd] window or a DryWindow, got "
               f"{getattr(dry, 'shape', type(dry).__name__)}")
        src = dry
        rows = dry.reshape(-1, dry.shape[-1]).contiguous()
        n_dry, total = rows.shape
        _check(total <= MAX_BINS, f"the window must hold at most "
                                  f"{MAX_BINS} samples, got {total}")
        window = [total, 0, 0, total, 0, 0]
    _check(src.dtype == torch.float32, f"dry must be torch.float32, got "
                                       f"{src.dtype}")
    named = dict(tau0=tau0, tau1=tau1, g0=g0, g1=g1, valid=valid)
    for name, x in named.items():
        _check(isinstance(x, torch.Tensor),
               f"{name} must be a tensor, got {type(x).__name__}")
        want = torch.bool if name == "valid" else torch.float32
        _check(x.dtype == want, f"{name} must be {want}, got {x.dtype}")
    _same_device(src.device, **named)
    _check(tau0.shape == tau1.shape, f"tau0 {tuple(tau0.shape)} and tau1 "
                                     f"{tuple(tau1.shape)} differ")
    _check(g0.shape == g1.shape, f"g0 {tuple(g0.shape)} and g1 "
                                 f"{tuple(g1.shape)} differ")
    _check(valid.dim() == 2 and 1 <= valid.shape[0] <= MAX_GROUPS,
           f"valid must be [L, R], 1 <= L <= {MAX_GROUPS}, got "
           f"{tuple(valid.shape)}")
    lr = tuple(valid.shape)
    _check(tau0.dim() in (2, 3, 4) and tuple(tau0.shape[:2]) == lr
           and (tau0.dim() == 2 or tau0.shape[2] == 3),
           f"tau must be [L, R], [L, R, 3] or [L, R, 3, K] for valid {lr}, "
           f"got {tuple(tau0.shape)}")
    _check(g0.dim() in (3, 4) and tuple(g0.shape[:3]) == lr + (3,),
           f"g must be [L, R, 3] or [L, R, 3, K] for valid {lr}, got "
           f"{tuple(g0.shape)}")
    n_kt = tau0.shape[3] if tau0.dim() == 4 else 1
    n_kg = g0.shape[3] if g0.dim() == 4 else 1
    n_k = max(n_kt, n_kg, n_dry)
    _check(all(x in (1, n_k) for x in (n_kt, n_kg, n_dry)),
           f"bands of tau ({n_kt}), g ({n_kg}) and dry ({n_dry}) must each "
           f"be 1 or {n_k}")
    _check(n >= 1, f"n must be >= 1, got {n}")
    return [rows, n_dry, total, *window, float(np.float32(cv.EPS)),
            tau0.contiguous(), tau1.contiguous(), int(tau0.dim() == 2),
            n_kt, g0.contiguous(), g1.contiguous(), n_kg,
            valid.contiguous(), lr[0], lr[1], n_k, n,
            float(np.float32(1.0) / np.float32(n))]


def tap_synthesis(dry, tau0, tau1, g0, g1, valid, n: int) -> torch.Tensor:
    """``[L, n]`` taps of a chunk, arguments as ``streaming._tap_chunk``'s,
    whose window ``dry`` may also be a ``streaming.DryWindow`` (read from
    its clip, gated). A CUDA input: one launch of
    ``tap_synthesis_kernel`` (the checks of :func:`synthesis_inputs`
    first), counted in ``.launches``. A CPU input: the plain chain,
    ``streaming._tap_chunk_plain`` (a DryWindow's tensor built and gated
    first)."""
    from ... import streaming as st
    from .. import convolve as cv
    src = dry.dry if isinstance(dry, st.DryWindow) else dry
    if not isinstance(src, torch.Tensor) or src.device.type != "cuda":
        if isinstance(dry, st.DryWindow):
            dry = cv.gate_input(dry.tensor())
        return st._tap_chunk_plain(dry, tau0, tau1, g0, g1, valid, n)
    args = synthesis_inputs(dry, tau0, tau1, g0, g1, valid, n)
    out = torch.empty((valid.shape[0], n), dtype=torch.float32,
                      device=src.device)
    err = bind(build.load_library())["art_tap_synthesis"](
        *pointers(args), out.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tap synthesis launch failed: cudaError {err}")
    tap_synthesis.launches += 1
    return out


tap_synthesis.launches = 0
