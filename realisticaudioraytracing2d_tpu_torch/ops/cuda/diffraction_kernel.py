"""Edge diffraction on the card in three launches at order 1 and four at
order 2: ``diffraction_segments_kernel``, K2
(``trace_kernel.occlusion_min``) once an order and
``diffraction_bin_kernel`` (``csrc/diffraction_kernel.cu``).

:func:`add_paths` adds the diffraction IR of orders 1 and 2
(``ops/diffraction.py::diffraction_ir``) into an IR ``[L, T, K]`` in
place. :func:`segments` builds the edge table, K2's packed wall table and
every visibility segment of the call once; one K2 launch sweeps order 1's
(source -> edge, source -> listener, edge -> listener), a second the edge
pairs of order 2, so that the call makes a sweep an order, as the
benchmark's barrier cell counts them (``stream_octave.py``);
:func:`bin_paths` judges each path with K2's distances and adds its energy
to its bin. No host sync: the speed of sound and the input gain are read
on the card where they are card tensors.

A CUDA input runs the kernels, each launch counted in ``.launches``, or
raises ``ValueError`` on what they do not take (:func:`inputs`, before the
library is loaded); nothing falls back. The CPU runs
``ops/diffraction.py``'s chain, which is the oracle: the kernels make the
card chain's float32 operations in its order and sum each bin in its
order, so the card's IR equals ``diffraction_ir(..., use_kernels=False)``
bit for bit. ``lib`` runs the same launches in another build of the source
(the tests' CPU emulation; K2 then runs its plain version).
"""

from __future__ import annotations

import ctypes
import functools
import numbers
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry import EPS
from . import build
from . import trace_kernel as tk

# candidate paths of a listener are counted in int32
MAX_CANDIDATES = (1 << 31) - 1


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _f32(x: float) -> float:
    return float(np.float32(x))


class Inputs(NamedTuple):
    """What one call's launches read, checked: the walls ``a, b [W, 2]``,
    ``mask [W]``, the source ``[2]`` and listeners ``[L, 2]`` (all
    contiguous), the band centres ``[K]`` f32 on the device, the speed of
    sound and input gain (a card tensor, or None with the host values:
    ``f32(1 / c)`` and the gain, and whether the gain is a Python number,
    which the chain's ``gain / x`` turns into ``x.reciprocal() * gain``),
    the patterns (or None) and the sizes."""

    ir: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    mask: torch.Tensor
    src: torch.Tensor
    lis: torch.Tensor
    freqs: torch.Tensor
    speed: Optional[torch.Tensor]
    inv_speed: float
    gain: Optional[torch.Tensor]
    gain_h: float
    gain_number: bool
    src_pat: Optional[torch.Tensor]
    mic_pat: Optional[torch.Tensor]
    sample_rate: int
    order: int

    @property
    def n_walls(self) -> int:
        return self.a.shape[0]

    @property
    def n_segments(self) -> int:
        n_e = 2 * self.n_walls
        return self.n_first + (n_e * n_e if self.order == 2 else 0)

    @property
    def n_first(self) -> int:
        """The segments of order 1's sweep: ``E + L + L E``."""
        n_e, n_l = 2 * self.n_walls, self.lis.shape[0]
        return n_e + n_l + n_l * n_e

    @property
    def n_candidates(self) -> int:
        n_e = 2 * self.n_walls
        return n_e + (n_e * n_e if self.order == 2 else 0)


def _scalar(name: str, v, dev: torch.device):
    """A number or a one-element floating tensor: ``(card tensor or None,
    host number or None)``; a card tensor of another float type is cast to
    float32, as PyTorch casts it in the chain's arithmetic."""
    if _number(v):
        return None, float(v)
    _check(isinstance(v, torch.Tensor) and v.numel() == 1
           and v.is_floating_point(),
           f"{name} must be a number or one floating element, got "
           f"{getattr(v, 'shape', type(v).__name__)}")
    if v.device.type == "cpu" and dev.type != "cpu":
        return None, float(v.reshape(()))
    _check(v.device == dev, f"{name} is on {v.device}, the IR on {dev}")
    return v.reshape(()).to(torch.float32).contiguous(), None


def _number(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


@functools.lru_cache(maxsize=64)
def _band_tensor(freqs: tuple, dev: torch.device) -> torch.Tensor:
    # the default centres are uploaded once per device, not every call
    return torch.as_tensor(np.asarray(freqs), dtype=torch.float32,
                           device=dev)


def _tensor(name: str, x, dev: torch.device, dtype=torch.float32):
    _check(isinstance(x, torch.Tensor),
           f"{name} must be a tensor, got {type(x).__name__}")
    _check(x.dtype == dtype, f"{name} must be {dtype}, got {x.dtype}")
    _check(x.device == dev, f"{name} is on {x.device}, the IR on {dev}")
    return x.contiguous()


def inputs(ir: torch.Tensor, scene, params, *, sample_rate: int, band_freqs,
           order: int) -> Inputs:
    """The checks of one :func:`add_paths` call: ``ir`` a contiguous
    float32 ``[L, T, K]`` with ``L`` the listeners of ``params`` and ``K``
    the scene's bands and ``band_freqs``' (a sequence of numbers or a
    ``[K]`` tensor); the scene's ``a, b [W, 2]`` float32 and ``mask [W]``
    bool, the source ``[2]`` and listeners float32, the patterns None or
    float32 ``[C]`` (the microphone's also ``[L, C]``), all on the IR's
    device; the speed of sound and input gain numbers or one floating
    element; ``order`` 1 or 2; ``sample_rate >= 1``. Raises
    ``ValueError``."""
    _check(isinstance(ir, torch.Tensor),
           f"ir must be a tensor, got {type(ir).__name__}")
    dev = ir.device
    _check(ir.dtype == torch.float32, f"ir must be torch.float32, got "
                                      f"{ir.dtype}")
    _check(ir.dim() == 3 and min(ir.shape) >= 1,
           f"ir must be [L, T, K], got {tuple(ir.shape)}")
    _check(ir.is_contiguous(), "ir must be contiguous: the paths are added "
                               "into it in place")
    _check(order in (1, 2), f"order must be 1 or 2, got {order}")
    _check(isinstance(sample_rate, numbers.Integral) and sample_rate >= 1,
           f"sample_rate must be a positive int, got {sample_rate!r}")
    n_l, n_t, n_k = ir.shape
    a = _tensor("scene.a", scene.a, dev)
    b = _tensor("scene.b", scene.b, dev)
    mask = _tensor("scene.mask", scene.mask, dev, torch.bool)
    _check(a.dim() == 2 and a.shape[1] == 2 and a.shape[0] >= 1
           and b.shape == a.shape and mask.shape == a.shape[:1],
           f"the scene's walls must be a, b [W, 2] and mask [W], got "
           f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(mask.shape)}")
    _check(scene.n_bands == n_k, f"the scene has {scene.n_bands} bands, "
                                 f"the IR {n_k}")
    n_e = 2 * a.shape[0]
    _check(n_e + (n_e * n_e if order == 2 else 0) <= MAX_CANDIDATES,
           f"{n_e} edges are too many for order {order}")
    src = _tensor("params.source", params.source, dev)
    _check(src.shape == (2,), f"params.source must be [2], got "
                              f"{tuple(src.shape)}")
    lis = _tensor("params.listeners", params.listeners, dev)
    _check(lis.numel() == 2 * n_l and lis.shape[-1] == 2,
           f"params.listeners must be [{n_l}, 2] for the IR's {n_l} "
           f"listeners, got {tuple(lis.shape)}")
    lis = lis.reshape(n_l, 2)
    if isinstance(band_freqs, torch.Tensor):
        freqs = _tensor("band_freqs", band_freqs.to(torch.float32), dev)
    else:
        freqs = _band_tensor(tuple(float(f) for f in np.ravel(band_freqs)),
                             dev)
    _check(freqs.shape == (n_k,), f"band_freqs must be [{n_k}], got "
                                  f"{tuple(freqs.shape)}")
    speed, c = _scalar("params.speed_of_sound", params.speed_of_sound, dev)
    gain, g = _scalar("params.input_gain", params.input_gain, dev)
    src_pat = mic_pat = None
    if params.directivity is not None:
        src_pat = _tensor("params.directivity", params.directivity, dev)
        _check(src_pat.dim() == 1 and src_pat.shape[0] >= 1,
               f"params.directivity must be [C], got "
               f"{tuple(src_pat.shape)}")
    if params.mic_directivity is not None:
        mic_pat = _tensor("params.mic_directivity", params.mic_directivity,
                          dev)
        _check((mic_pat.dim() == 1 and mic_pat.shape[0] >= 1)
               or (mic_pat.dim() == 2 and mic_pat.shape[0] == n_l
                   and mic_pat.shape[1] >= 1),
               f"params.mic_directivity must be [C] or [{n_l}, C], got "
               f"{tuple(mic_pat.shape)}")
    return Inputs(ir, a, b, mask, src, lis, freqs, speed,
                  0.0 if c is None else float(np.float32(1.0)
                                              / np.float32(c)),
                  gain, 0.0 if g is None else _f32(g),
                  _number(params.input_gain), src_pat, mic_pat,
                  int(sample_rate), order)


class Segments(NamedTuple):
    """What :func:`segments` writes: K2's packed walls ``[5, W]``, the
    edge table ``[5, E]`` (nx, ny, valid0, valid, weight) and the
    segments' origins and directions ``[N, 2]`` and limits ``[N]``."""

    packed: torch.Tensor
    edge: torch.Tensor
    origins: torch.Tensor
    directions: torch.Tensor
    limit: torch.Tensor


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream \
        if dev.type == "cuda" else None


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SEGMENT_ARGTYPES = (_P, _P, _P, _I, _P, _P, _I, _I, _F, _F, _F, _F) \
    + (_P,) * 6
_BIN_ARGTYPES = (_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _F, _P,
                 _F, _I, _P, _I, _P, _I, _I, _F, _I, _I, _F, _P, _I, _P, _P,
                 _P)


@functools.lru_cache(maxsize=None)
def bind(lib: ctypes.CDLL) -> dict:
    """The library's two launch functions with their argument types."""
    fns = {}
    for name, argtypes in (("art_diffraction_segments", _SEGMENT_ARGTYPES),
                           ("art_diffraction_bin", _BIN_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _library(lib, dev: torch.device):
    if lib is not None:
        return lib
    _check(dev.type == "cuda", f"the diffraction kernels run on CUDA "
                               f"tensors, got {dev}; the CPU runs "
                               f"ops/diffraction.py's chain")
    return build.load_library()


def segments(x: Inputs, lib: Optional[ctypes.CDLL] = None) -> Segments:
    """One launch of ``diffraction_segments_kernel``: the edge table, K2's
    packed walls and the call's visibility segments, each once: source ->
    edge ``[E]``, source -> listener ``[L]``, edge -> listener ``[L, E]``
    and at order 2 edge -> edge ``[E, E]``. Counted in ``.launches``."""
    from .. import diffraction as dfr   # it imports this module
    dev = x.ir.device
    fn = bind(_library(lib, dev))["art_diffraction_segments"]
    n_w, n_e, n = x.n_walls, 2 * x.n_walls, x.n_segments
    packed = torch.empty((5, n_w), dtype=torch.float32, device=dev)
    edge = torch.empty((5, n_e), dtype=torch.float32, device=dev)
    rays = torch.empty((2, n, 2), dtype=torch.float32, device=dev)
    limit = torch.empty(n, dtype=torch.float32, device=dev)
    err = fn(x.a.data_ptr(), x.b.data_ptr(), x.mask.data_ptr(), n_w,
             x.src.data_ptr(), x.lis.data_ptr(), x.lis.shape[0], x.order,
             _f32(EPS), _f32(dfr._SLACK), _f32(dfr._COINCIDENT_TOL ** 2),
             _f32(dfr._COLLINEAR_TOL), packed.data_ptr(), edge.data_ptr(),
             rays[0].data_ptr(), rays[1].data_ptr(), limit.data_ptr(),
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"diffraction segment launch failed: cudaError "
                           f"{err}")
    segments.launches += 1
    return Segments(packed, edge, rays[0], rays[1], limit)


segments.launches = 0


def bin_paths(x: Inputs, seg: Segments, tmin: torch.Tensor,
              tmin_pair: Optional[torch.Tensor],
              lib: Optional[ctypes.CDLL] = None) -> None:
    """One launch of ``diffraction_bin_kernel``: judges the paths with
    K2's distances of ``seg``'s segments, ``tmin [E + L + L E]`` of order
    1's and, at order 2, ``tmin_pair [E E]`` of the edge pairs, and adds
    their energies into ``x.ir`` in place. Counted in ``.launches``."""
    from .. import diffraction as dfr
    dev = x.ir.device
    fn = bind(_library(lib, dev))["art_diffraction_bin"]
    n_l, n_t, n_k = x.ir.shape
    n_cand = x.n_candidates
    cap = 1 << max(0, (n_cand - 1).bit_length())
    keys = torch.empty((n_l, cap), dtype=torch.int64, device=dev)
    recs = torch.empty((n_l, n_cand, 5), dtype=torch.float32, device=dev)
    mic = x.mic_pat
    err = fn(x.a.data_ptr(), x.b.data_ptr(), x.n_walls,
             seg.edge[4].data_ptr(), x.src.data_ptr(), x.lis.data_ptr(),
             n_l, tmin.data_ptr(), _ptr(tmin_pair), seg.limit.data_ptr(),
             x.freqs.data_ptr(),
             n_k, _ptr(x.speed), x.inv_speed, _ptr(x.gain), x.gain_h,
             int(x.gain_number),
             _ptr(x.src_pat), 0 if x.src_pat is None else x.src_pat.shape[0],
             _ptr(mic), 0 if mic is None else mic.shape[-1],
             int(mic is not None and mic.dim() == 2), float(x.sample_rate),
             n_t, x.order, _f32(dfr._COINCIDENT_TOL), keys.data_ptr(), cap,
             recs.data_ptr(), x.ir.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"diffraction bin launch failed: cudaError {err}")
    bin_paths.launches += 1


bin_paths.launches = 0


def add_paths(ir: torch.Tensor, scene, params, *, sample_rate: int,
              band_freqs, order: int,
              lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """``ir [L, T, K] += diffraction_ir(scene, params, ...)`` in place:
    :func:`segments`, a K2 sweep an order (the box walk's past
    ``trace_kernel.BOX_WALK_MIN_WALLS`` walls) and :func:`bin_paths`.
    Checks first (:func:`inputs`); a CPU IR raises unless ``lib`` is
    given. Returns ``ir``."""
    x = inputs(ir, scene, params, sample_rate=sample_rate,
               band_freqs=band_freqs, order=order)
    lib = _library(lib, ir.device)
    seg = segments(x, lib)
    walls = seg.packed if scene.n_walls < tk.BOX_WALK_MIN_WALLS \
        or ir.device.type != "cuda" else tk.sweep_walls(scene)

    def sweep(part: slice) -> torch.Tensor:
        return tk.occlusion_min(seg.origins[part], seg.directions[part],
                                walls, limit=seg.limit[part])

    tmin = sweep(slice(0, x.n_first))
    tmin_pair = sweep(slice(x.n_first, None)) if x.order == 2 else None
    bin_paths(x, seg, tmin, tmin_pair, lib)
    return ir
