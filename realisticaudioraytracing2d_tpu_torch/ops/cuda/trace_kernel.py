"""Rays x walls sweeps: wrappers, plain versions and launch counts.

Two entry points launch the one CUDA template of ``csrc/trace_kernel.cu``:

* :func:`nearest_hit` (K1) gives each ray's minimum wall distance and the
  index of that wall (-1 on a miss); it replaces ``ops/pallas/
  trace_kernel.py::nearest_hit_pallas`` of the JAX package;
* :func:`occlusion_min` (K2) gives the minimum distance alone, for shadow
  rays with any leading dims; it replaces ``::occlusion_min_pallas``.

``ops/trace.py::trace(use_kernels=True)`` sends its two ``[rays, walls]``
passes through them. Given CUDA tensors they launch the kernel or raise;
given CPU tensors they run their plain versions, :func:`nearest_hit_plain`
and :func:`occlusion_min_plain` (``pairwise_ray_segment_t`` followed by
``nearest_hit`` / ``min``), which are also what the kernel is held against
on the card: both make the same IEEE operations, so distances and indices
are equal bit for bit. Each entry point counts its launches in
``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...models.scene import Scene
from ..geometry import nearest_hit as _nearest_of
from ..geometry import pairwise_ray_segment_t
from . import build

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def _kernel_fn():
    fn = build.load_library().art_wall_sweep
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def pack_walls(scene: Scene) -> torch.Tensor:
    """The geometry rows ``[5, W]`` of a scene's wall table: ax, ay, v2x,
    v2y, cc (= v2x * ay - v2y * ax), computed as the plain trace computes
    them. Any wall count; padding walls (a == b) never hit."""
    ax, ay = scene.a[:, 0], scene.a[:, 1]
    v2x = scene.b[:, 0] - ax
    v2y = scene.b[:, 1] - ay
    return torch.stack([ax, ay, v2x, v2y,
                        v2x * ay - v2y * ax]).contiguous()


def _unpack(walls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment end points ``a, b [W, 2]`` of a packed table."""
    a = torch.stack([walls[0], walls[1]], dim=-1)
    return a, a + torch.stack([walls[2], walls[3]], dim=-1)


def _check(o: torch.Tensor, d: torch.Tensor, walls: torch.Tensor) -> None:
    if walls.dim() != 2 or walls.shape[0] != 5 or walls.shape[1] < 1:
        raise ValueError(f"walls must be the packed table [5, W], got "
                         f"{tuple(walls.shape)}")
    if o.shape != d.shape or o.shape[-1] != 2:
        raise ValueError(f"origins and directions must both be [..., 2]; "
                         f"got {tuple(o.shape)} and {tuple(d.shape)}")
    for name, x in (("origins", o), ("directions", d), ("walls", walls)):
        if x.device != walls.device:
            raise ValueError(f"{name} is on {x.device}, the wall table on "
                             f"{walls.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")


def _launch(o, d, walls, want_index):
    """One launch over the ``N = o.numel() // 2`` rays; returns ``tmin[N]``
    and, with ``want_index``, ``idx[N]`` int32."""
    o2 = o.reshape(-1, 2).contiguous()
    d2 = d.reshape(-1, 2).contiguous()
    n = o2.shape[0]
    if n == 0:
        raise ValueError("no rays to sweep")
    walls = walls.contiguous()
    tmin = torch.empty(n, dtype=torch.float32, device=walls.device)
    idx = torch.empty(n, dtype=torch.int32, device=walls.device) \
        if want_index else None
    err = _kernel_fn()(o2.data_ptr(), d2.data_ptr(), n, walls.data_ptr(),
                       walls.shape[1], tmin.data_ptr(),
                       idx.data_ptr() if want_index else None,
                       torch.cuda.current_stream(walls.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wall sweep kernel launch failed: cudaError {err}")
    return tmin, idx


def nearest_hit_plain(o: torch.Tensor, d: torch.Tensor, walls: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: the ``[R, W]`` distances of
    ``pairwise_ray_segment_t`` reduced by ``geometry.nearest_hit``."""
    _check(o, d, walls)
    return _nearest_of(pairwise_ray_segment_t(o, d, *_unpack(walls)))


def occlusion_min_plain(o: torch.Tensor, d: torch.Tensor, walls: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version of K2: the minimum over walls of
    ``pairwise_ray_segment_t``."""
    _check(o, d, walls)
    return pairwise_ray_segment_t(o, d, *_unpack(walls)).min(dim=-1).values


def nearest_hit(o: torch.Tensor, d: torch.Tensor, walls: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: rays ``o, d [R, 2]`` against the packed table ``walls [5, W]``
    (:func:`pack_walls`) -> ``(closest[R], hit_idx[R] int32)``, the index
    -1 on a miss and the lowest among equal distances. CPU tensors run
    :func:`nearest_hit_plain`."""
    if walls.device.type != "cuda":
        return nearest_hit_plain(o, d, walls)
    _check(o, d, walls)
    if o.dim() != 2:
        raise ValueError(f"rays must be [R, 2], got {tuple(o.shape)}")
    tmin, idx = _launch(o, d, walls, True)
    nearest_hit.launches += 1
    return tmin, idx


def occlusion_min(o: torch.Tensor, d: torch.Tensor, walls: torch.Tensor
                  ) -> torch.Tensor:
    """K2: shadow rays ``o, d [..., 2]`` against the packed table ->
    the minimum wall distance ``[...]`` (1e8 where no wall is crossed).
    CPU tensors run :func:`occlusion_min_plain`."""
    if walls.device.type != "cuda":
        return occlusion_min_plain(o, d, walls)
    _check(o, d, walls)
    tmin, _ = _launch(o, d, walls, False)
    occlusion_min.launches += 1
    return tmin.reshape(o.shape[:-1])


nearest_hit.launches = 0
occlusion_min.launches = 0
