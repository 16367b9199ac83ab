"""Rays x walls sweeps: wrappers, plain versions and launch counts.

Two entry points launch the kernels of ``csrc/trace_kernel.cu``:

* :func:`nearest_hit` (K1) gives each ray's minimum wall distance and the
  index of that wall (-1 on a miss); it replaces ``ops/pallas/
  trace_kernel.py::nearest_hit_pallas`` of the JAX package;
* :func:`occlusion_min` (K2) gives the minimum distance alone, for shadow
  rays with any leading dims; it replaces ``::occlusion_min_pallas``.

``ops/trace.py::trace(use_kernels=True)`` sends its two ``[rays, walls]``
passes through them, ``ops/diffraction.py`` its visibility sweeps. Each
takes what the caller will not read: ``alive`` (a masked ray gives ``(INF,
-1)`` without a sweep) and, for K2, ``limit`` (the minimum where it is
below the limit, ``INF`` elsewhere). Without them they are the TPU
kernels' functions.

Two routes, by the wall count of the table (:func:`sweep_walls`): up to
:data:`BOX_WALK_MIN_WALLS` walls the brute-force sweep over the caller's
packed table (``wall_sweep_kernel``, in K3's lane groups of 4 at small
grids: ``bounce_kernel.lane_group``), past it the box walk
(``box_sweep_kernel``) over the Morton-sorted tables of
``accel_kernel.prepare`` (cached per scene) with the rays sorted once per
call by their :func:`ray_keys` (:func:`..accel.morton_ray_keys`, one small
kernel) and ``torch.sort``. Given CUDA tensors they launch
one of the two or raise; given CPU tensors they run their plain versions,
:func:`nearest_hit_plain` and :func:`occlusion_min_plain`
(``pairwise_ray_segment_t`` followed by ``nearest_hit`` / ``min``), which
are also what both routes are held against on the card: all make the
same IEEE operations and keep the lowest index among equal distances, so
distances and indices are equal bit for bit. Each entry point counts its
launches by route, ``.launches`` (brute force) and ``.box_launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ...models.scene import Scene
from .. import accel
from ..geometry import INF
from ..geometry import nearest_hit as _nearest_of
from ..geometry import pairwise_ray_segment_t
from . import build

# Walls from which a scene's sweeps take the box walk (its ray keys and
# sort included): at 1,008 walls the brute sweep wins at 15,000 rays and
# ties at 131,072, at 4,808 the box walk wins at 131,072 (K1 + K2 3.3x) and
# is within 11% at 15,000 (PERF.md, "crossover";
# scripts/torch_redesign_k1_k2.py).
BOX_WALK_MIN_WALLS = 4000

_P, _I = ctypes.c_void_p, ctypes.c_int
_BRUTE_ARGTYPES = (_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P)
_KEYS_ARGTYPES = (_P, _I, _P, _P, _P, _P)
_WALK_ARGTYPES = (_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                  _P, _P, _P, _P)


def _fn(name, argtypes):
    fn = getattr(build.load_library(), name)
    fn.argtypes = argtypes
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


class SweepWalls(NamedTuple):
    """What the sweeps read of a scene: its packed table (the brute route
    and the plain versions) and, for the box walk, its sorted tables
    (``accel_kernel.prepare``; None: brute force)."""

    packed: torch.Tensor              # [5, W], the scene's wall order
    sorted: Optional[object] = None   # accel_kernel.AccelScene


Walls = Union[torch.Tensor, SweepWalls]


def sweep_walls(scene: Scene) -> SweepWalls:
    """The table the sweeps take for ``scene``: on the card, past
    :data:`BOX_WALK_MIN_WALLS` walls, with the sorted tables of the box
    walk (sorted once per scene, cached by ``prepare``)."""
    packed = pack_walls(scene)
    if scene.device.type != "cuda" or scene.n_walls < BOX_WALK_MIN_WALLS:
        return SweepWalls(packed)
    # accel_kernel imports ops/trace, which imports this module
    from . import accel_kernel as ak
    return SweepWalls(packed, ak.prepare(scene))


def _tables(walls: Walls) -> SweepWalls:
    return walls if isinstance(walls, SweepWalls) else SweepWalls(walls)


def _unpack(walls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment end points ``a, b [W, 2]`` of a packed table."""
    a = torch.stack([walls[0], walls[1]], dim=-1)
    return a, a + torch.stack([walls[2], walls[3]], dim=-1)


def _check(o: torch.Tensor, d: torch.Tensor, walls: torch.Tensor,
           alive: Optional[torch.Tensor] = None,
           limit: Optional[torch.Tensor] = None) -> None:
    if walls.dim() != 2 or walls.shape[0] != 5 or walls.shape[1] < 1:
        raise ValueError(f"walls must be the packed table [5, W], got "
                         f"{tuple(walls.shape)}")
    if o.shape != d.shape or o.shape[-1] != 2:
        raise ValueError(f"origins and directions must both be [..., 2]; "
                         f"got {tuple(o.shape)} and {tuple(d.shape)}")
    for name, x, dtype in (("origins", o, torch.float32),
                           ("directions", d, torch.float32),
                           ("walls", walls, torch.float32),
                           ("alive", alive, torch.bool),
                           ("limit", limit, torch.float32)):
        if x is None:
            continue
        if x.device != walls.device:
            raise ValueError(f"{name} is on {x.device}, the wall table on "
                             f"{walls.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if name in ("alive", "limit") and x.shape != o.shape[:-1]:
            raise ValueError(f"{name} must be {tuple(o.shape[:-1])}, got "
                             f"{tuple(x.shape)}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _launch(o, d, walls: SweepWalls, alive, limit, want_index, work_counts):
    """One launch over the ``N = o.numel() // 2`` rays on the route of
    ``walls``; returns ``tmin[N]`` and, with ``want_index``, ``idx[N]``
    int32."""
    dev = walls.packed.device
    o2 = o.reshape(-1, 2).contiguous()
    d2 = d.reshape(-1, 2).contiguous()
    n = o2.shape[0]
    if n == 0:
        raise ValueError("no rays to sweep")
    alive = None if alive is None else alive.reshape(-1).contiguous()
    limit = None if limit is None else limit.reshape(-1).contiguous()
    if work_counts is not None and (
            work_counts.device != dev or work_counts.dtype != torch.int64
            or tuple(work_counts.shape) != (3,)):
        raise ValueError("work_counts must be an int64 tensor [3] on "
                         f"{dev}")
    tmin = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev) \
        if want_index else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    prep = walls.sorted
    if prep is None:
        from . import bounce_kernel as bk   # bk imports ops/trace
        packed = walls.packed.contiguous()
        err = _fn("art_wall_sweep", _BRUTE_ARGTYPES)(
            o2.data_ptr(), d2.data_ptr(), n, _ptr(alive), _ptr(limit),
            packed.data_ptr(), packed.shape[1], tmin.data_ptr(), _ptr(idx),
            _ptr(work_counts), bk.lane_group(n, 1), stream)
    else:
        # stable: rays of one key (a shared origin) keep the caller's order
        perm = torch.sort(ray_keys(o2, alive, prep.bounds),
                          stable=True).indices
        err = _fn("art_box_sweep", _WALK_ARGTYPES)(
            o2.data_ptr(), d2.data_ptr(), n, _ptr(alive), _ptr(limit),
            perm.data_ptr(), prep.geo.data_ptr(), prep.walls[4].data_ptr(),
            prep.ids.data_ptr(), prep.geo.shape[0], prep.aabb.data_ptr(),
            prep.saabb.data_ptr(), prep.n_clusters, prep.group,
            prep.cluster_size, tmin.data_ptr(), _ptr(idx), _ptr(work_counts),
            stream)
    if err != 0:
        raise RuntimeError(f"wall sweep kernel launch failed: cudaError {err}")
    return tmin, idx


def ray_keys(o: torch.Tensor, alive: Optional[torch.Tensor],
             bounds: torch.Tensor) -> torch.Tensor:
    """The sort keys of the box walk's rays ``o [N, 2]`` (int64 ``[N]``):
    :func:`..accel.morton_ray_keys` of the origins within ``bounds`` (an
    ``AccelScene``'s: lo x, lo y, span x, span y), the largest key where
    ``alive`` is False. On the card one launch of ``ray_keys_kernel``
    (the same float32 quantization in the same order, bit for bit); CPU
    tensors run the plain version."""
    if o.device.type != "cuda":
        live = torch.ones(o.shape[0], dtype=torch.bool) if alive is None \
            else alive
        return accel.morton_ray_keys(o[:, 0], o[:, 1], live, bounds[:2],
                                     bounds[2:])
    o = o.contiguous()
    alive = None if alive is None else alive.contiguous()
    keys = torch.empty(o.shape[0], dtype=torch.int64, device=o.device)
    err = _fn("art_ray_keys", _KEYS_ARGTYPES)(
        o.data_ptr(), o.shape[0], _ptr(alive), bounds.contiguous().data_ptr(),
        keys.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ray key kernel launch failed: cudaError {err}")
    return keys


def nearest_hit_plain(o: torch.Tensor, d: torch.Tensor, walls: Walls,
                      alive: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: the ``[R, W]`` distances of
    ``pairwise_ray_segment_t`` reduced by ``geometry.nearest_hit``; a ray
    whose ``alive`` is False gives ``(INF, -1)``."""
    packed = _tables(walls).packed
    _check(o, d, packed, alive)
    closest, idx = _nearest_of(pairwise_ray_segment_t(o, d, *_unpack(packed)))
    if alive is not None:
        closest = torch.where(alive, closest, INF)
        idx = torch.where(alive, idx, -1)
    return closest, idx


def occlusion_min_plain(o: torch.Tensor, d: torch.Tensor, walls: Walls,
                        alive: Optional[torch.Tensor] = None,
                        limit: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version of K2: the minimum over walls of
    ``pairwise_ray_segment_t``, ``INF`` where it is not below ``limit``
    and where ``alive`` is False."""
    packed = _tables(walls).packed
    _check(o, d, packed, alive, limit)
    m = pairwise_ray_segment_t(o, d, *_unpack(packed)).min(dim=-1).values
    if limit is not None:
        m = torch.where(m < limit, m, INF)
    if alive is not None:
        m = torch.where(alive, m, INF)
    return m


def _count(fn, walls: SweepWalls) -> None:
    if walls.sorted is None:
        fn.launches += 1
    else:
        fn.box_launches += 1


def nearest_hit(o: torch.Tensor, d: torch.Tensor, walls: Walls,
                alive: Optional[torch.Tensor] = None, *,
                work_counts: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: rays ``o, d [R, 2]`` against a scene's walls (:func:`sweep_walls`,
    or a bare packed table ``[5, W]``: :func:`pack_walls`, brute force) ->
    ``(closest[R], hit_idx[R] int32)``, the index -1 on a miss and the
    lowest among equal distances; a ray whose ``alive [R]`` is False gives
    ``(INF, -1)`` unswept. ``work_counts``: an int64 CUDA tensor ``[3]`` to
    which the launch adds its wall tests, sweeps and slab tests. CPU
    tensors run :func:`nearest_hit_plain`."""
    walls = _tables(walls)
    if walls.packed.device.type != "cuda":
        return nearest_hit_plain(o, d, walls, alive)
    _check(o, d, walls.packed, alive)
    if o.dim() != 2:
        raise ValueError(f"rays must be [R, 2], got {tuple(o.shape)}")
    tmin, idx = _launch(o, d, walls, alive, None, True, work_counts)
    _count(nearest_hit, walls)
    return tmin, idx


def occlusion_min(o: torch.Tensor, d: torch.Tensor, walls: Walls,
                  alive: Optional[torch.Tensor] = None,
                  limit: Optional[torch.Tensor] = None, *,
                  work_counts: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """K2: shadow rays ``o, d [..., 2]`` against a scene's walls (as
    :func:`nearest_hit`) -> the minimum wall distance ``[...]`` (1e8 where
    no wall is crossed); ``INF`` where it is not below ``limit [...]`` and
    where ``alive [...]`` is False. CPU tensors run
    :func:`occlusion_min_plain`."""
    walls = _tables(walls)
    if walls.packed.device.type != "cuda":
        return occlusion_min_plain(o, d, walls, alive, limit)
    _check(o, d, walls.packed, alive, limit)
    tmin, _ = _launch(o, d, walls, alive, limit, False, work_counts)
    _count(occlusion_min, walls)
    return tmin.reshape(o.shape[:-1])


nearest_hit.launches = nearest_hit.box_launches = 0
occlusion_min.launches = occlusion_min.box_launches = 0
