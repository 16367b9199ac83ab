"""Cluster structure of the large-scene path, plain PyTorch.

Port of the host side of the JAX package's cluster-early-out path
(``realisticaudioraytracing2d_tpu/ops/pallas/bounce_kernel.py``):

* :func:`cluster_scene` (``cluster_scene_jnp``) sorts the walls along a
  Morton curve of their centroids and returns one axis-aligned box (AABB)
  per cluster of ``cluster_size`` consecutive sorted walls;
* :func:`super_aabbs` (``_super_aabbs``) unites ``group`` consecutive
  cluster boxes into the super boxes of the second level;
* :func:`morton_ray_keys` (``_morton_ray_keys``, position-only as the
  JAX re-sort calls it) and :func:`block_cluster_order`
  (``tile_cluster_order``) describe K8's re-sort of the rays between
  bounces and the near-to-far order each block of rays visits the super
  boxes in. On the card both are computed inside the kernel
  (``csrc/accel_kernel.cu``: ``morton_ray_key``, ``order_super_boxes``);
  the functions here are the plain mirrors the tests and the plain K8
  path use. :func:`block_rank_order` mirrors the kernel's order
  operation for operation, and :func:`walk_nearest_plain` its walk over
  the boxes.

The kernels (``ops/cuda/accel_kernel.py``) slab-test the boxes and skip
the walls of a cluster no ray can hit nearer than its running closest.

Cluster size and group are this port's own choice for the H100
(:func:`accel_cluster_size`, :func:`accel_group`): each thread walks the
boxes on its own, like a BVH with small leaves, and the box tables live
in shared memory. The sorted order of the real walls does not depend on
either (the key depends on the wall alone; padding walls sort last), and
the slab tests only skip work, so results do not move with them. The TPU
workarounds ``_ACCEL_MAX_CLUSTERS``, ``_accel_compiler_params`` and
``accel_tile`` are not ported.

torch's uint32 support is partial: the keys are built in int64 with
``0xFFFFFFFF`` for the largest key.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.scene import Scene, round_up
from .geometry import EPS, INF, pairwise_ray_segment_t

# Fewest walls per cluster: a thread tests a hit cluster's walls one by
# one, so small leaves waste little work on walls that cannot be nearest.
MIN_CLUSTER = 16
# Most clusters: their boxes (16 B each) must stay a small part of the
# 227 KB of shared memory a block can use, so several blocks share an SM.
MAX_CLUSTERS = 4096
_KEY_MAX = 0xFFFFFFFF
_BIG = 1e30


def accel_cluster_size(n_walls: int) -> int:
    """Walls per cluster: the smallest power of two from
    :data:`MIN_CLUSTER` that keeps the scene within
    :data:`MAX_CLUSTERS` clusters (16 up to 65,536 walls, 32 up to
    131,072)."""
    cs = MIN_CLUSTER
    while round_up(max(n_walls, cs), cs) // cs > MAX_CLUSTERS:
        cs *= 2
    return cs


def accel_group(n_clusters: int) -> int:
    """Clusters per super-cluster, the JAX package's rule: ``sqrt(C)``
    rounded down to a power of two, flat (1) under 64 clusters. It
    balances the outer loop (``C / G`` super boxes, every thread) against
    the inner one (``G`` cluster boxes per super box hit)."""
    if n_clusters < 64:
        return 1
    g = 1
    while g * g * 4 <= n_clusters:
        g *= 2
    return g


def accel_layout(n_walls: int) -> Tuple[int, int]:
    """``(cluster_size, group)`` for a scene of ``n_walls`` walls."""
    cs = accel_cluster_size(n_walls)
    return cs, accel_group(round_up(max(n_walls, cs), cs) // cs)


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of ``x`` to the even bits."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` to every third bit (the JAX
    package's ray-key spread)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def _quantize(p: torch.Tensor, lo: torch.Tensor, span: torch.Tensor,
              top: float) -> torch.Tensor:
    """``clip((p - lo) / span * top, 0, top)`` truncated to an integer, in
    float32 as JAX computes it; ``span`` is a tensor, so the division is
    IEEE on CUDA too (ROADMAP section 3)."""
    q = ((p - lo) / span * top).clamp(0.0, top)
    return q.to(torch.int64)


def cluster_scene(scene: Scene, cluster_size: int, group: int = 1
                  ) -> Tuple[Scene, torch.Tensor]:
    """Morton-sort a scene's walls and return ``(sorted_scene, aabb)``,
    ``aabb[C, 4]`` = (xmin, ymin, xmax, ymax) per cluster of
    ``cluster_size`` sorted walls: :func:`cluster_scene_ids` without the
    ids."""
    return cluster_scene_ids(scene, cluster_size, group)[:2]


def cluster_scene_ids(scene: Scene, cluster_size: int, group: int = 1
                      ) -> Tuple[Scene, torch.Tensor, torch.Tensor]:
    """:func:`cluster_scene` and ``ids`` int32 ``[Wp]``, the index in
    ``scene`` (padded) of each sorted wall: ``sorted_scene.a == scene.a[
    ids]`` for the real walls. The wall sweeps' box walk keeps the lowest
    of them among equal distances, the caller's argmin.

    The scene is first padded to a multiple of ``cluster_size * group``
    walls. A wall's key interleaves the 16-bit quantized x and y of its
    centroid within the bounds of the real walls; degenerate walls
    (``a == b``, the padding) get the largest key and sort last, and the
    sort is stable. A cluster of padding alone gets the inverted box
    (+1e30, -1e30) that no slab test hits."""
    wp = round_up(scene.n_walls, cluster_size * max(group, 1))
    scene = scene.pad_to(wp)
    n_clusters = wp // cluster_size
    degen = (scene.a == scene.b).all(dim=1)
    big = scene.a.new_tensor(_BIG)
    pts_lo = torch.minimum(scene.a, scene.b)
    pts_hi = torch.maximum(scene.a, scene.b)
    lo = torch.where(degen[:, None], big, pts_lo).amin(dim=0)
    hi = torch.where(degen[:, None], -big, pts_hi).amax(dim=0)
    span = torch.where(hi > lo, hi - lo, 1.0)
    cen = 0.5 * (scene.a + scene.b)
    q = _quantize(cen, lo, span, 65535.0)
    key = _part1by1(q[:, 0]) | (_part1by1(q[:, 1]) << 1)
    key = torch.where(degen, _KEY_MAX, key)
    order = torch.sort(key, stable=True).indices
    sorted_scene = Scene(*(x[order] for x in scene))
    d_s = degen[order]
    lo_s = torch.where(d_s[:, None], big,
                       torch.minimum(sorted_scene.a, sorted_scene.b))
    hi_s = torch.where(d_s[:, None], -big,
                       torch.maximum(sorted_scene.a, sorted_scene.b))
    aabb = torch.cat([lo_s.reshape(n_clusters, cluster_size, 2).amin(dim=1),
                      hi_s.reshape(n_clusters, cluster_size, 2).amax(dim=1)],
                     dim=-1)
    return sorted_scene, aabb, order.to(torch.int32)


def super_aabbs(aabb: torch.Tensor, group: int) -> torch.Tensor:
    """Unite ``group`` consecutive cluster boxes ``[C, 4]`` into super
    boxes ``[C / G, 4]`` (inverted padding boxes drop out of min/max)."""
    r = aabb.reshape(aabb.shape[0] // group, group, 4)
    return torch.cat([r[:, :, :2].amin(dim=1), r[:, :, 2:].amax(dim=1)],
                     dim=-1)


def scene_bounds(aabb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo[2], span[2])`` of the real walls' boxes: the quantization
    window of :func:`morton_ray_keys`."""
    lo = aabb[:, :2].amin(dim=0)
    hi = aabb[:, 2:].amax(dim=0)
    return lo, torch.where(hi > lo, hi - lo, 1.0)


def morton_ray_keys(px: torch.Tensor, py: torch.Tensor, alive: torch.Tensor,
                    lo: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """Sort key per ray (int64 holding a uint32): the Morton code of its
    10-bit quantized position within ``lo + [0, span]``, and the largest
    key for a dead ray, so the live rays of a block are neighbours and the
    dead ones fill the tail."""
    q = _quantize(torch.stack([px, py], dim=-1), lo, span, 1023.0)
    key = _part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1)
    return torch.where(alive, key, _KEY_MAX)


def _block_distances(px, py, alive, super_centers, block):
    """``[n_blocks, S]`` squared distances of the centres ``[S, 2]`` from
    the centroid of each block's live rays (the origin for a block with
    none)."""
    n = px.shape[0]
    pad = round_up(n, block) - n
    w = torch.nn.functional.pad(alive.to(px.dtype), (0, pad)).reshape(
        -1, block)
    xs = torch.nn.functional.pad(px, (0, pad)).reshape(-1, block)
    ys = torch.nn.functional.pad(py, (0, pad)).reshape(-1, block)
    denom = w.sum(-1, keepdim=True).clamp(min=1.0)
    cx = (xs * w).sum(-1, keepdim=True) / denom
    cy = (ys * w).sum(-1, keepdim=True) / denom
    return (cx - super_centers[None, :, 0]) ** 2 \
        + (cy - super_centers[None, :, 1]) ** 2


def block_cluster_order(px: torch.Tensor, py: torch.Tensor,
                        alive: torch.Tensor, super_centers: torch.Tensor,
                        block: int) -> torch.Tensor:
    """Near-to-far visit order of the super boxes for each block of
    ``block`` consecutive rays: the boxes sorted by the squared distance
    of their centers ``[S, 2]`` from the centroid of the block's live rays
    (the origin for a block with none). Returns int32 ``[n_blocks, S]``.
    The order only changes how soon a thread's closest hit tightens, and
    with it the speed, never the result. The plain mirror of the JAX
    package's ``tile_cluster_order``, kept for the tests: K8 orders the
    boxes in its kernel (:func:`block_rank_order` mirrors that)."""
    return torch.argsort(_block_distances(px, py, alive, super_centers,
                                          block), dim=1).to(torch.int32)


def block_rank_order(px: torch.Tensor, py: torch.Tensor,
                     alive: torch.Tensor, super_boxes: torch.Tensor,
                     block: int) -> torch.Tensor:
    """Plain mirror of K8's in-kernel order (``csrc/accel_kernel.cu::
    order_super_boxes``): for each block of ``block`` consecutive rays the
    super boxes ``[S, 4]`` by the squared distance of their centres from
    the centroid of the block's live rays, each box placed at its rank,
    the number of boxes whose distance is smaller or equal with a lower
    index. The distances are compared by their bit patterns (a total
    order that puts a NaN last), so every row is a permutation of
    ``range(S)`` whatever the positions hold. Returns int32
    ``[n_blocks, S]``; equal to :func:`block_cluster_order` wherever no
    two distances tie."""
    centers = 0.5 * (super_boxes[:, :2] + super_boxes[:, 2:])
    d2 = _block_distances(px, py, alive, centers, block)
    keys = d2.contiguous().view(torch.int32).to(torch.int64) & _KEY_MAX
    idx = torch.arange(keys.shape[1], device=keys.device)
    mine, other = keys[:, :, None], keys[:, None, :]
    ranks = ((other < mine) | ((other == mine) & (idx[None, None, :]
                                                  < idx[None, :, None]))
             ).sum(-1)
    order = torch.empty_like(ranks)
    order.scatter_(1, ranks, idx.expand_as(ranks).contiguous())
    return order.to(torch.int32)


def slab_inv(d: torch.Tensor) -> torch.Tensor:
    """Slab reciprocal that never makes ``inf * 0`` (the JAX package's
    ``_slab_inv``): ``sign(d) / max(|d|, 1e-12)``."""
    return torch.where(d >= 0, 1.0, -1.0) / d.abs().clamp(min=1e-12)


def slab_hit(box: torch.Tensor, o: torch.Tensor, inv: torch.Tensor,
             tmax: torch.Tensor) -> torch.Tensor:
    """Can rays ``o + t d`` (``o[R, 2]``, ``inv = slab_inv(d)``), ``t`` in
    ``[EPS, tmax[R]]``, meet ``box[4]``? The kernels' slab test: inverted
    padding boxes never, 1e-3 slack."""
    t0 = (box[:2] - o) * inv
    t1 = (box[2:] - o) * inv
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    return (box[2] >= box[0]) & (tfar >= EPS) \
        & (tnear <= torch.minimum(tfar, tmax) + 1e-3)


def walk_nearest_plain(scene: Scene, aabb: torch.Tensor, group: int,
                       o: torch.Tensor, d: torch.Tensor,
                       order: torch.Tensor, block: int,
                       ids: Optional[torch.Tensor] = None,
                       alive: Optional[torch.Tensor] = None,
                       limit: Optional[torch.Tensor] = None,
                       want_index: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain mirror of the box walk (K7/K8's nearest-wall search and the
    wall sweeps' box route, ``csrc/box_walk.cuh``), for the tests: rays
    ``o[R, 2]``, ``d[R, 2]`` over the sorted ``scene`` and its cluster
    boxes ``aabb[C, 4]``, each block of ``block`` rays visiting the super
    boxes in its row of ``order[n_blocks, S]``. A ray tests a cluster's
    walls only if its own slab tests of the super box and of the cluster
    box passed against its running closest hit. Among equal distances it
    keeps the lowest sorted index, or with ``ids[Wp]`` the lowest
    ``ids`` (the wall sweeps' K1: the caller's index of each sorted wall);
    without ``want_index`` the minimum alone (K2). A ray whose ``alive`` is
    False is not walked and gives ``(INF, -1)``; with ``limit[R]`` the
    running minimum starts at ``min(limit, INF)`` and a ray gives its
    minimum where it is below the limit, ``INF`` elsewhere. Returns
    ``(closest[R], index[R])`` (``INF``, -1 on a miss), which must not
    depend on ``order``."""
    saabb = super_aabbs(aabb, group)
    cs = scene.n_walls // aabb.shape[0]
    key = torch.arange(scene.n_walls, device=o.device) if ids is None \
        else ids.to(torch.int64)
    live = torch.ones(o.shape[0], dtype=torch.bool, device=o.device) \
        if alive is None else alive
    lim = torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device) \
        if limit is None else limit
    closest = torch.fmin(lim, torch.full_like(lim, INF))
    best = torch.full((o.shape[0],), 2 ** 31 - 1, dtype=torch.int64,
                      device=o.device)
    inv = slab_inv(d)
    for r0 in range(0, o.shape[0], block):
        sl = slice(r0, r0 + block)
        ob, db, ib, lb = o[sl], d[sl], inv[sl], live[sl]
        cl, be = closest[sl], best[sl]      # views: updated in place
        for ss in order[r0 // block].tolist():
            in_super = lb & slab_hit(saabb[ss], ob, ib, cl)
            for c in range(ss * group, (ss + 1) * group):
                inside = in_super & slab_hit(aabb[c], ob, ib, cl) \
                    if group > 1 else in_super
                if not bool(inside.any()):
                    continue
                lo = c * cs
                t = pairwise_ray_segment_t(ob, db, scene.a[lo:lo + cs],
                                           scene.b[lo:lo + cs])
                for j in range(cs):
                    better = t[:, j] < cl
                    if want_index:
                        better = better | ((t[:, j] == cl)
                                           & (key[lo + j] < be))
                    better = inside & better
                    cl[better] = t[better, j]
                    be[better] = key[lo + j]
    out = torch.where(live & (closest < lim), closest, INF)
    return out, torch.where(out < INF, best, -1).to(torch.int32)
