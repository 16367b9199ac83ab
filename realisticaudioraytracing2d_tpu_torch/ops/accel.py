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
  (``tile_cluster_order``) drive K8's re-sort of the rays between
  bounces.

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

from typing import Tuple

import torch

from ..models.scene import Scene, round_up

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
    ``cluster_size`` sorted walls.

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
    return sorted_scene, aabb


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


def block_cluster_order(px: torch.Tensor, py: torch.Tensor,
                        alive: torch.Tensor, super_centers: torch.Tensor,
                        block: int) -> torch.Tensor:
    """Near-to-far visit order of the super boxes for each block of
    ``block`` consecutive rays: the boxes sorted by the squared distance
    of their centers ``[S, 2]`` from the centroid of the block's live rays
    (the origin for a block with none). Returns int32 ``[n_blocks, S]``.
    The order only changes how soon a thread's closest hit tightens, and
    with it the speed, never the result."""
    n = px.shape[0]
    pad = round_up(n, block) - n
    w = torch.nn.functional.pad(alive.to(px.dtype), (0, pad)).reshape(
        -1, block)
    xs = torch.nn.functional.pad(px, (0, pad)).reshape(-1, block)
    ys = torch.nn.functional.pad(py, (0, pad)).reshape(-1, block)
    denom = w.sum(-1, keepdim=True).clamp(min=1.0)
    cx = (xs * w).sum(-1, keepdim=True) / denom
    cy = (ys * w).sum(-1, keepdim=True) / denom
    d2 = (cx - super_centers[None, :, 0]) ** 2 \
        + (cy - super_centers[None, :, 1]) ** 2
    return torch.argsort(d2, dim=1).to(torch.int32)
