"""PyTorch port: the lane groups of the bounce kernel (K3/K4/K9), as a
plain model on the CPU.

With ``kLanes`` = G > 1, G neighbouring lanes of a warp carry one ray
(``csrc/trace_common.cuh::LaneGroup``): each scans its own contiguous
1/G of the wall table, ``ceil(W / G)`` walls, and the group combines the
results with an xor butterfly of shuffles. The nearest wall combines
lexicographically (smaller distance first, then lower index), the first
blocker of a shadow ray by the lowest index. The model here cuts a table
the same way, scans each range with the plain distances of
``ops/geometry.py`` (``nearest_hit``: the first wall among equal minima,
the ascending scan's rule) and combines the lanes by the same butterfly;
it must give the whole scan's result at every G, bit for bit, also where
walls tie exactly (a table that holds every wall twice, so that the two
copies of a wall fall to different lanes). The kernel builds G = 4
(``kLaneGroup``; scripts/torch_redesign_k7_k4.py builds 2 and 8 to time
them), and the card tests (tests/test_torch_cuda.py) hold its IR at G = 4
against G = 1.

Also: the rule that picks a launch's lane group
(``bounce_kernel.lane_group``)."""

import numpy as np
import pytest
import torch
from torch_parity import CPU

from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import geometry, rng
from realisticaudioraytracing2d_tpu_torch.ops import trace as tt
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk

INT_MAX = 0x7FFFFFFF


def _lane_ranges(n_walls, lanes):
    """Each lane's walls [lo, lo + count) (LaneGroup::mine)."""
    per = -(-n_walls // lanes)
    out = []
    for rank in range(lanes):
        lo = min(n_walls, rank * per)
        out.append((lo, min(n_walls, lo + per) - lo))
    return out


def _butterfly(per_lane, pick):
    """Every lane's value after the xor butterfly of offsets G / 2 .. 1
    (the shuffles of LaneGroup), a lane keeping ``pick(partner, own)``."""
    lanes = len(per_lane)
    off = lanes // 2
    while off:
        per_lane = [pick(per_lane[r ^ off], per_lane[r])
                    for r in range(lanes)]
        off //= 2
    return per_lane


def _nearest_by_lanes(t, lanes):
    """The group's (closest, best) of distances ``t [R, W]``: each lane's
    lowest index among its smallest distances, combined
    lexicographically."""
    per_lane = []
    for lo, count in _lane_ranges(t.shape[-1], lanes):
        if count == 0:
            closest = torch.full(t.shape[:-1], geometry.INF)
            best = torch.full(t.shape[:-1], INT_MAX, dtype=torch.int64)
        else:
            closest, idx = geometry.nearest_hit(t[:, lo:lo + count])
            best = torch.where(closest < geometry.INF, idx.long() + lo,
                               INT_MAX)
        per_lane.append((closest, best))

    def take(p, q):  # the partner's where it is smaller, ray by ray
        m = (p[0] < q[0]) | ((p[0] == q[0]) & (p[1] < q[1]))
        return torch.where(m, p[0], q[0]), torch.where(m, p[1], q[1])

    return _butterfly(per_lane, take)


def _first_blocker(t, limit):
    """The lowest index of a wall that cuts the ray before ``limit``, or
    -1 (scan_blocker)."""
    ids = torch.arange(t.shape[-1])
    low = torch.where(t < limit[:, None], ids, INT_MAX).min(-1).values
    return torch.where(low == INT_MAX, -1, low)


def _blocker_by_lanes(t, limit, lanes):
    """Each lane's blocker of the group: the lowest of the lanes' first
    blockers, compared unsigned (-1 sorts last)."""
    per_lane = []
    for lo, count in _lane_ranges(t.shape[-1], lanes):
        b = _first_blocker(t[:, lo:lo + count], limit) if count else \
            torch.full(t.shape[:-1], -1, dtype=torch.int64)
        per_lane.append(torch.where(b >= 0, b + lo, 0xFFFFFFFF))
    return [torch.where(x == 0xFFFFFFFF, -1, x)
            for x in _butterfly(per_lane, torch.minimum)]


def _rays_and_walls(n_rays, seed):
    """The rays of a real SmollRoom trace before bounces 0 and 2, and a
    wall table that holds every wall twice (exact ties)."""
    room = rooms.smoll_room(device=CPU)
    scene, params = room.scene, tt.TraceParams.make(room.source,
                                                    room.listener, device=CPU)
    emit, u = rng.philox_uniforms(seed, 1, 2, n_rays, CPU)
    st = tt._emit(params, n_rays, 1, emit[0])
    states = [(st.pos, st.dir)]
    for b in range(2):
        st, _ = tt._bounce(scene, params, st, u[0, b])
    states.append((st.pos, st.dir))
    a = torch.cat([scene.a, scene.a])
    b = torch.cat([scene.b, scene.b])
    return states, a, b, params.listeners[0]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_split_nearest_scan_is_the_whole_scan(lanes):
    states, a, b, _ = _rays_and_walls(512, 3)
    for o, d in states:
        t = geometry.pairwise_ray_segment_t(o, d, a, b)
        closest, idx = geometry.nearest_hit(t)
        assert (idx >= a.shape[0] // 2).sum() == 0   # ties: the first copy
        assert (idx >= 0).float().mean() > 0.9
        for got_t, got_i in _nearest_by_lanes(t, lanes):
            assert torch.equal(got_t, closest)
            hit = torch.where(got_t < geometry.INF, got_i, -1)
            assert torch.equal(hit, idx.long())


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_split_blocker_scan_is_the_whole_scan(lanes):
    # shadow rays from the bounce points of a trace to the listener (at
    # the source, before bounce 0, the slant wall blocks every one)
    states, a, b, listener = _rays_and_walls(512, 4)
    o = torch.cat([o for o, _ in states])
    to_lis = listener[None] - o
    dist = to_lis.norm(dim=-1)
    d = to_lis / dist[:, None]
    t = geometry.pairwise_ray_segment_t(o, d, a, b)
    limit = dist - 0.1
    want = _first_blocker(t, limit)
    assert 0.05 < (want >= 0).float().mean() < 0.95
    assert (want >= a.shape[0] // 2).sum() == 0      # ties: the first copy
    for got in _blocker_by_lanes(t, limit, lanes):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n_items,n_bands,want", [
    (15000, 1, 4),                   # the stream's K4 / K3 frame
    (15000, 32, 4),
    (15000, 33, 1),                  # the scratch takes no lane groups
    (16896, 8, 4),                   # the largest grid that takes groups
    (30000, 8, 1),
    (131072, 1, 1),                  # the bench frame, one frame a launch
    (64 * 15000, 8, 1),              # the 64-source mixdown
    (1024 * 8 * 15000, 1, 1),        # the 1,024-room sweep
])
def test_launch_shape_spreads_small_grids(n_items, n_bands, want):
    lanes = bk.lane_group(n_items, n_bands)
    assert lanes == want
    assert lanes in (1, bk.LANE_GROUP)
    assert (n_items * bk.LANE_GROUP <= bk.LANE_THREADS) == (lanes > 1) \
        or n_bands > 32


def test_lane_ranges_cover_the_table_in_order():
    for n_walls in (1, 3, 24, 25, 5280):
        for lanes in (1, 2, 4, 8):
            ranges = _lane_ranges(n_walls, lanes)
            walls = [w for lo, c in ranges for w in range(lo, lo + c)]
            assert walls == list(range(n_walls))
            assert np.diff([lo for lo, _ in ranges]).min(initial=0) >= 0
