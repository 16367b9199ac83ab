"""PyTorch port: what K8 keeps between bounces, checked on the CPU.

On the card K8's kernel writes each ray's next sort key, the wrapper sorts
the keys, the next launch reads its rays through the permutation into a
second buffer, each block orders the super boxes from its own rays, and
``prepare`` sorts a scene's walls once. None of that may move a result.
Here, at small sizes (cities of 40-150 boxes, <= 1,024 rays):

* ``prepare`` builds once per scene and again after anything that could
  change its tables: a new ``Scene``, a moved collider, an in-place edit
  of a tensor (also through a view); cached and fresh tables are equal;
* the plain K8 path, which reads each bounce's rays through the sort's
  permutation as the kernel does, equals a reference that gathers the
  state after every bounce (the form the wrapper had before): bit for bit;
* ``block_rank_order``, the plain mirror of the kernel's per-block order,
  is a permutation of ``range(S)`` per block whatever the positions hold,
  and equals ``block_cluster_order`` where no distances tie;
* ``walk_nearest_plain``, the plain mirror of the kernels' walk over the
  boxes, finds the same nearest wall (distance and index, so the same IR)
  under that order, the identity, its reverse and a shuffle, and it is the
  brute-force nearest wall of the sorted scene."""

import numpy as np
import pytest
import torch
from torch_parity import CPU

from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.models.materials import \
    MATERIAL_INTERIOR
from realisticaudioraytracing2d_tpu_torch.models.scene import (Scene,
                                                               SceneBuilder,
                                                               Transform2D)
from realisticaudioraytracing2d_tpu_torch.ops import accel, rng
from realisticaudioraytracing2d_tpu_torch.ops import geometry as g
from realisticaudioraytracing2d_tpu_torch.ops.cuda import accel_kernel as ak
from realisticaudioraytracing2d_tpu_torch.ops.ir import scatter_hits
from realisticaudioraytracing2d_tpu_torch.ops.trace import (Hits, TraceParams,
                                                            _bounce, _emit,
                                                            _RayState)

SR, T = 8000, 2048
KW = dict(n_rays=512, max_bounces=4, sample_rate=SR, ir_length=T)


def _city(n_boxes=40, seed=1, extent=60.0):
    room = rooms.city_scene(n_boxes, seed, extent, device=CPU)
    return room, TraceParams.make(room.source, room.listener,
                                  room.listener_radius, 343.0, 10.0,
                                  device=CPU)


def _same_tables(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        (*a.scene, a.walls, a.geo, a.aabb, a.saabb, a.bounds),
        (*b.scene, b.walls, b.geo, b.aabb, b.saabb, b.bounds))) \
        and (a.cluster_size, a.group) == (b.cluster_size, b.group)


def test_prepare_builds_once_per_scene():
    room, params = _city()
    before = ak.prepare.builds
    first = ak.prepare(room.scene)
    assert ak.prepare.builds == before + 1
    again = ak.prepare(room.scene)
    assert ak.prepare.builds == before + 1 and again is first
    # the same tensors in a new tuple are the same scene
    assert ak.prepare(Scene(*room.scene)) is first
    # a whole K8 call and a K7 call on it sort nothing
    ak.trace_frames_ir_accel_sorted(room.scene, params, 1, 1, **KW)
    ak.trace_frames_ir_accel(room.scene, params, 1, 1, **KW)
    assert ak.prepare.builds == before + 1
    assert tuple(first.geo.shape) == (first.scene.n_walls, 4)
    assert torch.equal(first.geo.T, first.walls[:4])
    lo, span = accel.scene_bounds(first.aabb)
    assert torch.equal(first.bounds, torch.cat([lo, span]))


@pytest.mark.parametrize("change", ["new scene", "in-place edit",
                                    "edit through a view", "other layout"])
def test_prepare_rebuilds_after_a_change(change, monkeypatch):
    room, params = _city(60, 3)
    scene = room.scene
    stale = ak.prepare(scene)
    stale_ir = ak.trace_frames_ir_accel_sorted(scene, params, 2, 1, **KW)
    before = ak.prepare.builds
    if change == "new scene":
        scene = Scene(*(x.clone() for x in scene))
        scene.a[5:9] += 0.5
        scene.b[5:9] += 0.5
    elif change == "in-place edit":
        scene.a[5:9] += 0.5
        scene.b[5:9] += 0.5
    elif change == "edit through a view":
        scene.a[5:9, 0].add_(0.5)
        scene.b.view(-1)[10:18].add_(0.5)
    else:
        monkeypatch.setattr(accel, "accel_layout", lambda n: (8, 4))
    fresh = ak.prepare(scene)
    assert ak.prepare.builds == before + 1 and fresh is not stale
    cs, group = accel.accel_layout(scene.n_walls)
    assert _same_tables(fresh, ak._build(scene, cs, group))
    assert ak.prepare(scene) is fresh and ak.prepare.builds == before + 1
    ir = ak.trace_frames_ir_accel_sorted(scene, params, 2, 1, **KW)
    if change == "other layout":       # the layout never moves a result
        assert np.abs((ir - stale_ir).numpy()).sum() \
            <= 1e-6 * float(stale_ir.sum())
    else:                              # the moved walls do
        assert not torch.equal(ir, stale_ir)
        assert not _same_tables(fresh, stale)


def test_prepare_rebuilds_after_a_moved_collider():
    b = SceneBuilder()
    b.add_box(MATERIAL_INTERIOR, Transform2D((0.0, 0.0), 0.0, (40.0, 40.0)))
    for i in range(12):
        b.add_box(MATERIAL_INTERIOR,
                  Transform2D((-15.0 + 2.5 * i, 3.0), 0.0, (1.0, 1.0)),
                  name=f"crate{i}")
    scene = b.build(device=CPU)
    first = ak.prepare(scene)
    before = ak.prepare.builds
    moved = b.move_collider(scene, "crate3", position=(7.0, -9.0),
                            angle=0.3)
    prep = ak.prepare(moved)
    assert ak.prepare.builds == before + 1
    assert not torch.equal(prep.scene.a, first.scene.a)
    assert ak.prepare(scene) is first           # the old scene is still kept


def test_prepare_keeps_only_the_last_scenes():
    scenes = [_city(40, seed)[0].scene for seed in
              range(ak.PREPARED_SCENES + 1)]
    first = ak.prepare(scenes[0])
    for s in scenes[1:]:
        ak.prepare(s)
    before = ak.prepare.builds
    assert ak.prepare(scenes[-1]) is not None and ak.prepare.builds == before
    assert ak.prepare(scenes[0]) is not first   # pushed out, built anew
    assert ak.prepare.builds == before + 1


def _gathering_reference(prep, params, emit, u):
    """K8's plain path as it was before the permutation read: after every
    bounce the state is gathered into the order of an argsort of the
    keys."""
    n_frames, n_rays = emit.shape
    frames = [_emit(params, n_rays, 1, emit[f]) for f in range(n_frames)]
    st = _RayState(*(torch.cat(xs) for xs in zip(*frames)))
    ids = torch.arange(n_frames * n_rays)
    lo, span = accel.scene_bounds(prep.aabb)
    ir = 0.0
    for b in range(u.shape[1]):
        st, (delay, energy, valid, _, _) = _bounce(
            prep.scene, params, st, u[:, b].reshape(-1, 3)[ids])
        ir = ir + scatter_hits(Hits(delay[None], energy[None], valid[None]),
                               SR, T)
        if b + 1 < u.shape[1]:
            order = torch.argsort(accel.morton_ray_keys(
                st.pos[:, 0], st.pos[:, 1], st.alive, lo, span), stable=True)
            st = _RayState(*(x[order] for x in st))
            ids = ids[order]
    return ir


@pytest.mark.parametrize("n_boxes,seed,frames", [(40, 1, 1), (150, 2, 2)])
def test_permutation_read_equals_the_gathering_resort(n_boxes, seed, frames):
    room, params = _city(n_boxes, seed, 100.0 if n_boxes > 100 else 60.0)
    emit, u = rng.philox_uniforms(seed, frames, KW["max_bounces"],
                                  KW["n_rays"], CPU)
    got = ak.trace_frames_ir_accel_sorted_plain(room.scene, params, seed,
                                                frames, **KW)
    want = _gathering_reference(ak.prepare(room.scene), params, emit, u)
    assert float(want.sum()) > 0 and (want != 0).sum() > 50
    assert ((got != 0) == (want != 0)).all()
    assert np.abs((got - want).numpy()).sum() <= 1e-6 * float(want.sum())


def _rays(n, seed, extent=60.0):
    r = np.random.default_rng(seed)
    o = torch.tensor(r.uniform(-extent / 2, extent / 2, (n, 2)),
                     dtype=torch.float32)
    ang = r.uniform(0, 2 * np.pi, n)
    d = torch.tensor(np.stack([np.cos(ang), np.sin(ang)], -1),
                     dtype=torch.float32)
    return o, d, torch.tensor(r.uniform(size=n) > 0.3)


@pytest.mark.parametrize("block", [32, 256])
def test_block_rank_order_is_a_permutation_per_block(block):
    prep = ak.prepare(_city(150, 2, 100.0)[0].scene)
    o, _, alive = _rays(1000, 4, 100.0)
    order = accel.block_rank_order(o[:, 0], o[:, 1], alive, prep.saabb, block)
    n_super = prep.saabb.shape[0]
    assert order.dtype == torch.int32
    assert tuple(order.shape) == (-(-1000 // block), n_super)
    assert bool((order.sort(dim=1).values == torch.arange(n_super)).all())
    centers = 0.5 * (prep.saabb[:, :2] + prep.saabb[:, 2:])
    near_far = accel.block_cluster_order(o[:, 0], o[:, 1], alive, centers,
                                         block)
    real = prep.saabb[:, 2] >= prep.saabb[:, 0]     # padding boxes tie
    for got, want in zip(order, near_far):
        assert got[real[got.long()]].tolist() == \
            want[real[want.long()]].tolist()
    # positions that are not numbers still give a permutation
    o[::7] = float("nan")
    o[3::11] = float("inf")
    wild = accel.block_rank_order(o[:, 0], o[:, 1], alive | True, prep.saabb,
                                  block)
    assert bool((wild.sort(dim=1).values == torch.arange(n_super)).all())


@pytest.mark.parametrize("n_boxes,layout", [(150, (8, 4)), (40, (16, 1))])
def test_walk_result_does_not_depend_on_the_block_order(n_boxes, layout,
                                                        monkeypatch):
    monkeypatch.setattr(accel, "accel_layout", lambda n: layout)
    prep = ak.prepare(_city(n_boxes, 2, 100.0)[0].scene)
    assert (prep.cluster_size, prep.group) == layout
    o, d, alive = _rays(256, 5, 100.0)
    block = 64
    mirror = accel.block_rank_order(o[:, 0], o[:, 1], alive, prep.saabb,
                                    block)
    n_super = prep.saabb.shape[0]
    identity = torch.arange(n_super, dtype=torch.int32).expand(
        mirror.shape[0], -1)
    shuffle = torch.stack([torch.randperm(
        n_super, generator=torch.Generator().manual_seed(i)).int()
        for i in range(mirror.shape[0])])
    t = g.pairwise_ray_segment_t(o, d, prep.scene.a, prep.scene.b)
    want = g.nearest_hit(t)
    assert int((want[1] >= 0).sum()) > 200
    for order in (mirror, identity, mirror.flip(1), shuffle):
        closest, idx = accel.walk_nearest_plain(prep.scene, prep.aabb,
                                                prep.group, o, d, order,
                                                block)
        assert torch.equal(closest, want[0]) and torch.equal(idx, want[1])
