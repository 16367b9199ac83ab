"""PyTorch port: the large-scene path (``city_scene``, the cluster
structure of ``ops/accel.py``, the plain versions of the cluster kernels
K7/K8 and the engine's routing) against the JAX package on the CPU.

JAX's Pallas kernels run in interpret mode, as tests/test_bounce_kernel.py
runs them. tests/test_torch_cuda.py holds the CUDA kernels against these
plain versions on the card.

Tolerances:
* ``city_scene``, ``cluster_scene``, ``super_aabbs`` and
  ``morton_ray_keys``: bit for bit (the same numpy draws, float32
  arithmetic in the same order, integer keys);
* plain K7 vs JAX ``trace_frames_ir_accel(in_kernel_rng=False)`` on JAX's
  uniforms: energy 1% and per-bin L1 2%, the limits of
  test_torch_bounce_kernel.py against the TPU kernels, which bin through
  bf16 one-hots (~0.4% per hit) and use an approximate reciprocal that
  flips razor-edge hits;
* plain K8 vs the plain trace on the same sorted scene and the same
  Philox numbers: the same hits, so L1 <= 1e-6 (only the float summation
  order of the scatter differs: one scatter per bounce against one per
  frame), and so are both plain versions run over slices of rays;
* plain K8 vs JAX ``trace_frames_ir_accel_sorted``: total energy within
  15%, JAX's own bound for its K8 against its oracle
  (``test_bounce_kernel.py::test_accel_sorted_statistical_parity_with_
  oracle``): the two draw different random streams.
Sizes: cities of 40-150 boxes (168-608 walls), <= 4,096 rays, <= 4
bounces, 8 kHz, 2,048 bins."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import CPU, to_numpy, to_torch

from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
from realisticaudioraytracing2d_tpu.ops.pallas import bounce_kernel as jax_bk
from realisticaudioraytracing2d_tpu.ops.trace import \
    TraceParams as JaxTraceParams
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.models.scene import Scene
from realisticaudioraytracing2d_tpu_torch.ops import accel
from realisticaudioraytracing2d_tpu_torch.ops.cuda import accel_kernel as ak
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.ops.geometry import INF
from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams

SR, T = 8000, 2048
KW = dict(n_rays=512, max_bounces=3, sample_rate=SR, ir_length=T)


def _l1(got, want):
    return np.abs(got - want).sum() / np.abs(want).sum()


def _assert_scene_equal(port, ref):
    for f in Scene._fields:
        got, want = to_numpy(getattr(port, f)), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _city(n_boxes=40, seed=1, extent=60.0, n_bands=1):
    """The port's city on the CPU and its trace parameters (gain 10, as
    the JAX accel tests)."""
    room = rooms.city_scene(n_boxes, seed, extent, n_bands=n_bands,
                            device=CPU)
    return room, TraceParams.make(room.source, room.listener,
                                  room.listener_radius, 343.0, 10.0,
                                  device=CPU)


def _jax_city(n_boxes=40, seed=1, extent=60.0, n_bands=1):
    room = jax_rooms.city_scene(n_boxes=n_boxes, seed=seed, extent=extent,
                                n_bands=n_bands)
    return room, JaxTraceParams.make(room.source, room.listener,
                                     room.listener_radius, 343.0, 10.0)


@pytest.mark.parametrize("n_boxes,seed,extent,n_bands", [
    (40, 1, 60.0, 1), (150, 2, 100.0, 1), (40, 1, 60.0, 8)])
def test_city_scene_bit_equal_jax(n_boxes, seed, extent, n_bands):
    room, _ = _city(n_boxes, seed, extent, n_bands)
    ref, _ = _jax_city(n_boxes, seed, extent, n_bands)
    assert room.scene.n_walls == ref.scene.n_walls
    assert int(room.scene.mask.sum()) == 4 * n_boxes + 4
    _assert_scene_equal(room.scene, ref.scene)
    np.testing.assert_array_equal(room.source, ref.source)
    np.testing.assert_array_equal(room.listener, ref.listener)
    assert room.listener_radius == ref.listener_radius


@pytest.mark.parametrize("cluster_size", [128, 8])
def test_cluster_scene_bit_equal_jax(cluster_size):
    room, _ = _city(150, 2, 100.0)
    ref, _ = _jax_city(150, 2, 100.0)
    n_clusters = -(-room.scene.n_walls // cluster_size)
    group = 1 if cluster_size == 128 else accel.accel_group(n_clusters)
    assert (group > 1) == (cluster_size == 8)
    got, aabb = accel.cluster_scene(room.scene, cluster_size, group)
    want, aabb_j = jax_bk.cluster_scene_jnp(ref.scene, cluster_size, group)
    _assert_scene_equal(got, want)
    np.testing.assert_array_equal(to_numpy(aabb), np.asarray(aabb_j))
    assert got.n_walls % (cluster_size * group) == 0
    # padding sorts last, and the real walls' order is that of any size
    n_real = int(room.scene.mask.sum())
    assert bool(got.mask[:n_real].all()) and not bool(got.mask[n_real:].any())
    other, _ = accel.cluster_scene(room.scene, 16, 4)
    assert torch.equal(got.a[:n_real], other.a[:n_real])


def test_super_aabbs_bit_equal_jax():
    room, _ = _city(150, 2, 100.0)
    _, aabb = accel.cluster_scene(room.scene, 8, 8)
    got = accel.super_aabbs(aabb, 8)
    want = jax_bk._super_aabbs(jax.numpy.asarray(to_numpy(aabb)), 8)
    assert tuple(got.shape) == (aabb.shape[0] // 8, 4)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    # a super box holds its clusters
    r = aabb.reshape(-1, 8, 4)
    assert bool((got[:, None, :2] <= r[..., :2]).all())


@pytest.mark.parametrize("seed", [0, 3])
def test_morton_ray_keys_bit_equal_jax(seed):
    g = np.random.default_rng(seed)
    n = 4096
    pos = g.uniform(-120.0, 120.0, (n, 2)).astype(np.float32)
    alive = g.uniform(size=n) > 0.2
    lo = np.array([-100.0, -90.0], np.float32)
    span = np.array([200.0, 180.0], np.float32)
    got = accel.morton_ray_keys(to_torch(pos[:, 0]), to_torch(pos[:, 1]),
                                to_torch(alive), to_torch(lo),
                                to_torch(span))
    want = jax_bk._morton_ray_keys(pos[:, 0], pos[:, 1], alive, lo, span)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(to_numpy(got),
                                  np.asarray(want).astype(np.int64))
    assert (to_numpy(got)[~alive] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("n_walls,layout", [
    (168, (16, 1)), (40008, (16, 32)), (100016, (32, 32))])
def test_accel_layout_fits_shared_memory(n_walls, layout):
    cs, group = accel.accel_layout(n_walls)
    assert (cs, group) == layout
    n_clusters = -(-n_walls // (cs * group)) * group
    assert n_clusters <= accel.MAX_CLUSTERS + group
    # a block keeps the super boxes (16 B), K8's visit order and its sort
    # keys (4 B each) and 16 listeners in shared memory; the cluster boxes
    # stay in global memory
    smem = 24 * (n_clusters // group) + 8 * 16
    assert smem <= 48 * 1024


def test_block_cluster_order_is_near_to_far():
    centers = torch.tensor([[10.0, 0.0], [0.0, 0.0], [-30.0, 5.0]])
    px = torch.tensor([1.0, 3.0, -29.0, -31.0, 100.0])
    py = torch.tensor([0.0, 0.0, 5.0, 5.0, 100.0])
    alive = torch.tensor([True, True, True, True, False])
    order = accel.block_cluster_order(px, py, alive, centers, 2)
    assert order.dtype == torch.int32 and tuple(order.shape) == (3, 3)
    assert order[0].tolist() == [1, 0, 2]        # centroid (2, 0)
    assert order[1].tolist() == [2, 1, 0]        # centroid (-30, 5)
    assert order[2].tolist() == [1, 0, 2]        # no live ray: the origin


@pytest.mark.parametrize("n_bands", [1, 8])
def test_accel_plain_matches_jax_kernel_interpret(n_bands):
    room, params = _city(n_bands=n_bands)
    ref, p = _jax_city(n_bands=n_bands)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jax_bk.trace_frames_ir_accel(
        ref.scene, p, key, n_frames=1, in_kernel_rng=False, **KW))
    emit, u = jax_rng.bounce_uniforms(key, KW["max_bounces"], KW["n_rays"])
    got = to_numpy(ak.trace_frames_ir_accel_plain(
        room.scene, params, 0, 1, uniforms=(to_torch(emit)[None],
                                            to_torch(u)[None]), **KW))
    assert got.shape == want.shape == (1, T, n_bands)
    assert (want != 0).sum() > 100
    assert abs(got.sum() - want.sum()) / want.sum() < 1e-2
    assert _l1(got, want) < 2e-2
    if n_bands > 1:   # the materials' high-frequency rolloff
        assert got[..., -1].sum() < got[..., 0].sum()


@pytest.mark.parametrize("n_bands", [1, 8, 32])
def test_sorted_plain_equals_the_unsorted_plain_at_any_band_count(n_bands):
    # K7's plain twin (the rays re-sorted between bounces) against the
    # unsorted reference on the same Philox numbers: the same hits, so only
    # the float summation order of the scatter moves (SAME_ENERGY /
    # SAME_L1 of chip_smoke.py, 1e-5)
    room, params = _city(n_bands=n_bands)
    got = to_numpy(ak.trace_frames_ir_accel_sorted_plain(
        room.scene, params, 12, 2, **KW))
    want = to_numpy(ak.trace_frames_ir_accel_plain(room.scene, params, 12, 2,
                                                   **KW))
    assert got.shape == want.shape == (1, T, n_bands)
    assert (want[..., -1] != 0).sum() > 100
    for k in range(n_bands):
        g, w = got[..., k], want[..., k]
        assert abs(g.sum() - w.sum()) / w.sum() < 1e-5
        assert _l1(g, w) < 1e-5
    if n_bands > 1:   # the materials' high-frequency rolloff
        assert got[..., -1].sum() < got[..., 0].sum()


def test_banded_sorted_plain_matches_jax_k7_interpret():
    # the port's K7 re-sorts its rays between bounces; the JAX K7 keeps
    # them in emission order. Each ray draws the numbers of its original
    # (frame, ray) id, so on JAX's uniforms the two make the same hits:
    # the limits of test_accel_plain_matches_jax_kernel_interpret
    room, params = _city(n_bands=8)
    ref, p = _jax_city(n_bands=8)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jax_bk.trace_frames_ir_accel(
        ref.scene, p, key, n_frames=1, in_kernel_rng=False, **KW))
    emit, u = jax_rng.bounce_uniforms(key, KW["max_bounces"], KW["n_rays"])
    got = to_numpy(ak.trace_frames_ir_accel_sorted_plain(
        room.scene, params, 0, 1, uniforms=(to_torch(emit)[None],
                                            to_torch(u)[None]), **KW))
    assert got.shape == want.shape == (1, T, 8)
    assert (want != 0).sum() > 100
    for k in (0, 7):
        assert abs(got[..., k].sum() - want[..., k].sum()) \
            / want[..., k].sum() < 1e-2
        assert _l1(got[..., k], want[..., k]) < 2e-2


def test_energy_buffer_rows_and_frame_passes(monkeypatch):
    # K7's energy rows: K padded to a multiple of 4 (16-byte loads), none
    # at K = 1; frames run in passes whose two energy buffers fit the
    # scratch cap, at least one frame a pass
    assert [ak.energy_rows(k) for k in (1, 2, 4, 5, 8, 32, 33, 512)] == \
        [0, 4, 4, 8, 8, 32, 36, 512]
    assert ak.frames_per_pass(1, 4, 131072) == 4
    assert ak.frames_per_pass(32, 4, 131072) == 4
    assert ak.frames_per_pass(512, 4, 131072) == 2
    monkeypatch.setattr(bk, "SCRATCH_FLOATS", 1000)
    assert ak.frames_per_pass(8, 4, 131072) == 1
    assert ak.frames_per_pass(1, 4, 131072) == 4


def test_sorted_plain_has_the_plain_trace_hits():
    room, params = _city()
    kw = dict(KW, max_bounces=4)
    sorted_scene = ak.prepare(room.scene).scene
    got = to_numpy(ak.trace_frames_ir_accel_sorted_plain(
        room.scene, params, 9, 2, **kw))
    want = to_numpy(bk.trace_frames_ir_mega_plain(sorted_scene, params, 9,
                                                  2, **kw))
    assert (want != 0).sum() > 100
    assert _l1(got, want) <= 1e-6
    assert ((got != 0) == (want != 0)).all()
    # K7's plain version is the plain trace on that sorted scene
    assert torch.equal(ak.trace_frames_ir_accel_plain(room.scene, params, 9,
                                                      2, **kw),
                       torch.from_numpy(want))


@pytest.mark.parametrize("n_bands,ray_chunk", [(1, 100), (8, 100), (1, 512)])
def test_plain_versions_over_ray_slices_have_the_same_hits(n_bands,
                                                           ray_chunk):
    room, params = _city(n_bands=n_bands)
    plain = (ak.trace_frames_ir_accel_sorted_plain if n_bands == 1
             else ak.trace_frames_ir_accel_plain)
    want = to_numpy(plain(room.scene, params, 8, 2, **KW))
    got = to_numpy(plain(room.scene, params, 8, 2, ray_chunk=ray_chunk,
                         **KW))
    assert (want != 0).sum() > 100
    assert _l1(got, want) <= 1e-6
    assert ((got != 0) == (want != 0)).all()
    if n_bands == 1:   # the slices of K7's plain version as well
        k7 = to_numpy(ak.trace_frames_ir_accel_plain(
            room.scene, params, 8, 2, ray_chunk=ray_chunk, **KW))
        assert _l1(k7, want) <= 1e-6


def test_results_do_not_move_with_the_cluster_size(monkeypatch):
    room, params = _city(150, 2, 100.0)
    a = ak.trace_frames_ir_accel_sorted_plain(room.scene, params, 4, 1, **KW)
    monkeypatch.setattr(accel, "accel_layout", lambda n: (8, 8))
    assert ak.prepare(room.scene).group == 8
    b = ak.trace_frames_ir_accel_sorted_plain(room.scene, params, 4, 1, **KW)
    assert float(a.sum()) > 0 and _l1(to_numpy(b), to_numpy(a)) <= 1e-6


def test_sorted_plain_statistical_parity_with_jax_kernel():
    room, params = _city()
    ref, p = _jax_city()
    kw = dict(n_rays=4096, max_bounces=4, sample_rate=SR, ir_length=T,
              n_frames=2)
    want = np.asarray(jax_bk.trace_frames_ir_accel_sorted(
        ref.scene, p, jax.random.PRNGKey(7), cluster_size=128, **kw))
    got = to_numpy(ak.trace_frames_ir_accel_sorted_plain(
        room.scene, params, 7, kw.pop("n_frames"), **kw))
    assert want.sum() > 0
    assert abs(got.sum() - want.sum()) / want.sum() < 0.15


@pytest.mark.parametrize("n_bands", [1, 8])
def test_trace_accumulate_accel_runs_the_plain_accel_version(n_bands):
    room, params = _city(n_bands=n_bands)
    launches = (ak.trace_frames_ir_accel.launches,
                ak.trace_frames_ir_accel_sorted.launches)
    st = art.trace_accumulate(
        room.scene, params, art.IRState.zeros(T, 1, n_bands, device=CPU),
        n_frames=2, seed=5, backend="accel", **{k: KW[k] for k in (
            "n_rays", "max_bounces", "sample_rate")})
    # K8 (K = 1) and K7 (K > 1) share one plain version
    want = ak.trace_frames_ir_accel_sorted_plain(room.scene, params, 5, 2,
                                                 **KW)
    assert st.frames == 2 and float(st.sum.sum()) > 0
    assert torch.equal(st.sum, want)
    assert (ak.trace_frames_ir_accel.launches,
            ak.trace_frames_ir_accel_sorted.launches) == launches


def test_trace_accumulate_accel_takes_host_uniforms_on_the_cpu():
    room, params = _city()
    uniforms = art.ops.rng.philox_uniforms(6, 1, 3, 512, CPU)
    kw = {k: KW[k] for k in ("n_rays", "max_bounces", "sample_rate")}
    given = art.trace_accumulate(room.scene, params,
                                 art.IRState.zeros(T, device=CPU),
                                 uniforms=uniforms, backend="accel", **kw)
    seeded = art.trace_accumulate(room.scene, params,
                                  art.IRState.zeros(T, device=CPU), seed=6,
                                  backend="accel", **kw)
    assert torch.equal(given.sum, seeded.sum)


def test_auto_on_a_cpu_city_runs_plain_and_the_engine_agrees():
    room, params = _city()
    kw = {k: KW[k] for k in ("n_rays", "max_bounces", "sample_rate")}
    st = art.trace_accumulate(room.scene, params,
                              art.IRState.zeros(T, device=CPU), n_frames=2,
                              seed=3, **kw)
    want = bk.trace_frames_ir_mega_plain(room.scene, params, 3, 2, **KW)
    assert torch.equal(st.sum, want) and float(want.sum()) > 0
    cfg = art.EngineConfig(
        sim=art.SimConfig(ray_count=KW["n_rays"], max_bounces=3,
                          listener_radius=room.listener_radius,
                          input_gain=10.0),
        audio=art.AudioConfig(sample_rate=SR, reverb_duration=T / SR))
    eng = art.Engine(room.scene, cfg)
    p = eng.params(room.source, room.listener)
    for backend in ("auto", "accel"):
        got = eng.trace_frames(p, seed=3, n_frames=2, backend=backend)
        ref = art.trace_accumulate(room.scene, p,
                                   art.IRState.zeros(T, device=CPU),
                                   n_frames=2, seed=3, backend=backend, **kw)
        assert torch.equal(got.sum, ref.sum) and got.frames == 2


def test_unknown_backend_raises():
    room, params = _city()
    with pytest.raises(ValueError, match="backend"):
        art.trace_accumulate(room.scene, params,
                             art.IRState.zeros(T, device=CPU), n_rays=64,
                             max_bounces=2, sample_rate=SR, backend="fused")


def test_accel_support_checks():
    room, params = _city()
    ak.check_accel_supported(room.scene, params)
    # K7 and K8, one sorted kernel, take any band count (the JAX K8 one)
    for k in (9, 32, 512):
        banded = rooms.city_scene(10, n_bands=k, device=CPU).scene
        ak.check_accel_supported(banded, params)
    with pytest.raises(ValueError, match="one source"):
        ak.check_accel_supported(_city(n_bands=8)[0].scene, params._replace(
            source=torch.zeros(2, 2)))
    ak.check_accel_supported(room.scene, params._replace(
        directivity=torch.ones(3), mic_directivity=torch.ones(5)))
    with pytest.raises(ValueError, match="mic_directivity"):
        ak.check_accel_supported(
            room.scene, params._replace(mic_directivity=torch.ones(2, 3)))
    # any listener count: blocks beside the super boxes; patterns too
    # large for a block's shared memory are refused
    many = TraceParams.make(room.source, np.zeros((17, 2), np.float32),
                            device=CPU)
    ak.check_accel_supported(room.scene, many)
    prep = ak.prepare(room.scene)
    assert ak._listener_step(prep, 0, 0) > 10000
    with pytest.raises(NotImplementedError, match="shared memory"):
        ak._listener_step(prep, 60001, 1)


def _smem_bytes(prep, n_listeners, n_src, n_mic):
    """The dynamic shared memory of a K7/K8 launch, as
    ``csrc/accel_kernel.cu::smem_bytes`` counts it (super boxes, their
    visit order and keys), plus the 96 B of the order's block
    reduction."""
    n_super = prep.n_clusters // prep.group
    return (24 * n_super + 4 * (2 * n_listeners + n_listeners * n_mic
                                + n_src) + 96)


@pytest.mark.parametrize("n_bands", [1, 8])
@pytest.mark.parametrize("n_src,n_mic", [(0, 0), (1, 5), (9, 3621)])
def test_listener_step_fills_a_block(n_bands, n_src, n_mic):
    # K7/K8 listener blocks: the most listeners whose table fits the 227
    # KB of a block beside the super boxes, and the blocks cover the
    # listeners in order, at any band count
    room, _ = _city(n_bands=n_bands)
    prep = ak.prepare(room.scene)
    step = ak._listener_step(prep, n_src, n_mic)
    assert _smem_bytes(prep, step, n_src, n_mic) <= 232448
    assert _smem_bytes(prep, step + 1, n_src, n_mic) > 232448
    if n_mic:
        assert step == 16 if n_mic == 3621 else step > 1000
        mic = torch.ones(n_mic)
        src = torch.ones(n_src)
    else:
        mic = src = None
    n_l = 2 * step + 3
    params = TraceParams.make(room.source, np.zeros((n_l, 2), np.float32),
                              device=CPU)._replace(directivity=src,
                                                   mic_directivity=mic)
    blocks = list(ak._blocks(prep, params))
    assert [(l0, n) for _, l0, n in blocks] == [(0, step), (step, step),
                                                (2 * step, 3)]
    for (args, _), l0, n in blocks:
        assert args[1:4:2] == ((n_src, n_mic) if n_mic else (0, 0))


def test_banded_wall_table_layout():
    room, _ = _city(n_bands=8)
    prep = ak.prepare(room.scene)
    w = prep.walls
    assert tuple(w.shape) == (18, prep.scene.n_walls) and w.is_contiguous()
    assert torch.equal(w[:11], bk.pack_walls(prep.scene))
    assert torch.equal(w[11:], prep.scene.absorption[:, 1:].T)
    assert prep.n_clusters * prep.cluster_size == prep.scene.n_walls
    assert tuple(prep.saabb.shape) == (prep.n_clusters // prep.group, 4)
    scene = convert.scene_from_arrays(_jax_city(n_bands=8)[0].scene,
                                      device=CPU)
    assert torch.equal(ak.prepare(scene).walls, w)


# --- the wall sweeps' box walk (K1/K2 past BOX_WALK_MIN_WALLS) ---------------

def _sweep_case(scene, n_rays, seed):
    """Rays from a numpy seed over a scene: random origins in its box and
    directions, a third aimed at the midpoint of wall 9 (and its copies in
    the tie scene), an alive mask and limits."""
    gen = np.random.default_rng(seed)
    a = to_numpy(scene.a)
    lo, hi = a.min(0), a.max(0)
    o = gen.uniform(lo, hi, (n_rays, 2)).astype(np.float32)
    ang = gen.uniform(0, 2 * np.pi, n_rays)
    d = np.stack([np.cos(ang), np.sin(ang)], -1)
    mid = 0.5 * (a[9] + to_numpy(scene.b)[9])
    aim = mid - o[:n_rays // 3]
    d[:n_rays // 3] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    alive = gen.uniform(size=n_rays) > 0.25
    limit = gen.uniform(0, np.linalg.norm(hi - lo), n_rays)
    return (to_torch(o), to_torch(d.astype(np.float32)), torch.as_tensor(
        alive), to_torch(limit.astype(np.float32)))


def _tie_scene():
    """city_scene(62) with 40 copies of wall 9 appended: equal distances
    on a run of 41 sorted walls, longer than a cluster."""
    scene = rooms.city_scene(62, device=CPU).scene
    copies = torch.tensor([9] * 40)
    return Scene(*(torch.cat([x, x[copies]]) for x in scene))


@pytest.mark.parametrize("which", [62, 250, "tie"])
def test_box_walk_mirror_is_the_plain_sweep_bit_for_bit(which):
    """The plain mirror of the box walk (``walk_nearest_plain``) on the
    sorted tables, with the caller's ids as the tie rule, ``alive`` and
    ``limit`` and the min-only variant of K2, equals ``nearest_hit_plain``
    / ``occlusion_min_plain`` on the unsorted table bit for bit, in the
    near-to-far visit order and in its reverse (later clusters first)."""
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        trace_kernel as tk
    scene = _tie_scene() if which == "tie" else \
        rooms.city_scene(which, device=CPU).scene
    cs, group = accel.accel_layout(scene.n_walls)
    sorted_s, aabb, ids = accel.cluster_scene_ids(scene, cs, group)
    o, d, alive, limit = _sweep_case(scene, 320, 3)
    packed = tk.pack_walls(scene)
    block = 64
    order = accel.block_rank_order(o[:, 0], o[:, 1], alive,
                                   accel.super_aabbs(aabb, group), block)
    t_p, idx_p = tk.nearest_hit_plain(o, d, packed)
    t_m, idx_m = tk.nearest_hit_plain(o, d, packed, alive)
    occ = tk.occlusion_min_plain(o, d, packed, alive, limit)
    assert int((idx_p >= 0).sum()) > 160 and int((occ < INF).sum()) > 20
    for visit in (order, order.flip(1)):
        walk = dict(scene=sorted_s, aabb=aabb, group=group, o=o, d=d,
                    order=visit, block=block, ids=ids)
        t, idx = accel.walk_nearest_plain(**walk)
        assert torch.equal(t, t_p) and torch.equal(idx, idx_p)
        t, idx = accel.walk_nearest_plain(**walk, alive=alive)
        assert torch.equal(t, t_m) and torch.equal(idx, idx_m)
        t, _ = accel.walk_nearest_plain(**walk, alive=alive, limit=limit,
                                        want_index=False)
        assert torch.equal(t, occ)
    if which == "tie":   # the copies tie with wall 9: its index wins
        same = (idx_p >= 0) & (scene.a[idx_p.clamp(min=0).long()]
                               == scene.a[9]).all(-1) \
            & (scene.b[idx_p.clamp(min=0).long()] == scene.b[9]).all(-1)
        # ... and the run of copies spans clusters, which the reversed
        # order visits from the highest id down
        run = (sorted_s.a == scene.a[9]).all(-1) \
            & (sorted_s.b == scene.b[9]).all(-1)
        assert int(run.sum()) == 41 and len(
            {int(i) // cs for i in torch.nonzero(run)}) >= 3
        assert int(same.sum()) > 20 and bool((idx_p[same] == 9).all())


def test_box_walk_mirror_matches_jax_nearest_hit_pallas_interpret():
    """The mirror's ``(closest, idx)`` on ``city_scene(62)``'s sorted tables
    against JAX's ``nearest_hit_pallas`` in interpret mode on the unsorted
    table, 700 rays: indices equal, distances rtol 5e-5 / atol 1e-4 (the
    limits of tests/test_torch_trace_kernel.py)."""
    import jax.numpy as jnp
    from realisticaudioraytracing2d_tpu.ops.pallas import \
        trace_kernel as jax_tk
    scene = rooms.city_scene(62, device=CPU).scene
    cs, group = accel.accel_layout(scene.n_walls)
    sorted_s, aabb, ids = accel.cluster_scene_ids(scene, cs, group)
    o, d, alive, _ = _sweep_case(scene, 700, 4)
    order = accel.block_rank_order(o[:, 0], o[:, 1],
                                   torch.ones(700, dtype=torch.bool),
                                   accel.super_aabbs(aabb, group), 128)
    t, idx = accel.walk_nearest_plain(sorted_s, aabb, group, o, d, order,
                                      128, ids=ids)
    t_j, idx_j = jax_tk.nearest_hit_pallas(
        jnp.asarray(to_numpy(o)), jnp.asarray(to_numpy(d)),
        jax_tk.pack_walls(jnp.asarray(to_numpy(scene.a)),
                          jnp.asarray(to_numpy(scene.b))), tile_r=256)
    assert int((idx >= 0).sum()) > 350
    np.testing.assert_array_equal(to_numpy(idx), np.asarray(idx_j))
    np.testing.assert_allclose(to_numpy(t), np.asarray(t_j), rtol=5e-5,
                               atol=1e-4)


@pytest.mark.parametrize("n_boxes", [62, 1500])
def test_prepare_carries_the_ids_that_invert_the_sort(n_boxes):
    """``prepare``'s ``ids`` are a permutation of the padded scene's walls
    that gives the sorted scene, and its geo plane and cc row are the
    caller's packed table (``trace_kernel.pack_walls``) permuted by them,
    bit for bit; ``cluster_scene`` keeps its two return values."""
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        trace_kernel as tk
    scene = rooms.city_scene(n_boxes, device=CPU).scene
    prep = ak.prepare(scene)
    wp = prep.geo.shape[0]
    ids = prep.ids.long()
    assert prep.ids.dtype == torch.int32 and tuple(prep.ids.shape) == (wp,)
    assert torch.equal(torch.sort(ids).values, torch.arange(wp))
    padded = scene.pad_to(wp)
    for got, want in zip(prep.scene, padded):
        assert torch.equal(got, want[ids])
    packed = tk.pack_walls(padded)
    assert torch.equal(prep.geo, packed[:4, ids].T)
    assert torch.equal(prep.walls[4], packed[4, ids])
    cs, group = prep.cluster_size, prep.group
    two = accel.cluster_scene(scene, cs, group)
    assert len(two) == 2 and torch.equal(two[1], prep.aabb)
