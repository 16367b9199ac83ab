"""PyTorch port: the one-frame kernels' wrappers and plain versions (K5
``trace_fused_rows`` / ``trace_fused`` / ``scatter_hits_rows``, K6
``trace_frame_ir_fused``, and the ``exact_scatter`` route), their
contract (one band; K6 at most 16 listeners) and K5's launch plan.

On the CPU the wrappers run the plain versions (``ops/trace.py::_bounce``
one bounce at a time on an explicit state), held here against JAX's
kernels in interpret mode on JAX's own uniforms, and against the port's
own plain trace and plain K3 bit for bit. tests/test_torch_cuda.py holds
the CUDA kernels against these plain versions on the card.

Tolerances against JAX. JAX's K5 uses a Newton reciprocal and a
division-free segment test, so it differs from JAX's own ``trace`` by
razor-edge hits; the port's K5 follows the port's plain ``_bounce``
exactly. Hence no per-hit equality: valid masks agree on >= 99.5% of the
entries (the JAX package's own limit between its K5 and its trace), the
energy of the scattered IR to 3% and its per-bin L1 to 5%. JAX's K6 bins
through bf16 one-hots (~0.4% per hit): the port is compared with JAX's
``exact_scatter`` route within energy 1% and L1 2%, and with JAX's K6
within its bf16 limit on top (L1 3%)."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import jax_frame_uniforms, to_numpy, to_torch

from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.models.materials import AudioMaterial
from realisticaudioraytracing2d_tpu.models.scene import SceneBuilder
from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
from realisticaudioraytracing2d_tpu.ops.ir import IRState as JaxIRState
from realisticaudioraytracing2d_tpu.ops.pallas import bounce_kernel as jax_bk
from realisticaudioraytracing2d_tpu.ops.trace import \
    TraceParams as JaxTraceParams
from realisticaudioraytracing2d_tpu_torch import convert, engine
from realisticaudioraytracing2d_tpu_torch.ops import ir as irm
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.ops import trace as tt
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk

R, B, SR, T = 1024, 4, 8000, 2048


@pytest.fixture(scope="module")
def setup():
    room = jax_rooms.smoll_room()
    p = JaxTraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    key = jax.random.PRNGKey(3)
    emit, u = jax_rng.bounce_uniforms(key, B, R)
    return (room, p, key, convert.scene_from_arrays(room.scene, device="cpu"),
            convert.params_from_arrays(p, device="cpu"), to_torch(emit),
            to_torch(u))


def _l1(got, want):
    return np.abs(got - want).sum() / np.abs(want).sum()


def test_rows_are_the_plain_trace_hits_bit_for_bit(setup):
    _, _, _, scene, params, emit, u = setup
    rows = bk.trace_fused_rows(scene, params, emit, u)
    assert tuple(rows.shape) == (B, 8, R) and rows.dtype == torch.float32
    assert torch.equal(rows, bk.trace_fused_rows_plain(scene, params, emit, u))
    assert float(rows[:, 6:].abs().sum()) == 0.0
    hits = bk.trace_fused(scene, params, emit, u)
    want = tt.trace_hits_only(scene, params, emit, u)
    assert tuple(hits.energy.shape) == (B, 2, R, 1, 1)
    assert int(want.valid.sum()) > 200
    assert torch.equal(hits.valid, want.valid)
    v = want.valid
    assert torch.equal(hits.delay[v], want.delay[v])
    assert torch.equal(hits.energy[..., 0][v], want.energy[..., 0][v])
    # the rows of a hit that did not happen are zeros
    assert float(hits.delay[~v].abs().sum()) == 0.0
    assert float(hits.energy[..., 0][~v].abs().sum()) == 0.0


def test_rows_match_jax_rows_kernel_interpret(setup):
    room, p, key, scene, params, emit, u = setup
    rows_j = np.asarray(jax_bk.trace_fused_rows(room.scene, p, key, n_rays=R,
                                                max_bounces=B, tile_r=256))
    rows = to_numpy(bk.trace_fused_rows(scene, params, emit, u))
    assert rows.shape == rows_j.shape
    vj, vt = rows_j[:, [2, 5]] > 0.5, rows[:, [2, 5]] > 0.5
    assert vj.sum() > 200 and (vj != vt).mean() < 5e-3
    ir_j = np.asarray(jax_bk.scatter_hits_rows(rows_j, SR, T))
    ir = to_numpy(bk.scatter_hits_rows(to_torch(rows), SR, T))
    assert ir.shape == (1, T, 1) == ir_j.shape
    assert abs(ir.sum() - ir_j.sum()) / ir_j.sum() < 3e-2
    assert _l1(ir, ir_j) < 5e-2


def test_scatter_rows_matches_scatter_hits(setup):
    """``scatter_hits_rows`` adds the same hits as ``ir.scatter_hits`` in
    another order (all direct rows, then all NEE rows): equal to float
    round-off, rtol 1e-6 as in the JAX package's own test."""
    _, _, _, scene, params, emit, u = setup
    rows = bk.trace_fused_rows(scene, params, emit, u)
    ir_rows = to_numpy(bk.scatter_hits_rows(rows, SR, T))
    ir_hits = to_numpy(irm.scatter_hits(bk.hits_from_rows(rows), SR, T))
    assert ir_hits.sum() > 0
    np.testing.assert_allclose(ir_rows, ir_hits, rtol=1e-6, atol=1e-8)
    # JAX's scatter of the same rows: the same function
    ir_j = np.asarray(jax_bk.scatter_hits_rows(to_numpy(rows), SR, T))
    np.testing.assert_allclose(ir_rows, ir_j, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("n_listeners", [1, 2])
def test_fused_ir_plain_is_plain_k3_bit_for_bit(setup, n_listeners):
    room, _, _, scene, params, emit, u = setup
    lis = np.stack([room.listener, room.listener + [1.5, 0.5]])[:n_listeners]
    params = params._replace(listeners=to_torch(lis.astype(np.float32)))
    kw = dict(sample_rate=SR, ir_length=T)
    k6 = bk.trace_frame_ir_fused(scene, params, emit, u, **kw)
    k3 = bk.trace_frames_ir_whole(scene, params, emit[None], u[None], **kw)
    assert tuple(k6.shape) == (n_listeners, T, 1) and float(k6.sum()) > 0
    assert torch.equal(k6, k3)
    assert torch.equal(k6, bk.trace_frame_ir_fused_plain(scene, params, emit,
                                                         u, **kw))


def test_fused_ir_with_a_seed_is_k4_of_one_frame(setup):
    _, _, _, scene, params, _, _ = setup
    kw = dict(n_rays=256, max_bounces=B, sample_rate=SR, ir_length=T)
    k6 = bk.trace_frame_ir_fused(scene, params, seed=9, **kw)
    assert torch.equal(k6, bk.trace_frames_ir_mega(scene, params, 9, 1, **kw))
    with pytest.raises(ValueError, match="either"):
        bk.trace_frame_ir_fused(scene, params, sample_rate=SR, ir_length=T)
    with pytest.raises(ValueError, match="n_rays"):
        bk.trace_frame_ir_fused(scene, params, seed=9, sample_rate=SR,
                                ir_length=T)


def test_fused_ir_matches_jax_exact_scatter_and_hist_kernel(setup):
    room, p, key, scene, params, _, _ = setup
    n_frames = 2
    kw = dict(n_rays=R, max_bounces=B, sample_rate=SR, n_frames=n_frames,
              tile_r=256)
    exact_j = jax_bk.trace_accumulate_fused(
        room.scene, p, JaxIRState.zeros(T, 1, 1), key, exact_scatter=True,
        **kw)
    hist_j = jax_bk.trace_accumulate_fused(
        room.scene, p, JaxIRState.zeros(T, 1, 1), key, **kw)
    emit, u = jax_frame_uniforms(key, n_frames, B, R)
    for exact in (False, True):
        got = bk.trace_accumulate_fused(
            scene, params, irm.IRState.zeros(T, 1, 1, device="cpu"), emit, u,
            sample_rate=SR, exact_scatter=exact)
        assert got.frames == n_frames == int(exact_j.frames)
        a, want = to_numpy(got.sum), np.asarray(exact_j.sum)
        assert (want != 0).sum() > 100
        assert abs(a.sum() - want.sum()) / want.sum() < 1e-2
        assert _l1(a, want) < 2e-2
        assert _l1(a, np.asarray(hist_j.sum)) < 3e-2


def test_exact_scatter_route_runs_one_rows_pass_per_listener(setup):
    room, _, _, scene, params, emit, u = setup
    lis = np.stack([room.listener, room.listener + [1.5, 0.5]])
    p2 = params._replace(listeners=to_torch(lis.astype(np.float32)))
    state = irm.IRState.zeros(T, 2, 1, device="cpu")
    got = bk.trace_accumulate_fused(scene, p2, state, emit[None], u[None],
                                    sample_rate=SR, exact_scatter=True)
    want = bk.trace_frames_ir_plain(scene, p2, emit[None], u[None],
                                    sample_rate=SR, ir_length=T)
    assert got.frames == 1 and tuple(got.sum.shape) == (2, T, 1)
    np.testing.assert_allclose(to_numpy(got.sum), to_numpy(want), rtol=1e-6,
                               atol=1e-8)
    assert not torch.equal(got.sum[0], got.sum[1])


def test_rows_refuse_what_they_do_not_take(setup):
    room, _, _, scene, params, emit, u = setup
    lis = np.stack([room.listener, room.listener + [1.5, 0.5]])
    p2 = params._replace(listeners=to_torch(lis.astype(np.float32)))
    with pytest.raises(ValueError, match="one listener"):
        bk.trace_fused_rows(scene, p2, emit, u)
    with pytest.raises(ValueError, match="one listener"):
        bk._check_rows_supported(scene, p2)
    banded = convert.scene_from_arrays(jax_rooms.smoll_room(n_bands=2).scene,
                                       device="cpu")
    with pytest.raises(ValueError, match="n_bands == 1"):
        bk._check_rows_supported(banded, params)
    with pytest.raises(ValueError, match="directivity"):
        bk.trace_fused_rows(scene, params._replace(
            directivity=torch.ones(2)), emit, u)
    before = bk.trace_fused_rows.launches, bk.trace_frame_ir_fused.launches
    bk.trace_fused_rows(scene, params, emit, u)
    assert (bk.trace_fused_rows.launches,
            bk.trace_frame_ir_fused.launches) == before


def test_engine_routes_hits_on_the_cpu_to_the_plain_trace(setup):
    _, _, _, scene, params, emit, u = setup
    hits = engine.trace_hits(scene, params, emit, u)
    want = tt.trace_hits_only(scene, params, emit, u)
    assert all(torch.equal(a, b) for a, b in zip(hits, want))
    e2, u2 = rng.philox_uniforms(5, 3, B, 64, "cpu")
    e1, u1 = rng.philox_uniforms(5, 1, B, 64, "cpu", first_frame=2)
    assert torch.equal(e1[0], e2[2]) and torch.equal(u1[0], u2[2])


def test_fused_ir_refuses_bands_like_jax(setup):
    """K6 and its accumulate entry point take one band, as the JAX
    ``trace_frame_ir_fused`` does, on the CPU as on the card (the kernel
    would otherwise be handed one band of a banded scene)."""
    room, p, key, _, params, emit, u = setup
    banded_j = jax_rooms.smoll_room(n_bands=2).scene
    banded = convert.scene_from_arrays(banded_j, device="cpu")
    with pytest.raises(ValueError, match="one band"):
        jax_bk.trace_frame_ir_fused(banded_j, p, key, n_rays=R, max_bounces=B,
                                    sample_rate=SR, ir_length=T)
    kw = dict(sample_rate=SR, ir_length=T)
    with pytest.raises(ValueError, match="one band"):
        bk.trace_frame_ir_fused(banded, params, emit, u, **kw)
    with pytest.raises(ValueError, match="one band"):
        bk.trace_frame_ir_fused(banded, params, seed=3, n_rays=R,
                                max_bounces=B, **kw)
    for exact in (False, True):
        with pytest.raises(ValueError, match="one band"):
            bk.trace_accumulate_fused(
                banded, params, irm.IRState.zeros(T, 1, 2, device="cpu"),
                emit[None], u[None], sample_rate=SR, exact_scatter=exact)


def test_fused_ir_refuses_more_than_16_listeners(setup):
    room, _, _, scene, params, emit, u = setup
    grid = np.stack(np.meshgrid(np.linspace(-2, 2, 17), [0.0]), -1)
    lis = (room.listener + grid.reshape(-1, 2)).astype(np.float32)
    kw = dict(sample_rate=SR, ir_length=T)
    e, v = emit[:64], u[:, :64]
    p16 = params._replace(listeners=to_torch(lis[:16]))
    assert tuple(bk.trace_frame_ir_fused(scene, p16, e, v, **kw).shape) == \
        (16, T, 1)
    p17 = params._replace(listeners=to_torch(lis))
    with pytest.raises(ValueError, match="16 listeners"):
        bk.trace_frame_ir_fused(scene, p17, e, v, **kw)
    with pytest.raises(ValueError, match="16 listeners"):
        bk.trace_frame_ir_fused(scene, p17, seed=3, n_rays=64,
                                max_bounces=B, **kw)
    for exact in (False, True):
        with pytest.raises(ValueError, match="16 listeners"):
            bk.trace_accumulate_fused(
                scene, p17, irm.IRState.zeros(T, 17, 1, device="cpu"),
                e[None], v[None], sample_rate=SR, exact_scatter=exact)


def _open_corridor():
    """Two parallel walls 6 m apart, open at both ends: the rays that leave
    along the corridor escape at once, the others after a few bounces."""
    mat = AudioMaterial(0.2, 0.3, 0.0, 1.0)
    builder = SceneBuilder()
    builder.add_segment((-4.0, -3.0), (4.0, -3.0), (0.0, 1.0), mat)
    builder.add_segment((-4.0, 3.0), (4.0, 3.0), (0.0, -1.0), mat)
    return builder.build()


def test_rows_after_a_ray_dies_are_zeros():
    """On a scene where most rays escape before bounce B, the plain rows of
    every bounce after a ray dies, and of every hit that did not happen,
    are zeros (the kernel writes the same, with no memset). Where a hit
    is valid the rows are JAX's ``trace_fused_rows`` in interpret mode
    within the JAX package's own limits between its K5 and its trace;
    JAX leaves stale values where valid = 0, so only valid rows compare."""
    scene_j = _open_corridor()
    p = JaxTraceParams.make(np.array([0.0, 0.0], np.float32),
                            np.array([1.5, 1.0], np.float32), 0.5, 343.0,
                            1.0)
    key = jax.random.PRNGKey(5)
    emit_j, u_j = jax_rng.bounce_uniforms(key, B, R)
    scene = convert.scene_from_arrays(scene_j, device="cpu")
    params = convert.params_from_arrays(p, device="cpu")
    emit, u = to_torch(emit_j), to_torch(u_j)
    rows = bk.trace_fused_rows(scene, params, emit, u)
    # when each ray dies: alive after bounce b, from the plain state
    st = tt._emit(params, R, 1, emit)
    alive = []
    for b in range(B):
        st, _ = tt._bounce(scene, params, st, u[b])
        alive.append(st.alive)
    alive = torch.stack(alive)                                   # [B, R]
    dead_before = torch.cat([torch.zeros_like(alive[:1]), ~alive[:-1]])
    assert 0.2 < float(dead_before[-1].float().mean()) < 0.95
    assert float(rows.permute(0, 2, 1)[dead_before].abs().sum()) == 0.0
    for v, cols in ((rows[:, 2], rows[:, 0:2]), (rows[:, 5], rows[:, 3:5])):
        assert float((cols * (v == 0)[:, None]).abs().sum()) == 0.0
    assert float(rows[:, 6:].abs().sum()) == 0.0
    rows_j = np.asarray(jax_bk.trace_fused_rows(scene_j, p, key, n_rays=R,
                                                max_bounces=B, tile_r=256))
    got = to_numpy(rows)
    vt, vj = got[:, [2, 5]] > 0.5, rows_j[:, [2, 5]] > 0.5
    assert vt.sum() > 100 and (vt != vj).mean() < 5e-3
    both = vt & vj
    np.testing.assert_allclose(got[:, [0, 3]][both], rows_j[:, [0, 3]][both],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[:, [1, 4]][both], rows_j[:, [1, 4]][both],
                               rtol=1e-2, atol=1e-9)


@pytest.mark.parametrize("n_rays,lanes", [
    (15000, 4),              # the stream's and the CLI's frame: 235 blocks
    (16896, 4),              # the largest frame that takes lane groups
    (16897, 1),
    (131072, 1),             # the bench frame: 512 blocks of one lane a ray
])
def test_rows_launch_plan(n_rays, lanes):
    """K5 launches in K3's lane groups for one frame of one band: 4 lanes a
    ray while its ``n_rays * 4`` threads stay within 16 warps per SM of
    the card's 132, in blocks of 256."""
    assert bk.lane_group(n_rays, 1) == lanes
    assert (n_rays * bk.LANE_GROUP <= bk.LANE_THREADS) == (lanes > 1)
