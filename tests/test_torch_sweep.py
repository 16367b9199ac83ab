"""PyTorch port: room datasets, stacking, the rooms-batched kernel's plain
version (K9) and the sweep, against the JAX package on the CPU.

Tolerances:
* ``random_rooms``, ``Scene.stack`` and the converter: bit for bit (the
  same numpy draws and float32 casts);
* plain sweep vs JAX ``sweep_rooms(backend="jnp")`` on JAX's per-room
  uniforms: total energy to 1e-4 and per-bin L1 to 1%, the limits of
  test_torch_bounce_kernel.py (an ulp of sin/cos can move a hit that sits
  on a bin edge to the next bin);
* plain K9 vs JAX ``trace_rooms_ir_mega`` in interpret mode (its
  fallback scans the whole-frame kernel, which bins through bf16
  one-hots, ~0.4% per hit): energy 1% and L1 2%.
Sizes: <= 8 rooms, <= 1,024 rays, <= 5 bounces, 8 kHz, 2,048 bins."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import CPU, jax_room_uniforms, to_numpy

from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.models.scene import Scene as JaxScene
from realisticaudioraytracing2d_tpu.ops.pallas import bounce_kernel as jax_bk
from realisticaudioraytracing2d_tpu.parallel import sweep as jax_sweep
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.models.scene import Scene
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams
from realisticaudioraytracing2d_tpu_torch.parallel.sweep import sweep_rooms

SR, T = 8000, 2048


def _assert_scene_equal(port, ref):
    for f in Scene._fields:
        got, want = to_numpy(getattr(port, f)), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _l1(got, want):
    return np.abs(got - want).sum() / np.abs(want).sum()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_obstacles", [1, 3])
def test_random_rooms_bit_equal_jax(seed, n_obstacles):
    scenes, src, lis = rooms.random_rooms(4, seed=seed,
                                          n_obstacles=n_obstacles,
                                          device=CPU)
    ref, ref_src, ref_lis = jax_rooms.random_rooms(4, seed=seed,
                                                   n_obstacles=n_obstacles)
    assert scenes.n_walls == 4 * (4 + n_obstacles)
    assert tuple(scenes.a.shape) == (4, scenes.n_walls, 2)
    _assert_scene_equal(scenes, ref)
    np.testing.assert_array_equal(src, ref_src)
    np.testing.assert_array_equal(lis, ref_lis)
    # the converter carries the stacked JAX batch across unchanged
    _assert_scene_equal(convert.scene_from_arrays(ref, device=CPU), ref)


def test_scene_stack_and_row_equal_jax():
    port = [rooms.smoll_room(pad_to=32, device=CPU).scene,
            rooms.shoebox_room(8.0, 5.0, pad_to=32, device=CPU)]
    ref = [jax_rooms.smoll_room(pad_to=32).scene,
           jax_rooms.shoebox_room(8.0, 5.0, pad_to=32)]
    stacked = Scene.stack(port)
    _assert_scene_equal(stacked, JaxScene.stack(ref))
    assert stacked.n_walls == 32 and stacked.n_bands == 1
    _assert_scene_equal(stacked.row(1), ref[1])
    assert tuple(stacked.row(slice(1, 2)).a.shape) == (1, 32, 2)


def test_sweep_plain_matches_jax_sweep():
    key = jax.random.PRNGKey(4)
    n_rooms, n_rays, n_bounces, n_frames = 4, 512, 5, 2
    ref, src, lis = jax_rooms.random_rooms(n_rooms, seed=3)
    want = np.asarray(jax_sweep.sweep_rooms(
        ref, src, lis, key, n_rays=n_rays, max_bounces=n_bounces,
        sample_rate=SR, ir_length=T, n_frames=n_frames, backend="jnp"))
    scenes, _, _ = rooms.random_rooms(n_rooms, seed=3, device=CPU)
    got = to_numpy(sweep_rooms(
        scenes, src, lis, 0, n_rays=n_rays, max_bounces=n_bounces,
        sample_rate=SR, ir_length=T, n_frames=n_frames, backend="plain",
        uniforms=jax_room_uniforms(key, n_rooms, n_frames, n_bounces,
                                   n_rays)))
    assert got.shape == want.shape == (n_rooms, 1, T, 1)
    assert (want.reshape(n_rooms, -1).sum(-1) > 0).all()
    assert abs(got.sum() - want.sum()) / want.sum() < 1e-4
    assert _l1(got, want) < 1e-2
    assert ((got != 0) == (want != 0)).mean() > 0.999


def test_sweep_room_offset_names_global_rooms():
    scenes, src, lis = rooms.random_rooms(8, seed=2, device=CPU)
    kw = dict(n_rays=256, max_bounces=4, sample_rate=SR, ir_length=T,
              n_frames=1)
    whole = sweep_rooms(scenes, src, lis, 9, **kw)
    tail = sweep_rooms(scenes.row(slice(4, 8)), src[4:], lis[4:], 9,
                       room_offset=4, **kw)
    assert tuple(whole.shape) == (8, 1, T, 1)
    assert torch.equal(tail, whole[4:])
    assert not torch.equal(whole[0], whole[4])
    assert float(whole.sum()) > 0


def test_sweep_divides_by_the_frame_count():
    scenes, src, lis = rooms.random_rooms(2, seed=1, device=CPU)
    kw = dict(n_rays=256, max_bounces=4, sample_rate=SR, ir_length=T)
    summed = bk.trace_rooms_ir_mega(scenes, src, lis, 5, 3, **kw)
    swept = sweep_rooms(scenes, src, lis, 5, n_frames=3, **kw)
    assert torch.equal(swept, summed / torch.tensor(3.0))
    with pytest.raises(ValueError, match="backend"):
        sweep_rooms(scenes, src, lis, 5, backend="jnp", **kw)


@pytest.mark.parametrize("layout", ["stacked", "shared"])
def test_rooms_plain_matches_jax_rooms_kernel_interpret(layout):
    key = jax.random.PRNGKey(12)
    n_rays, n_bounces = 512, 4
    if layout == "stacked":
        ref, src, lis = jax_rooms.random_rooms(2, seed=5)
        gains = np.float32(1.0)
    else:                    # one scene shared by every entry (a mixdown)
        room = jax_rooms.smoll_room()
        ref = jax.tree_util.tree_map(lambda x: x[None], room.scene)
        src = np.stack([room.source, room.source + [3.0, -1.0]])
        lis = np.stack([room.listener, room.listener])
        gains = np.array([1.0, 2.5], np.float32)
    want = np.asarray(jax_bk.trace_rooms_ir_mega(
        ref, src, lis, key, n_rays=n_rays, max_bounces=n_bounces,
        sample_rate=SR, ir_length=T, n_frames=1, input_gain=gains))
    got = to_numpy(bk.trace_rooms_ir_mega_plain(
        convert.scene_from_arrays(ref, device=CPU), src, lis, 0, 1,
        n_rays=n_rays, max_bounces=n_bounces, sample_rate=SR, ir_length=T,
        input_gain=gains,
        uniforms=jax_room_uniforms(key, 2, 1, n_bounces, n_rays)))
    assert got.shape == want.shape == (2, 1, T, 1)
    assert (want != 0).sum() > 100
    assert abs(got.sum() - want.sum()) / want.sum() < 1e-2
    assert _l1(got, want) < 2e-2


def test_rooms_wrapper_on_cpu_runs_plain_without_counting():
    scenes, src, lis = rooms.random_rooms(3, seed=4, device=CPU)
    kw = dict(n_rays=256, max_bounces=4, sample_rate=SR, ir_length=T)
    before = bk.trace_rooms_ir_mega.launches
    got = bk.trace_rooms_ir_mega(scenes, src, lis, 6, 2, entry_offset=10,
                                 **kw)
    want = torch.stack([bk.trace_frames_ir_plain(
        scenes.row(e), TraceParams.make(src[e], lis[e], device=CPU),
        *rng.philox_uniforms(6, 2, 4, 256, CPU, entry=10 + e),
        sample_rate=SR, ir_length=T) for e in range(3)])
    assert torch.equal(got, want)
    assert bk.trace_rooms_ir_mega.launches == before


def test_batch_support_checks():
    scenes, src, lis = rooms.random_rooms(2, seed=0, device=CPU)
    bk.check_batch_supported(scenes)
    # any band count (and any listener count: the launch runs blocks)
    banded, _, _ = rooms.random_rooms(2, seed=0, n_bands=4, device=CPU)
    bk.check_batch_supported(banded)
    # past the wall limit K9 refuses; sweep_rooms and trace_sources_mixdown
    # route such batches to the cluster kernels instead
    wide = Scene.stack(
        [rooms.smoll_room(device=CPU).scene.pad_to(bk.MAX_WALLS + 1)] * 2)
    with pytest.raises(ValueError, match="K7/K8"):
        bk.check_batch_supported(wide)
    with pytest.raises(ValueError, match="leading dim"):
        bk.trace_rooms_ir_mega(scenes, np.zeros((3, 2), np.float32),
                               np.zeros((3, 2), np.float32), 0, 1,
                               n_rays=8, max_bounces=1, sample_rate=SR,
                               ir_length=16)


def test_fixed_point_scales_per_entry():
    src = torch.tensor([[0.0, 0.0], [0.0, 0.0], [5.0, 5.0]])
    lis = torch.tensor([[[10.0, 0.0]], [[0.05, 0.0]], [[5.0, 6.0]]])
    gains = torch.tensor([1.0, 1.0, 2.0])
    s = bk.fixed_point_scales(src, lis, gains, 8, 15000, 5)
    assert s.dtype == torch.float64 and tuple(s.shape) == (3,)
    # a near listener lowers only its own room's scale
    assert float(s[1]) < float(s[0]) and float(s[2]) == float(s[0]) / 2
    worst = 8 * 15000 * 2 * 5 * torch.tensor(
        [1.0, 0.5 / 0.05 ** 2, 2.0], dtype=torch.float64) * s
    assert bool((worst < 2.0 ** 62).all() and (worst >= 2.0 ** 61).all())
    # the single-scene scale is entry 0 of the batched one
    p = TraceParams.make(src[0], lis[0], device=CPU)
    assert float(bk.fixed_point_scale(p, 8, 15000, 5)) == float(s[0])


def test_philox_entry_zero_is_the_single_scene_stream():
    emit0, u0 = rng.philox_uniforms(77, 2, 3, 64, CPU)
    k0, k1 = rng.seed_key(77)
    ray = torch.arange(64).expand(2, 4, 64)
    c1 = torch.arange(2)[:, None, None].expand_as(ray)
    c2 = torch.arange(4)[None, :, None].expand_as(ray)
    w0, w1, w2, _ = rng.philox4x32(ray, c1, c2, torch.zeros_like(ray), k0,
                                   k1)
    assert torch.equal(emit0, (w0[:, 3] >> 8).float() * 2.0 ** -24)
    assert torch.equal(u0[..., 1], (w1[:, :3] >> 8).float() * 2.0 ** -24)
    assert torch.equal(u0[..., 2], (w2[:, :3] >> 8).float() * 2.0 ** -24)
    e, u = rng.philox_uniforms(77, 2, 3, 64, CPU, entry=0)
    assert torch.equal(e, emit0) and torch.equal(u, u0)
    draws = [rng.philox_uniforms(77, 2, 3, 64, CPU, entry=i)
             for i in range(4)]
    for i in range(4):
        for j in range(i):
            assert not torch.equal(draws[i][0], draws[j][0])
            assert not torch.equal(draws[i][1], draws[j][1])
