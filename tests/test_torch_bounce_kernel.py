"""PyTorch port: the whole-frame bounce kernel's wrappers and plain version.

On the CPU the wrappers run the plain version (oracle trace + scatter,
summed over frames), which is held against JAX here;
tests/test_torch_cuda.py holds the CUDA kernel against that plain version
on the card.

Tolerances:
* plain vs JAX ``trace_accumulate(backend="jnp")``, same per-frame
  uniforms: total energy to 1e-4 and per-bin L1 to 1%: an ulp of sin/cos
  can move a hit that sits on a bin edge to the next bin;
* plain vs JAX ``trace_frame_ir_whole`` in interpret mode: energy 1% and
  L1 2%, and no further from it than JAX's own jnp oracle: the TPU kernel
  bins through bf16 one-hots (~0.4% per hit, ``bounce_kernel.py:1563-1565``)
  and its approximate reciprocal flips razor-edge hits.
SmollRoom's source sits behind a transmissive wall, so no hit lands before
bounce 2 and the first arrival is ~63 ms: the sizes use >= 4 bounces and
2048 bins at 8 kHz."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import jax_frame_uniforms, to_numpy, to_torch

from realisticaudioraytracing2d_tpu.engine import \
    trace_accumulate as jax_trace_accumulate
from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.ops import ir as jax_ir
from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
from realisticaudioraytracing2d_tpu.ops import trace as jax_trace
from realisticaudioraytracing2d_tpu.ops.ir import IRState as JaxIRState
from realisticaudioraytracing2d_tpu.ops.pallas import bounce_kernel as jax_bk
from realisticaudioraytracing2d_tpu.ops.trace import \
    TraceParams as JaxTraceParams
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams

SR, T = 8000, 2048


@pytest.fixture(scope="module")
def jax_setup():
    room = jax_rooms.smoll_room()
    p = JaxTraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    return (room, p, convert.scene_from_arrays(room.scene, device="cpu"),
            convert.params_from_arrays(p, device="cpu"))


def _l1(got, want):
    return np.abs(got - want).sum() / np.abs(want).sum()


def test_plain_matches_jax_trace_accumulate(jax_setup):
    room, p, scene, params = jax_setup
    key = jax.random.PRNGKey(5)
    n_rays, n_bounces, n_frames = 1024, 5, 2
    want = np.asarray(jax_trace_accumulate(
        room.scene, p, JaxIRState.zeros(T, 1, 1), key, n_rays=n_rays,
        max_bounces=n_bounces, sample_rate=SR, n_frames=n_frames,
        backend="jnp").sum)
    emit, u = jax_frame_uniforms(key, n_frames, n_bounces, n_rays)
    got = to_numpy(bk.trace_frames_ir_plain(scene, params, emit, u,
                                            sample_rate=SR, ir_length=T))
    assert got.shape == (1, T, 1) and (want != 0).sum() > 300
    assert abs(got.sum() - want.sum()) / want.sum() < 1e-4
    assert _l1(got, want) < 1e-2
    assert ((got != 0) == (want != 0)).mean() > 0.999


def test_plain_matches_jax_whole_frame_kernel_interpret(jax_setup):
    room, p, scene, params = jax_setup
    key = jax.random.PRNGKey(9)
    n_rays, n_bounces = 1024, 4
    want = np.asarray(jax_bk.trace_frame_ir_whole(
        room.scene, p, key, n_rays=n_rays, max_bounces=n_bounces,
        sample_rate=SR, ir_length=T, tile_r=256))
    emit, u = jax_rng.bounce_uniforms(key, n_bounces, n_rays)
    got = to_numpy(bk.trace_frames_ir_whole(
        scene, params, to_torch(emit)[None], to_torch(u)[None],
        sample_rate=SR, ir_length=T))
    oracle = np.asarray(jax_ir.scatter_hits(jax_trace.trace_hits_only(
        room.scene, p, key, n_rays=n_rays, max_bounces=n_bounces), SR, T))
    assert (want != 0).sum() > 100
    assert abs(got.sum() - want.sum()) / want.sum() < 1e-2
    assert _l1(got, want) < 2e-2
    # the port is as close to the TPU kernel as JAX's own oracle is
    assert _l1(got, want) <= _l1(oracle, want) + 1e-3


def test_cpu_wrappers_run_plain_without_counting(jax_setup):
    _, _, scene, params = jax_setup
    before = (bk.trace_frames_ir_whole.launches,
              bk.trace_frames_ir_mega.launches)
    emit, u = rng.philox_uniforms(11, 2, 4, 256, device="cpu")
    plain = bk.trace_frames_ir_plain(scene, params, emit, u, sample_rate=SR,
                                     ir_length=T)
    whole = bk.trace_frames_ir_whole(scene, params, emit, u, sample_rate=SR,
                                     ir_length=T)
    mega = bk.trace_frames_ir_mega(scene, params, 11, 2, n_rays=256,
                                   max_bounces=4, sample_rate=SR,
                                   ir_length=T)
    assert torch.equal(whole, plain) and torch.equal(mega, plain)
    assert float(plain.sum()) > 0
    assert (bk.trace_frames_ir_whole.launches,
            bk.trace_frames_ir_mega.launches) == before


def test_kernel_support_checks():
    room = rooms.smoll_room(device="cpu")
    p = TraceParams.make(room.source, room.listener, device="cpu")
    bk.check_kernel_supported(room.scene, p)
    # any band count: registers up to 32 bands, a device scratch past that
    for k in (4, 8, 32, 512):
        bk.check_kernel_supported(
            rooms.smoll_room(n_bands=k, device="cpu").scene, p)
    bk.check_kernel_supported(room.scene, p._replace(
        directivity=torch.ones(3), mic_directivity=torch.ones(1, 5)))
    with pytest.raises(ValueError, match="directivity"):
        bk.check_kernel_supported(room.scene,
                                  p._replace(directivity=torch.ones(4)))
    # the patterns share a block's shared memory with the wall table
    with pytest.raises(NotImplementedError, match="shared memory"):
        bk.check_kernel_supported(room.scene.pad_to(bk.MAX_WALLS), p._replace(
            directivity=torch.ones(201)))
    # any listener count: blocks of what a block's shared memory holds
    for n_l in (17, 64, 1000):
        many = TraceParams.make(room.source, np.zeros((n_l, 2), np.float32),
                                device="cpu")
        bk.check_kernel_supported(room.scene, many)
        bk.check_kernel_supported(room.scene.pad_to(bk.MAX_WALLS), many)
    assert bk.listener_block(bk.MAX_WALLS) == 16
    assert bk.listener_block(28) > 1000
    assert bk.listener_block(bk.MAX_WALLS, 5, 5) == (32 - 5) // (2 + 5)
    with pytest.raises(ValueError, match="K7/K8"):
        bk.check_kernel_supported(room.scene.pad_to(bk.MAX_WALLS + 1), p)
    assert bk.MAX_WALLS == 5280


def test_pack_walls_layout():
    scene = rooms.smoll_room(device="cpu").scene
    w = bk.pack_walls(scene)
    assert tuple(w.shape) == (11, scene.n_walls) and w.is_contiguous()
    v2 = scene.b - scene.a
    assert torch.equal(w[2], v2[:, 0]) and torch.equal(w[3], v2[:, 1])
    assert torch.equal(w[4], v2[:, 0] * scene.a[:, 1]
                       - v2[:, 1] * scene.a[:, 0])
    assert torch.equal(w[10], scene.ior) and torch.equal(w[7],
                                                         scene.absorption[:, 0])


@pytest.mark.parametrize("n_frames,n_rays,n_bounces,gain,log2_s", [
    (1, 15000, 5, 1.0, 44),        # the shipped SmollRoom frame
    (50, 131072, 8, 1.0, 35),      # the bench frame, 50 frames
    (4, 15000, 5, 100.0, 36),      # Big Room's input gain
])
def test_fixed_point_scale_cannot_overflow(n_frames, n_rays, n_bounces,
                                           gain, log2_s):
    room = rooms.smoll_room(device="cpu")
    p = TraceParams.make(room.source, room.listener, input_gain=gain,
                         device="cpu")
    s = bk.fixed_point_scale(p, n_frames, n_rays, n_bounces)
    assert s.dtype == torch.float64 and float(torch.log2(s)) == log2_s
    worst = n_frames * n_rays * 2 * n_bounces * gain * float(s)
    assert 2 ** 61 <= worst < 2 ** 62
    # a listener next to the source: NEE energy may exceed the gain
    near = p._replace(listeners=p.source[None] + 0.1)
    assert float(bk.fixed_point_scale(near, n_frames, n_rays, n_bounces)) \
        < float(s)
