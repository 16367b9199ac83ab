"""PyTorch port: frame offsets on the large-scene path (the cluster kernels
K7/K8 of ``ops/cuda/accel_kernel.py``) and frame-sharded traces of scenes
past the bounce kernel's 5,280 walls, on the CPU.

* The plain twins of K7/K8 (``trace_frames_ir_accel_sorted_plain``, the
  unsorted ``trace_frames_ir_accel_plain``) at ``frame_offset=f`` trace
  the Philox numbers of frames ``f ..``: the rows ``f ..`` of the whole
  stream's ``rng.philox_uniforms`` handed in as uniforms, bit for bit (the
  same code on the same numbers), at one band and at eight; the CPU
  wrappers run the same twin. Offsets that leave the 32-bit frame word,
  and a frame offset beside host uniforms, raise.
* ``engine.trace_ir(backend="accel", frame_offset=f)`` routes to that
  twin (it raised before the cluster kernels took an offset); frames
  ``0 .. 3`` equal frames ``0 .. 1`` plus frames ``2 .. 3`` within the
  order of a float sum (rtol 1e-6, atol 1e-9).
* ``parallel/frames.py::accumulate_frames_sharded`` on a 5,304-wall city
  (``city_scene(1324)``) over 4 shards of a virtual CPU mesh against the
  JAX package's on its 8 virtual CPU devices (``backend="jnp"``), both on
  JAX's draws (``jax_frame_uniforms``): total energy within 1e-4 and
  per-bin L1 within 1% (``test_torch_parallel.py``'s limits: an ulp of
  sin/cos can move a hit that sits on a bin edge to the next bin), and
  the port's unsharded trace within the order of the sum.

Sizes: 256 rays x 4 bounces, 8 kHz, 512 bins on a 168-wall city; the
5,304-wall city at 256 rays x 4 bounces x 8 frames, 2,048 bins, with two
listeners near the source (the city's own listener, 112 m away, hears
nothing in 256 ms)."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import CPU, jax_frame_uniforms, to_numpy

from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.ops import ir as jax_ir
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams as JParams
from realisticaudioraytracing2d_tpu.parallel import frames as jax_frames
from realisticaudioraytracing2d_tpu.parallel import mesh as jax_mesh
from realisticaudioraytracing2d_tpu_torch import engine
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import ir as irm
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.ops.cuda import accel_kernel as ak
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams
from realisticaudioraytracing2d_tpu_torch.parallel import frames, mesh

SR = 8000
KW = dict(n_rays=256, max_bounces=4, sample_rate=SR, ir_length=512)
TWINS = {"sorted": ak.trace_frames_ir_accel_sorted_plain,
         "unsorted": ak.trace_frames_ir_accel_plain}


def _city(n_bands=1):
    room = rooms.city_scene(40, 1, 60.0, n_bands=n_bands, device=CPU)
    return room.scene, TraceParams.make(room.source, room.listener,
                                        room.listener_radius, 343.0, 10.0,
                                        device=CPU)


@pytest.mark.parametrize("twin", sorted(TWINS))
@pytest.mark.parametrize("n_bands", [1, 8])
def test_plain_twins_at_a_frame_offset_trace_the_later_frames(twin,
                                                              n_bands):
    scene, params = _city(n_bands)
    fn = TWINS[twin]
    emit, u = rng.philox_uniforms(9, 5, KW["max_bounces"], KW["n_rays"],
                                  CPU, entry=2)
    late = fn(scene, params, 9, 2, entry=2, frame_offset=3, **KW)
    want = fn(scene, params, 0, 2, uniforms=(emit[3:], u[3:]), **KW)
    assert tuple(late.shape) == (1, KW["ir_length"], n_bands)
    assert float(want.sum()) > 0 and torch.equal(late, want)
    # offset 0 is the call without one; another offset other frames
    assert torch.equal(fn(scene, params, 9, 2, entry=2, frame_offset=0,
                          **KW), fn(scene, params, 9, 2, entry=2, **KW))
    assert not torch.equal(late, fn(scene, params, 9, 2, entry=2, **KW))
    if twin == "sorted":   # the CPU wrappers of K8 and K7 run this twin
        for wrapper in (ak.trace_frames_ir_accel_sorted,
                        ak.trace_frames_ir_accel):
            assert torch.equal(wrapper(scene, params, 9, 2, entry=2,
                                       frame_offset=3, **KW), late)


def test_frame_offsets_outside_the_frame_word_raise():
    scene, params = _city()
    uni = rng.philox_uniforms(0, 1, KW["max_bounces"], KW["n_rays"], CPU)
    for fn in (ak.trace_frames_ir_accel_sorted, ak.trace_frames_ir_accel,
               *TWINS.values()):
        with pytest.raises(ValueError, match="frame word"):
            fn(scene, params, 0, 1, frame_offset=-1, **KW)
        with pytest.raises(ValueError, match="frame word"):
            fn(scene, params, 0, 2, frame_offset=(1 << 32) - 1, **KW)
    for fn in TWINS.values():
        with pytest.raises(ValueError, match="uniforms"):
            fn(scene, params, 0, 1, uniforms=uni, frame_offset=1, **KW)
    # the last frame word itself is a frame (no draw past it is made)
    ak.check_frame_offset((1 << 32) - 1, 1)


@pytest.mark.parametrize("n_bands", [1, 8])
def test_trace_ir_routes_a_frame_offset_to_the_cluster_twin(n_bands):
    scene, params = _city(n_bands)
    kw = dict(KW, n_frames=2, seed=4, backend="accel")
    got = engine.trace_ir(scene, params, frame_offset=3, **kw)
    want = ak.trace_frames_ir_accel_sorted_plain(scene, params, 4, 2,
                                                 frame_offset=3, **KW)
    assert float(want.sum()) > 0 and torch.equal(got, want)
    # frames 0 .. 3 are frames 0 .. 1 and 2 .. 3 (sorted in other groups,
    # so summed in another order)
    halves = sum(engine.trace_ir(scene, params, frame_offset=f, **kw)
                 for f in (0, 2))
    whole = engine.trace_ir(scene, params, **dict(kw, n_frames=4))
    np.testing.assert_allclose(to_numpy(halves), to_numpy(whole),
                               rtol=1e-6, atol=1e-9)
    # host uniforms are the frames themselves: the offset names nothing
    uni = rng.philox_uniforms(4, 2, KW["max_bounces"], KW["n_rays"], CPU,
                              first_frame=3)
    assert torch.equal(engine.trace_ir(scene, params, frame_offset=3,
                                       uniforms=uni, **kw), got)


def test_frames_sharded_on_a_city_past_the_wall_limit_matches_jax():
    ref = jax_rooms.city_scene(1324)
    port = rooms.city_scene(1324, device=CPU)
    assert port.scene.n_walls == 5304 > bk.MAX_WALLS
    ears = np.array([[6.0, 2.0], [10.0, 5.0]], np.float32)
    jp = JParams.make(ref.source, ears, 2.0, 343.0, 10.0)
    params = TraceParams.make(port.source, ears, 2.0, 343.0, 10.0,
                              device=CPU)
    key = jax.random.PRNGKey(13)
    kw = dict(n_rays=256, max_bounces=4, sample_rate=SR, n_frames=8)
    t = 2048
    want = jax_frames.accumulate_frames_sharded(
        ref.scene, jp, jax_ir.IRState.zeros(t, 2, 1), key,
        jax_mesh.make_mesh((8,), ("rooms",)), backend="jnp", **kw)
    uni = jax_frame_uniforms(key, 8, 4, 256)
    m4 = mesh.make_mesh((4,), ("rooms",), devices=[CPU] * 4)
    st0 = irm.IRState.zeros(t, 2, device=CPU)
    got = frames.accumulate_frames_sharded(port.scene, params, st0, 0, m4,
                                           uniforms=uni, **kw)
    assert got.frames == 8 and int(want.frames) == 8
    g, w = to_numpy(got.sum), np.asarray(want.sum)
    assert g.shape == w.shape == (2, t, 1)
    for ear in range(2):
        assert np.isfinite(g[ear]).all() and w[ear].sum() > 0
        assert abs(g[ear].sum() - w[ear].sum()) / w[ear].sum() < 1e-4
        assert np.abs(g[ear] - w[ear]).sum() / np.abs(w[ear]).sum() < 1e-2
    un = engine.trace_ir(port.scene, params, ir_length=t, uniforms=uni,
                         **kw)
    np.testing.assert_allclose(g, to_numpy(un), rtol=1e-6, atol=1e-9)
