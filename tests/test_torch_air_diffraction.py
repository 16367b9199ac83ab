"""PyTorch port: air absorption (``ops/air.py``) and edge diffraction
(``ops/diffraction.py``), and both in the stream step, against the JAX
package on the CPU.

Tolerances:

* ``iso9613_alpha`` and ``band_frequencies`` run the same numpy code: the
  same bits;
* the air curve at 44,100 and 48,000 Hz: eagerly (the JAX CLI's call,
  true division) and jitted (the JAX stream step: XLA multiplies by the
  float32 reciprocals of the sample rate and 10, and reassociates t * c),
  each within 1 ulp (torch's and XLA's float32 ``pow``; a few ulps are a
  relative 2.4e-7, so rtol 5e-7);
* ``edge_table``: the same bits (the same IEEE operations);
  ``diffraction_ir`` orders 1 and 2, with and without patterns, within
  rtol 1e-5 (each path's energy is a short float32 expression; the
  directive weights use torch's and XLA's atan2/cos, an ulp apart) and
  the same hot bins;
* ``stream_chunk`` with diffraction and air on JAX's chunk uniforms, and
  ``Streamer.stream_clip`` with them: the stream tolerances of
  ``test_torch_streaming.py`` (rtol 2e-3, atol 2e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CPU, jax_chunk_uniforms, to_numpy, to_torch

import realisticaudioraytracing2d_tpu as jart
from realisticaudioraytracing2d_tpu.models.materials import AudioMaterial
from realisticaudioraytracing2d_tpu.models.scene import (SceneBuilder,
                                                         Transform2D)
from realisticaudioraytracing2d_tpu.ops import air as jax_air
from realisticaudioraytracing2d_tpu.ops import diffraction as jax_dfr
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams as JParams
from realisticaudioraytracing2d_tpu.streaming import init_stream as \
    jax_init_stream
from realisticaudioraytracing2d_tpu.streaming import stream_chunk as \
    jax_stream_chunk
from realisticaudioraytracing2d_tpu.utils import viz as jax_viz
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch.ops import air
from realisticaudioraytracing2d_tpu_torch.ops import diffraction as dfr
from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
from realisticaudioraytracing2d_tpu_torch.streaming import (init_stream,
                                                            stream_chunk)
from realisticaudioraytracing2d_tpu_torch.utils import viz

OPAQUE = AudioMaterial(absorption=0.9, scattering=0.5, transmission=0.0,
                       ior=1.0)
SR, C = 8000, 343.0
STREAM_TOL = dict(rtol=2e-3, atol=2e-5)


def _barrier(n_bands=1, split=False, doubled=False):
    b = SceneBuilder(n_bands=n_bands)
    if doubled:     # a two-point closed loop: two coincident walls
        b.add_polygon([np.array([[0.0, -4.0], [0.0, 4.0]])], OPAQUE,
                      Transform2D())
    elif split:
        b.add_segment((0.0, -4.0), (0.0, 0.0), (1.0, 0.0), OPAQUE)
        b.add_segment((0.0, 0.0), (0.0, 4.0), (1.0, 0.0), OPAQUE)
    else:
        b.add_segment((0.0, -4.0), (0.0, 4.0), (1.0, 0.0), OPAQUE)
    return b.build()


def _thick_box():
    b = SceneBuilder(n_bands=1)
    b.add_box(OPAQUE, Transform2D(position=(0.0, -1.0)), size=(1.0, 6.0))
    return b.build()


def _smoll_barrier():
    """SmollRoom with an opaque 3 m barrier below its source: the slant
    wall's ends lie outside the room, so it casts no shadow that an edge
    could fill, while (-16, 3) lies in the barrier's."""
    b = jart.rooms.smoll_room().builder
    b.add_segment((-18.0, 6.0), (-15.0, 6.0), (0.0, 1.0), OPAQUE)
    return b.build()


SCENES = {"barrier": _barrier, "split": lambda: _barrier(split=True),
          "doubled": lambda: _barrier(doubled=True),
          "bands": lambda: _barrier(n_bands=4), "thick box": _thick_box,
          "smoll": lambda: jart.rooms.smoll_room().scene,
          "smoll barrier": _smoll_barrier}


def _params(src=(-3.0, 0.0), lis=((3.0, 0.0), (-3.0, 6.0)), d=None, m=None):
    return JParams.make(np.asarray(src, np.float32),
                        np.asarray(lis, np.float32), listener_radius=0.5,
                        speed_of_sound=C, directivity=d, mic_directivity=m)


def test_alpha_and_band_frequencies_equal_jax():
    for n in (1, 3, 8):
        np.testing.assert_array_equal(air.band_frequencies(n),
                                      jax_air.band_frequencies(n))
    f = air.band_frequencies(8)
    for t, h in ((20.0, 50.0), (5.0, 80.0), (35.0, 20.0)):
        np.testing.assert_array_equal(air.iso9613_alpha(f, t, h),
                                      jax_air.iso9613_alpha(f, t, h))


@pytest.mark.parametrize("sample_rate", [44100, 48000])
@pytest.mark.parametrize("jitted", [False, True])
def test_air_curve_matches_jax_eager_and_jitted(sample_rate, jitted):
    t_len = 72000
    alpha = jax_air.iso9613_alpha(jax_air.band_frequencies(3))
    if jitted:
        want = jax.jit(lambda a, c: jax_air.air_attenuation_curve(
            t_len, sample_rate, a, c))(jnp.asarray(alpha, jnp.float32),
                                       jnp.float32(C))
    else:
        want = jax_air.air_attenuation_curve(t_len, sample_rate, alpha, C)
    want = np.asarray(want)
    got = to_numpy(air.air_attenuation_curve(t_len, sample_rate, alpha, C,
                                             reciprocal=jitted))
    assert got.shape == want.shape == (t_len, 3)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


def test_apply_air_absorption_matches_jax_and_checks_bands():
    rng = np.random.default_rng(0)
    ir = rng.random((2, 64, 3)).astype(np.float32)
    a = jax_air.iso9613_alpha(jax_air.band_frequencies(3))
    want = np.asarray(jax_air.apply_air_absorption(jnp.asarray(ir), 8000, a))
    got = to_numpy(air.apply_air_absorption(to_torch(ir), 8000, a))
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)
    # linear in the IR: the accumulated sum and the normalized IR alike
    np.testing.assert_allclose(
        to_numpy(air.apply_air_absorption(to_torch(ir * 8), 8000, a)) / 8,
        got, rtol=1e-6)
    with pytest.raises(ValueError, match="bands"):
        air.apply_air_absorption(torch.ones(1, 8, 3), 8000, [0.1, 0.2])


@pytest.mark.parametrize("name", ["split", "doubled", "smoll"])
def test_edge_table_equals_jax(name):
    scene = SCENES[name]()
    pts, w = dfr.edge_table(convert.scene_from_arrays(scene, device=CPU))
    pts_j, w_j = jax_dfr.edge_table(scene)
    np.testing.assert_array_equal(to_numpy(pts), np.asarray(pts_j))
    np.testing.assert_array_equal(to_numpy(w), np.asarray(w_j))


DIFFRACTION_CASES = {
    # scene, order, source, listeners, source pattern, mic pattern
    "barrier": ("barrier", 1, (-3.0, 0.0), ((3.0, 0.0), (-3.0, 6.0)),
                None, None),
    "split": ("split", 2, (-3.0, 0.0), ((3.0, 0.0),), None, None),
    "doubled": ("doubled", 1, (-3.0, 0.0), ((3.0, 0.0),), None, None),
    "bands": ("bands", 2, (-3.0, 0.5), ((3.0, -0.5),), None, None),
    "thick box, patterns": ("thick box", 2, (-3.0, 0.0),
                            ((3.0, 0.0), (2.5, 1.0)), dv.cardioid(0.5),
                            np.stack([dv.figure_eight(0.2),
                                      np.pad(dv.cardioid(2.5), (0, 2))])),
    "smoll barrier, patterns": ("smoll barrier", 2, (-18.0, 9.0),
                                ((-16.0, 3.0), (0.0, -3.68)),
                                dv.figure_eight(-0.4), dv.cardioid(3.0)),
}


@pytest.mark.parametrize("case", list(DIFFRACTION_CASES))
def test_diffraction_ir_matches_jax(case):
    name, order, src, lis, d, m = DIFFRACTION_CASES[case]
    scene = SCENES[name]()
    p = _params(src, lis, d, m)
    want = np.asarray(jax_dfr.diffraction_ir(
        scene, p, sample_rate=SR, ir_length=SR // 2, order=order))
    got = to_numpy(dfr.diffraction_ir(
        convert.scene_from_arrays(scene, device=CPU),
        convert.params_from_arrays(p, device=CPU), sample_rate=SR,
        ir_length=SR // 2, order=order))
    assert got.shape == want.shape
    assert want.sum() > 0
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kernels", [False, True])
def test_batched_visibility_sweeps_equal_the_separate_ones(kernels):
    """``_segments_clear`` (one K2 launch on the card for all of a call's
    segments) gives each family what ``_segment_clear`` gives it alone,
    with the plain all-walls test and with K2's plain version and its
    limit; ``diffraction_ir`` through either is the same, orders 1 and
    2."""
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        trace_kernel as tk
    scene = convert.scene_from_arrays(_smoll_barrier(), device=CPU)
    p = convert.params_from_arrays(_params(
        jart.rooms.smoll_room().source, ((-16.0, 3.0), (0.0, -3.68))),
        device=CPU)
    walls = tk.sweep_walls(scene) if kernels else None
    pts, _ = dfr.edge_table(scene)
    src, lis = p.source, p.listeners
    families = ((src, pts), (pts[:, None], pts[None]), (src, lis),
                (pts[None], lis[:, None]))
    got = dfr._segments_clear(families, scene, walls)
    for (a, b), mask in zip(families, got):
        want = dfr._segment_clear(*torch.broadcast_tensors(a, b), scene,
                                  walls)
        assert mask.shape == want.shape and torch.equal(mask, want)
    assert 0 < int(got[1].sum()) < got[1].numel()
    for order in (1, 2):
        on = dfr.diffraction_ir(scene, p, sample_rate=SR, ir_length=SR // 2,
                                order=order, use_kernels=True)
        off = dfr.diffraction_ir(scene, p, sample_rate=SR,
                                 ir_length=SR // 2, order=order,
                                 use_kernels=False)
        assert float(on[0].sum()) > 0 and torch.equal(on, off)


def test_diffraction_fills_only_the_shadow_and_checks_order():
    scene = convert.scene_from_arrays(_barrier(), device=CPU)
    p = convert.params_from_arrays(_params(), device=CPU)
    ir = dfr.diffraction_ir(scene, p, sample_rate=SR, ir_length=SR // 2)
    assert float(ir[0].sum()) > 0 and float(ir[1].sum()) == 0.0
    with pytest.raises(ValueError, match="order"):
        dfr.diffraction_ir(scene, p, sample_rate=SR, ir_length=64, order=3)


def test_diffraction_polylines_equal_jax():
    for scene, order in ((_barrier(), 1), (_thick_box(), 2)):
        p = _params(lis=((3.0, 0.0),))
        want = jax_viz.diffraction_polylines(scene, p, order=order)
        got = viz.diffraction_polylines(
            convert.scene_from_arrays(scene, device=CPU),
            convert.params_from_arrays(p, device=CPU), order=order)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


def test_stream_chunk_with_diffraction_and_air_matches_jax():
    scene = _barrier()
    p = _params(lis=((3.0, 0.0),), d=dv.cardioid(0.3))
    key = jax.random.PRNGKey(0)
    kw = dict(n_rays=64, max_bounces=2, sample_rate=SR)
    alpha = np.asarray([5.0], np.float32)
    dry = np.random.default_rng(1).standard_normal(256).astype(np.float32)
    st_j = jax_init_stream(1024, 256)
    st_t = init_stream(1024, 256, device=CPU)
    ts, tp = (convert.scene_from_arrays(scene, device=CPU),
              convert.params_from_arrays(p, device=CPU))
    for chunk in range(2):
        want, st_j = jax_stream_chunk(scene, p, st_j, jnp.asarray(dry), key,
                                      diffraction=True,
                                      air_alpha=jnp.asarray(alpha), **kw)
        got, st_t = stream_chunk(
            ts, tp, st_t, to_torch(dry), seed=0, diffraction=True,
            air_alpha=torch.as_tensor(alpha),
            uniforms=jax_chunk_uniforms(key, chunk, 1, 2, 64), **kw)
        want = np.asarray(want)
        assert np.abs(want).sum() > 0
        np.testing.assert_allclose(to_numpy(got), want, **STREAM_TOL)
        np.testing.assert_allclose(to_numpy(st_t.prev_ir),
                                   np.asarray(st_j.prev_ir), rtol=1e-5,
                                   atol=1e-9)
    # the hard shadow is silent without diffraction; air makes it quieter
    plain, _ = stream_chunk(ts, tp, init_stream(1024, 256, device=CPU),
                            to_torch(dry), seed=0, **kw)
    diffr, _ = stream_chunk(ts, tp, init_stream(1024, 256, device=CPU),
                            to_torch(dry), seed=0, diffraction=1, **kw)
    aired, _ = stream_chunk(ts, tp, init_stream(1024, 256, device=CPU),
                            to_torch(dry), seed=0, diffraction=1,
                            air_alpha=alpha, **kw)
    e = [float(x.abs().sum()) for x in (plain, diffr, aired)]
    assert e[0] == 0.0 and 0.0 < e[2] < e[1]


def test_streamer_with_patterns_diffraction_and_air_matches_jax():
    room = jart.rooms.smoll_room()
    cfg = art.smoll_room_config(ray_count=256)
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, reverb_duration=0.2, chunk_duration=0.05))
    lis = np.stack([room.listener, [5.0, -3.68]]).astype(np.float32)
    mic = np.stack([dv.cardioid(0.8), dv.cardioid(-0.8)])
    src_pat = dv.cardioid(0.4)
    alpha = air.iso9613_alpha(air.band_frequencies(1))
    dry = np.zeros(int(0.1 * 48000), np.float32)
    dry[[100, 2600]] = 1.0
    key = jax.random.PRNGKey(5)
    jp = jart.Engine(room.scene, cfg).params(room.source, lis, src_pat, mic)
    want = np.asarray(jart.Streamer(
        room.scene, cfg, key, n_listeners=2, diffraction=1,
        air_alpha=jnp.asarray(alpha, jnp.float32)).stream_clip(
            jnp.asarray(dry), lambda i: jp))
    scene = convert.scene_from_arrays(room.scene, device=CPU)
    p = art.Engine(scene, cfg).params(room.source, lis, src_pat, mic)
    got = to_numpy(art.Streamer(
        scene, cfg, n_listeners=2, diffraction=1,
        air_alpha=torch.as_tensor(alpha, dtype=torch.float32),
        uniforms_fn=lambda i: jax_chunk_uniforms(
            key, i, 1, cfg.sim.max_bounces, cfg.sim.ray_count)
    ).stream_clip(to_torch(dry), lambda i: p))
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **STREAM_TOL)
