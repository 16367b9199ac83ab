"""PyTorch port: the device-mesh paths (``parallel/mesh, rays, frames, seq``,
``sweep_rooms_sharded``, ``trace_sources_mixdown_sharded``,
``localize_source(mesh=)``, ``cli sweep --sharded``), ``utils/profiling.py``
and the pytree checkpoint, against the JAX package on the CPU.

JAX shards over the suite's 8 virtual CPU devices (``tests/conftest.py``),
the port over a virtual mesh ``make_mesh(devices=[cpu] * 8)``, with the
same inputs made from numpy and JAX's own per-shard draws handed to the
port's plain path (``uniforms=``).

Tolerances:
* port plain vs JAX ``backend="jnp"`` on JAX's draws (the sweep, frames,
  rays, the mixdown): total energy within 1e-4 and per-bin L1 within 1%,
  the limits of test_torch_sweep.py (an ulp of sin/cos can move a hit
  that sits on a bin edge to the next bin);
* port sharded vs port unsharded on the same draws: the sweep bit for bit
  (each room is traced alone, in one place, by its global id); frames,
  rays and the mixdown within rtol 1e-6 / atol 1e-9, the order of a float
  sum over shards (bit for bit where the order is the unsharded one);
* ``convolve_seq_sharded`` against JAX's and against the port's
  ``convolve_fft``: rtol 1e-5, atol 1e-6 (JAX's own test: FFT roundoff of
  chunks against the whole);
* ``localize_source(mesh=)`` against ``mesh=None``: bit for bit on the
  CPU (each start's problem is computed alone, with the same operations);
* profiling and the checkpoint: the same JSON and the same bytes
  (``cli sweep --sharded``: tests/test_torch_cli.py).
Sizes: <= 16 rooms, sources, frames or starts; <= 1,024 rays; 8 kHz;
2,048 bins."""

import os
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (CPU, jax_frame_uniforms, jax_room_uniforms,
                          jax_shard_ray_uniforms,
                          jax_sharded_source_uniforms, to_numpy, to_torch)

from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.ops import directivity as jax_dv
from realisticaudioraytracing2d_tpu.ops import ir as jax_ir
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams as JParams
from realisticaudioraytracing2d_tpu.parallel import frames as jax_frames
from realisticaudioraytracing2d_tpu.parallel import mesh as jax_mesh
from realisticaudioraytracing2d_tpu.parallel import multisource as jax_ms
from realisticaudioraytracing2d_tpu.parallel import rays as jax_rays
from realisticaudioraytracing2d_tpu.parallel import seq as jax_seq
from realisticaudioraytracing2d_tpu.parallel import sweep as jax_sweep
from realisticaudioraytracing2d_tpu.utils import checkpoint as jax_ckpt
from realisticaudioraytracing2d_tpu.utils import profiling as jax_prof
from realisticaudioraytracing2d_tpu_torch import convert, diff
from realisticaudioraytracing2d_tpu_torch.engine import trace_accumulate
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import convolve as cv
from realisticaudioraytracing2d_tpu_torch.ops import ir as irm
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.parallel import (frames, mesh,
                                                           multisource, rays,
                                                           seq, sweep)
from realisticaudioraytracing2d_tpu_torch.utils import checkpoint as ckpt
from realisticaudioraytracing2d_tpu_torch.utils import profiling as prof

SR, T = 8000, 2048
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(shape, names=("rooms", "rays")):
    return mesh.make_mesh(shape, names, devices=[CPU] * int(np.prod(shape)))


def _assert_jax_close(got, want):
    g, w = to_numpy(got).ravel(), np.asarray(want).ravel()
    assert np.isfinite(g).all() and w.sum() > 0
    assert abs(g.sum() - w.sum()) / w.sum() < 1e-4
    assert np.abs(g - w).sum() / np.abs(w).sum() < 1e-2


def _smoll():
    ref = jax_rooms.smoll_room()
    port = rooms.smoll_room(device=CPU)
    return ref, port


# -- the mesh -----------------------------------------------------------------

def test_make_mesh_shapes_axes_and_errors(monkeypatch):
    m = _mesh((2, 4))
    assert dict(m.shape) == {"rooms": 2, "rays": 4}
    assert m.shape["rays"] == 4 and m.first == torch.device(CPU)
    assert len(m.axis_devices("rays")) == 4
    assert len(m.axis_devices("rooms")) == 2
    assert dict(mesh.make_mesh(devices=[CPU] * 3).shape) == {"rooms": 3,
                                                             "rays": 1}
    with pytest.raises(ValueError, match="mesh shape"):
        mesh.make_mesh((3,), ("rooms",), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="mesh shape"):   # JAX's check too
        jax_mesh.make_mesh((3,), ("rooms",))
    with pytest.raises(ValueError, match="no mesh axis"):
        m.axis_devices("frames")
    # the default is every CUDA device; a torch without one raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        mesh.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = mesh.make_mesh()
    assert dict(m.shape) == {"rooms": 2, "rays": 1}
    assert list(m.devices.flat) == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]


def test_placement_and_reductions():
    m = _mesh((1, 4))
    x = torch.arange(8.0).reshape(8, 1)
    parts = mesh.sharded_leading(m, "rays", x)
    assert [p.tolist() for p in parts] == [[[0.0], [1.0]], [[2.0], [3.0]],
                                           [[4.0], [5.0]], [[6.0], [7.0]]]
    assert torch.equal(mesh.gather(m, parts), x)
    assert torch.equal(mesh.reduce_sum(m, parts), torch.tensor([[12.0],
                                                                [16.0]]))
    assert len(mesh.replicated(m, x)) == 4 and \
        len(mesh.replicated(m, x, "rooms")) == 1
    _, port = _smoll()
    halves = mesh.sharded_leading(_mesh((2,), ("rooms",)), "rooms",
                                  port.scene.a)
    assert [tuple(h.shape) for h in halves] == [(port.scene.n_walls // 2,
                                                 2)] * 2
    with pytest.raises(ValueError, match="not divisible"):
        mesh.sharded_leading(m, "rays", torch.zeros(6))


# -- the sweep ----------------------------------------------------------------

def test_sweep_sharded_plain_matches_jax_and_unsharded():
    key = jax.random.PRNGKey(2)
    n_rooms, n_rays, n_bounces, n_frames = 8, 128, 3, 2
    ref, src, lis = jax_rooms.random_rooms(n_rooms, seed=4, n_obstacles=1)
    kw = dict(n_rays=n_rays, max_bounces=n_bounces, sample_rate=SR,
              ir_length=T, n_frames=n_frames)
    want = jax_sweep.sweep_rooms_sharded(
        ref, src, lis, key, jax_mesh.make_mesh((8,), ("rooms",)),
        backend="jnp", **kw)
    scenes = convert.scene_from_arrays(ref, device=CPU)
    uni = jax_room_uniforms(key, n_rooms, n_frames, n_bounces, n_rays)
    m = _mesh((8,), ("rooms",))
    got = sweep.sweep_rooms_sharded(scenes, src, lis, 0, m, backend="plain",
                                    uniforms=uni, **kw)
    assert tuple(got.shape) == (n_rooms, 1, T, 1)
    _assert_jax_close(got, want)
    # sharded == unsharded, bit for bit, on JAX's draws and on Philox's
    assert torch.equal(got, sweep.sweep_rooms(
        scenes, src, lis, 0, backend="plain", uniforms=uni, **kw))
    for shape in ((8,), (2,)):
        seeded = sweep.sweep_rooms_sharded(scenes, src, lis, 9,
                                           _mesh(shape, ("rooms",)), **kw)
        assert torch.equal(seeded, sweep.sweep_rooms(scenes, src, lis, 9,
                                                     **kw))
    with pytest.raises(ValueError, match="not divisible"):
        sweep.sweep_rooms_sharded(scenes.row(slice(0, 7)), src[:7], lis[:7],
                                  0, m, **kw)


# -- frames -------------------------------------------------------------------

def test_frames_sharded_matches_jax_and_unsharded():
    ref, port = _smoll()
    jp = JParams.make(ref.source, ref.listener, 0.5, 343.0, 1.0)
    params = convert.params_from_arrays(jp, device=CPU)
    key = jax.random.PRNGKey(11)
    kw = dict(n_rays=256, max_bounces=4, sample_rate=SR)
    want = jax_frames.accumulate_frames_sharded(
        ref.scene, jp, jax_ir.IRState.zeros(T, 1, 1), key,
        jax_mesh.make_mesh((8,), ("rooms",)), n_frames=8, backend="jnp",
        **kw)
    st0 = irm.IRState.zeros(T, device=CPU)
    uni = jax_frame_uniforms(key, 8, 4, 256)
    m4 = _mesh((4,), ("rooms",))
    got = frames.accumulate_frames_sharded(port.scene, params, st0, 0, m4,
                                           n_frames=8, backend="plain",
                                           uniforms=uni, **kw)
    assert got.frames == 8 and int(want.frames) == 8
    _assert_jax_close(got.sum, want.sum)
    un = trace_accumulate(port.scene, params, st0, n_frames=8, uniforms=uni,
                          backend="plain", **kw)
    np.testing.assert_allclose(to_numpy(got.sum), to_numpy(un.sum),
                               rtol=1e-6, atol=1e-9)
    # seeded: shard d draws frames 2d, 2d + 1 of the unsharded stream
    seeded = frames.accumulate_frames_sharded(port.scene, params, st0, 5, m4,
                                              n_frames=8, **kw)
    un = trace_accumulate(port.scene, params, st0, n_frames=8, seed=5, **kw)
    assert float(un.sum.sum()) > 0
    np.testing.assert_allclose(to_numpy(seeded.sum), to_numpy(un.sum),
                               rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="not divisible"):
        frames.accumulate_frames_sharded(port.scene, params, st0, 5, m4,
                                         n_frames=9, **kw)


def test_k4_frame_offset_draws_the_later_frames():
    """On the CPU, K4's wrapper at ``frame_offset`` runs the plain version
    on frames ``frame_offset ..`` of the seed (and ``entry``); those
    frames' uniforms are the later rows of the whole stream's."""
    ref, port = _smoll()
    params = convert.params_from_arrays(
        JParams.make(ref.source, ref.listener), device=CPU)
    kw = dict(n_rays=128, max_bounces=4, sample_rate=SR, ir_length=T)
    emit, u = rng.philox_uniforms(7, 5, 4, 128, CPU, entry=3)
    late = bk.trace_frames_ir_mega(port.scene, params, 7, 2, entry=3,
                                   frame_offset=3, **kw)
    want = bk.trace_frames_ir_plain(port.scene, params, emit[3:], u[3:],
                                    sample_rate=SR, ir_length=T)
    assert torch.equal(late, want) and float(want.sum()) > 0
    assert not torch.equal(late, bk.trace_frames_ir_mega(
        port.scene, params, 7, 2, entry=3, **kw))


# -- rays ---------------------------------------------------------------------

def test_rays_sharded_matches_jax_per_shard_draws():
    ref, port = _smoll()
    jp = JParams.make(ref.source, ref.listener, 0.5, 343.0, 1.0,
                      directivity=jax_dv.cardioid(1.0))
    params = convert.params_from_arrays(jp, device=CPU)
    key = jax.random.PRNGKey(5)
    kw = dict(n_rays=1024, max_bounces=4, sample_rate=SR, ir_length=T)
    want = jax_rays.trace_rays_sharded(ref.scene, jp, key,
                                       jax_mesh.make_mesh((1, 8)),
                                       backend="jnp", **kw)
    m = _mesh((1, 8))
    uni = jax_shard_ray_uniforms(key, 8, 4, 128)
    got = rays.trace_rays_sharded(port.scene, params, 0, m, uniforms=uni,
                                  **kw)
    assert tuple(got.shape) == (1, T, 1)
    _assert_jax_close(got, want)
    # seeded: shard d is K4's plain version at 128 rays, entry d
    seeded = rays.trace_rays_sharded(port.scene, params, 3, m, **kw)
    parts = [bk.trace_frames_ir_mega(port.scene, params, 3, 1, n_rays=128,
                                     max_bounces=4, sample_rate=SR,
                                     ir_length=T, entry=d) for d in range(8)]
    assert torch.equal(seeded, mesh.reduce_sum(m, parts))
    assert torch.equal(seeded, rays.trace_rays_sharded(port.scene, params, 3,
                                                       m, **kw))
    with pytest.raises(ValueError, match="not divisible"):
        rays.trace_rays_sharded(port.scene, params, 3, m, n_rays=1020,
                                max_bounces=4, sample_rate=SR, ir_length=T)


# -- the mixdown --------------------------------------------------------------

def test_mixdown_sharded_gains_and_aims_match_jax():
    ref, port = _smoll()
    n_src = 16
    sources = np.tile(np.asarray(ref.source), (n_src, 1)).astype(np.float32)
    sources[:, 0] += np.linspace(-2, 2, n_src, dtype=np.float32)
    gains = np.linspace(0.5, 4.0, n_src).astype(np.float32)
    aims = np.stack([jax_dv.cardioid(a) for a in
                     np.linspace(0, 2 * np.pi, n_src, endpoint=False)]
                    ).astype(np.float32)
    jp = JParams.make(sources, ref.listener, 0.5, 343.0, gains,
                      directivity=aims)
    params = convert.params_from_arrays(jp, device=CPU)
    key = jax.random.PRNGKey(21)
    kw = dict(n_rays=128, max_bounces=4, sample_rate=SR, ir_length=T)
    want = jax_ms.trace_sources_mixdown_sharded(
        ref.scene, jp, key, jax_mesh.make_mesh((1, 8)), backend="jnp", **kw)
    m = _mesh((1, 8))
    uni = jax_sharded_source_uniforms(key, 8, n_src, 4, 128)
    got = multisource.trace_sources_mixdown_sharded(
        port.scene, params, 0, m, backend="plain", uniforms=uni, **kw)
    _assert_jax_close(got, want)
    un = multisource.trace_sources_mixdown(port.scene, params, 0,
                                           backend="plain", uniforms=uni,
                                           **kw)
    np.testing.assert_allclose(to_numpy(got), to_numpy(un), rtol=1e-6,
                               atol=1e-9)
    # seeded: shard d's sources draw entries 2d, 2d + 1, as unsharded
    seeded = multisource.trace_sources_mixdown_sharded(port.scene, params, 4,
                                                       m, **kw)
    un = multisource.trace_sources_mixdown(port.scene, params, 4, **kw)
    assert float(un.sum()) > 0
    np.testing.assert_allclose(to_numpy(seeded), to_numpy(un), rtol=1e-6,
                               atol=1e-9)
    with pytest.raises(ValueError, match="not divisible"):
        multisource.trace_sources_mixdown_sharded(
            port.scene, params._replace(source=params.source[:12],
                                        input_gain=params.input_gain[:12],
                                        directivity=params.directivity[:12]),
            4, m, **kw)


def test_mixdown_sharded_one_row_pattern_broadcasts_as_jax():
    """A ``[1, C]`` pattern is every source's aim: JAX broadcasts it to
    ``[S, C]`` before it shards the sources, and so does the port."""
    ref, port = _smoll()
    n_src = 4
    sources = np.tile(np.asarray(ref.source), (n_src, 1)).astype(np.float32)
    sources[:, 0] += np.linspace(-2, 2, n_src, dtype=np.float32)
    aim = jax_dv.cardioid(0.7)[None].astype(np.float32)        # [1, C]
    jp = JParams.make(sources, ref.listener, 0.5, 343.0, 1.0,
                      directivity=aim)
    params = convert.params_from_arrays(jp, device=CPU)
    assert tuple(params.directivity.shape) == aim.shape
    key = jax.random.PRNGKey(5)
    kw = dict(n_rays=128, max_bounces=4, sample_rate=SR, ir_length=T)
    want = jax_ms.trace_sources_mixdown_sharded(
        ref.scene, jp, key,
        jax_mesh.make_mesh((1, 2), devices=jax.devices()[:2]),
        backend="jnp", **kw)
    uni = jax_sharded_source_uniforms(key, 2, n_src, 4, 128)
    got = multisource.trace_sources_mixdown_sharded(
        port.scene, params, 0, _mesh((1, 2)), backend="plain", uniforms=uni,
        **kw)
    _assert_jax_close(got, want)
    # the unsharded mixdown takes [1, C] as it did: the same IR as [C]
    un = multisource.trace_sources_mixdown(port.scene, params, 0,
                                           backend="plain", uniforms=uni,
                                           **kw)
    shared = multisource.trace_sources_mixdown(
        port.scene, params._replace(directivity=params.directivity[0]), 0,
        backend="plain", uniforms=uni, **kw)
    assert torch.equal(un, shared)
    np.testing.assert_allclose(to_numpy(got), to_numpy(un), rtol=1e-6,
                               atol=1e-9)


# -- time ---------------------------------------------------------------------

def test_convolve_seq_sharded_matches_jax_and_fft():
    g = np.random.default_rng(3)
    x = g.normal(size=4096).astype(np.float32)
    x[::17] = 0.0     # the |x| <= eps gate across chunk seams
    ir = (g.normal(size=777) * np.exp(-np.arange(777) / 150)
          ).astype(np.float32)
    want = np.asarray(jax_seq.convolve_seq_sharded(
        jnp.asarray(x), jnp.asarray(ir), jax_mesh.make_mesh((8,), ("rays",)),
        5))
    m = _mesh((8,), ("rays",))
    got = seq.convolve_seq_sharded(to_torch(x), to_torch(ir), m, 5)
    assert tuple(got.shape) == (4096 + 777,)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        to_numpy(got), to_numpy(cv.convolve_fft(to_torch(x), to_torch(ir),
                                                5)), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        seq.convolve_seq_sharded(to_torch(x[:4090]), to_torch(ir), m)
    with pytest.raises(ValueError, match="not divisible"):
        jax_seq.convolve_seq_sharded(jnp.asarray(x[:4090]), jnp.asarray(ir),
                                     jax_mesh.make_mesh((8,), ("rays",)))


# -- localization -------------------------------------------------------------

def test_localize_sharded_equals_unsharded_per_start():
    from realisticaudioraytracing2d_tpu_torch.models.materials import \
        AudioMaterial
    scene = rooms.shoebox_room(4.0, 4.0, wall_material=AudioMaterial(
        absorption=0.3, scattering=0.4), device=CPU)
    params = convert.params_from_arrays(
        JParams.make((-1.0, 0.4), (1.0, 0.3)), device=CPU)
    target = diff.simulate_ir(scene, params, 0, n_rays=64, max_bounces=4,
                              sample_rate=SR, ir_length=512, soft=True,
                              device=CPU)
    kw = dict(n_rays=64, max_bounces=4, sample_rate=SR, steps=6,
              n_starts=8, device=CPU)
    whole = diff.localize_source(scene, params, target, 3, **kw)
    for shape in ((8,), (2,)):
        sharded = diff.localize_source(scene, params, target, 3,
                                       mesh=_mesh(shape, ("rooms",)), **kw)
        assert torch.equal(sharded.positions, whole.positions)
        assert torch.equal(sharded.losses, whole.losses)
        assert torch.equal(sharded.position, whole.position)
    with pytest.raises(ValueError, match="7 starts not divisible"):
        diff.localize_source(scene, params, target, 3, mesh=_mesh(
            (2,), ("rooms",)), **{**kw, "n_starts": 7})


# -- profiling ----------------------------------------------------------------

def test_profiling_metrics_and_counts_equal_jax(tmp_path):
    assert prof.ray_bounce_intersections(15000, 5, 28) == \
        jax_prof.ray_bounce_intersections(15000, 5, 28)
    assert prof.ray_bounce_intersections(1024, 8, 7, nee=False) == \
        jax_prof.ray_bounce_intersections(1024, 8, 7, nee=False)
    ours, theirs = prof.Metrics(), jax_prof.Metrics()
    for name, v in (("ir_ms", 1.5), ("ir_ms", 2.25), ("xrt", 33.0)):
        ours.record(name, v)
        theirs.record(name, v)
    with prof.timed("step", ours) as t:
        pass
    theirs.record("step_s", ours.values["step_s"][0])
    ours.dump(str(tmp_path / "a.json"))
    theirs.dump(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    assert t.count == 1 and ours.summary()["ir_ms"] == 1.875
    timer = prof.Timer().start()
    assert timer.stop(sync=(torch.ones(2), {"d": torch.device(CPU)})) >= 0
    assert timer.count == 1 and timer.mean_s == timer.total_s
    with prof.device_trace(str(tmp_path / "trace")) as p:
        torch.ones(64).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert p.key_averages() is not None


# -- the pytree checkpoint ----------------------------------------------------

class Pair(NamedTuple):
    a: object
    b: object


def _trees():
    g = np.random.default_rng(4)
    x, y, z = (g.random(s).astype(np.float32) for s in ((2, 3), (4,), ()))
    port = {"irs": Pair(torch.from_numpy(x), None),
            "rest": (torch.from_numpy(y), [torch.from_numpy(z), 3])}
    ref = {"irs": Pair(jnp.asarray(x), None),
           "rest": (jnp.asarray(y), [jnp.asarray(z), 3])}
    return port, ref, (x, y, z)


def test_pytree_checkpoint_round_trip_and_jax_files(tmp_path):
    port, ref, (x, y, z) = _trees()
    ours = str(tmp_path / "ours")
    ckpt.save_pytree(ours, port, meta={"n": 1}, kind="Dataset")
    back = ckpt.load_pytree(ours, port, kind="Dataset", device=CPU)
    assert isinstance(back["irs"], Pair) and back["irs"].b is None
    assert torch.equal(back["irs"].a, port["irs"].a)
    assert torch.equal(back["rest"][1][0], port["rest"][1][0])
    assert back["rest"][1][1] == 3 and isinstance(back["rest"][1][1], int)
    # the JAX package loads the port's file: the same structure string
    theirs_back = jax_ckpt.load_pytree(ours, ref, kind="Dataset")
    np.testing.assert_array_equal(np.asarray(theirs_back["irs"].a), x)
    # and the port loads the JAX package's
    theirs = str(tmp_path / "theirs")
    jax_ckpt.save_pytree(theirs, ref, meta={"n": 1}, kind="Dataset")
    loaded = ckpt.load_pytree(theirs, port, kind="Dataset", device=CPU)
    np.testing.assert_array_equal(to_numpy(loaded["rest"][0]), y)
    np.testing.assert_array_equal(to_numpy(loaded["rest"][1][0]), z)
    assert loaded["rest"][1][1] == 3
    side_ours, side_theirs = ckpt.read_sidecar(ours), \
        jax_ckpt.read_sidecar(theirs)
    for k in ("format", "kind", "treedef", "n_leaves", "leaf_paths",
              "shapes", "meta"):
        assert side_ours[k] == side_theirs[k], k
    # an IRState written as a pytree loads in the JAX package as one
    state = irm.IRState(sum=torch.ones(1, 8, 1), frames=2)
    ckpt.save_pytree(str(tmp_path / "ir"), state)
    assert ckpt.read_sidecar(str(tmp_path / "ir"))["treedef"] == \
        ckpt.IRSTATE_TREEDEF
    assert int(jax_ckpt.load_ir_state(str(tmp_path / "ir")).frames) == 2


def test_pytree_checkpoint_refusals(tmp_path):
    port, _, _ = _trees()
    path = str(tmp_path / "c.npz")
    ckpt.save_pytree(path, port, kind="Dataset")
    with pytest.raises(ValueError, match="is a 'Dataset', not a 'dict'"):
        ckpt.load_pytree(path, port, device=CPU)
    other = {"irs": Pair(port["irs"].a, None), "rest": (port["rest"][0],)}
    with pytest.raises(ValueError, match="tree structure"):
        ckpt.load_pytree(path, other, kind="Dataset", device=CPU)
    wrong = {"irs": Pair(torch.zeros(3, 3), None), "rest": port["rest"]}
    with pytest.raises(ValueError, match=r"leaf 0 \(\['irs'\]\.a\) has "
                                         "shape"):
        ckpt.load_pytree(path, wrong, kind="Dataset", device=CPU)
    with pytest.raises(ValueError, match="no sidecar"):
        ckpt.load_pytree(str(tmp_path / "none.npz"), port, device=CPU)
    with pytest.raises(TypeError, match="tensors, arrays and numbers"):
        ckpt.save_pytree(str(tmp_path / "bad"), {"a": "text"})


# -- the example --------------------------------------------------

def test_torch_dataset_sweep_example_runs_on_a_virtual_mesh(tmp_path):
    out = str(tmp_path / "dataset.npz")
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch",
                                      "dataset_sweep.py"),
         "--device", CPU, "--rooms", "8", "--rays", "128", "--out", out],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "8 rooms" in proc.stdout and "dataset sweep ok" in proc.stdout
    with np.load(out) as npz:
        assert npz["irs"].shape[0] == 8
