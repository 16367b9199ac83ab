"""PyTorch port: frequency bands, many listeners and batches of large
scenes on the plain paths, against the JAX package on the CPU.

What the card runs through K3/K4/K9 (any K bands: registers up to 32, a
device scratch past that), through listener blocks (any L) and, past
5,280 walls, through one K8/K7 call per batch entry, is held here in its
plain form:

* the plain twins of K3/K4 (``trace_frames_ir_plain`` on JAX's uniforms)
  and K9 (``trace_rooms_ir_mega_plain``, ``sweep_rooms(backend="plain")``)
  at K = 8, 32 and 512 against JAX's jnp ``trace_accumulate`` and
  ``sweep_rooms``;
* a K-band scene whose bands all carry band 0's absorption gives K copies
  of the one-band IR, bit for bit;
* a 24-listener trace equals its 16- and 8-listener blocks, bit for bit,
  and JAX's 24-listener trace;
* the plain route of a 2-entry batch of 5,304-wall cities against JAX's
  jnp ``sweep_rooms`` on the same uniforms, what moves its few differing
  bins (below), and the cluster route's plain version
  (``trace_rooms_ir_accel_plain``) entry by entry, bit for bit;
* a banded stream with per-band air absorption against JAX's stream;
* ``cli bake --bands 8`` and ``cli sweep --bands 4`` against the JAX CLI.

Tolerances, as in tests/test_torch_bounce_kernel.py and
tests/test_torch_sweep.py: plain vs JAX on the same uniforms, total energy
to 1e-4 and per-bin L1 to 1% (an ulp of sin/cos can move a hit that sits
on a bin edge); the stream rtol 2e-3, atol 2e-5 (tests/test_streaming.py);
a baked WAV within 1e-4 of its peak plus two 16-bit steps. On the
5,304-wall cities a few of a listener's ~150 hit bins differ from JAX's
(4 of 145 and 5 of 109 under ``PRNGKey(21)``): JAX's ``sweep_rooms`` runs
under ``jit``, where XLA contracts ``a * b + c`` into one fused
multiply-add, and the port rounds the product and the sum apart (as its
kernels do, built with ``--fmad=false``). Over a city's 100 m paths that
moves a hit's delay by up to ~5e-7 s (the ray-circle test's
``|L|^2 - tca^2`` cancels), so a hit within that of a bin edge, of the
NEE cutoff or of an occluder's slack lands on the other side. With
``jit`` disabled JAX gives the port's bins; where the two differ, a
float64 trace of the same rays sides with JAX in 7 and with the port in
3 of the 10 records of the two cities
(:func:`test_large_scene_differences_from_jax_are_its_multiply_adds`).
So that IR is compared by total energy (1%, as the JAX package holds its
kernels against its oracle in tests/test_bounce_kernel.py::
test_engine_backend_routing), its 5 ms envelope (L1 2%) and the share of
bins that differ (under 0.2%). Sizes are
small (a few hundred rays, 4 bounces, 2,048 bins at 8 kHz): SmollRoom's
source sits behind a transmissive wall, so no hit lands before bounce 2.
At this size one hit is a large share of the IR, so a single razor-edge
bin flip exceeds the L1 limit: with ``PRNGKey(512)`` one of 208 hit bins
moves to its neighbour (L1 0.18, energy 2e-6, at every band count). The
band-count tests therefore share one key, under which no hit sits on a bin
edge. So does the stream: at 256 rays under ``PRNGKey(1)`` chunk 5 holds
such a flip at every band count (K = 1 as well), so the banded stream
runs the configuration of tests/test_torch_streaming.py's one-band stream.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (CPU, jax_chunk_uniforms, jax_frame_uniforms,
                          jax_room_uniforms, to_numpy, to_torch)

import realisticaudioraytracing2d_tpu as jart
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu import cli as jax_cli
from realisticaudioraytracing2d_tpu.engine import \
    trace_accumulate as jax_trace_accumulate
from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.models.scene import Scene as JaxScene
from realisticaudioraytracing2d_tpu.ops import air as jax_air
from realisticaudioraytracing2d_tpu.ops.ir import IRState as JaxIRState
from realisticaudioraytracing2d_tpu.ops.trace import \
    TraceParams as JaxTraceParams
from realisticaudioraytracing2d_tpu.ops.trace import \
    trace_hits_only as jax_trace_hits
from realisticaudioraytracing2d_tpu.parallel import sweep as jax_sweep
from realisticaudioraytracing2d_tpu_torch import cli, convert
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.models.scene import Scene
from realisticaudioraytracing2d_tpu_torch.ops import air, rng
from realisticaudioraytracing2d_tpu_torch.ops.cuda import accel_kernel as ak
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.ops.trace import (TraceParams,
                                                         trace_hits_only)
from realisticaudioraytracing2d_tpu_torch.parallel import sweep as sweep_mod
from realisticaudioraytracing2d_tpu_torch.parallel.sweep import (
    large_on_card, sweep_rooms)
from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (click_clip,
                                                                 noise_burst,
                                                                 read_wav,
                                                                 write_wav)

SR, T = 8000, 2048
N_RAYS, N_BOUNCES = 256, 4


def _close(got, want):
    """Plain vs JAX on the same uniforms: energy 1e-4, per-bin L1 1%."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and (want != 0).sum() > 50
    assert abs(got.sum() - want.sum()) / want.sum() < 1e-4
    assert np.abs(got - want).sum() / np.abs(want).sum() < 1e-2


def _jax_trace(room, listeners, key, n_frames):
    p = JaxTraceParams.make(room.source, listeners, 0.5, 343.0, 1.0)
    n_l = np.asarray(listeners).reshape(-1, 2).shape[0]
    return np.asarray(jax_trace_accumulate(
        room.scene, p, JaxIRState.zeros(T, n_l, room.scene.n_bands), key,
        n_rays=N_RAYS, max_bounces=N_BOUNCES, sample_rate=SR,
        n_frames=n_frames, backend="jnp").sum)


@pytest.mark.parametrize("n_bands", [8, 32, 512])
def test_banded_plain_matches_jax(n_bands):
    room = jax_rooms.smoll_room(n_bands=n_bands)
    key = jax.random.PRNGKey(5)
    want = _jax_trace(room, room.listener, key, 2)
    scene = convert.scene_from_arrays(room.scene, device=CPU)
    params = TraceParams.make(room.source, room.listener, device=CPU)
    emit, u = jax_frame_uniforms(key, 2, N_BOUNCES, N_RAYS)
    got = bk.trace_frames_ir_plain(scene, params, emit, u, sample_rate=SR,
                                   ir_length=T)
    assert tuple(got.shape) == (1, T, n_bands)
    _close(to_numpy(got), want)
    # higher bands lose more at every wall (the materials' tables)
    assert float(got[..., -1].sum()) < float(got[..., 0].sum())
    # K3's and K4's wrappers run these plain twins on a CPU scene
    whole = bk.trace_frames_ir_whole(scene, params, emit, u, sample_rate=SR,
                                     ir_length=T)
    assert torch.equal(whole, got)
    mega = bk.trace_frames_ir_mega(scene, params, 7, 1, n_rays=N_RAYS,
                                   max_bounces=N_BOUNCES, sample_rate=SR,
                                   ir_length=T)
    assert torch.equal(mega, bk.trace_frames_ir_plain(
        scene, params, *rng.philox_uniforms(7, 1, N_BOUNCES, N_RAYS, CPU),
        sample_rate=SR, ir_length=T))


@pytest.mark.parametrize("n_bands", [8, 32, 512])
def test_banded_rooms_plain_matches_jax_sweep(n_bands):
    key = jax.random.PRNGKey(3)
    ref, src, lis = jax_rooms.random_rooms(2, seed=2, n_bands=n_bands)
    want = np.asarray(jax_sweep.sweep_rooms(
        ref, src, lis, key, n_rays=N_RAYS, max_bounces=N_BOUNCES,
        sample_rate=SR, ir_length=T, n_frames=1, backend="jnp"))
    scenes, _, _ = rooms.random_rooms(2, seed=2, n_bands=n_bands, device=CPU)
    uniforms = jax_room_uniforms(key, 2, 1, N_BOUNCES, N_RAYS)
    got = sweep_rooms(scenes, src, lis, 0, n_rays=N_RAYS,
                      max_bounces=N_BOUNCES, sample_rate=SR, ir_length=T,
                      backend="plain", uniforms=uniforms)
    assert tuple(got.shape) == (2, 1, T, n_bands)
    for e in range(2):
        _close(to_numpy(got[e]), want[e])
    # K9's wrapper runs the same plain twin on a CPU scene
    k9 = bk.trace_rooms_ir_mega(scenes, src, lis, 0, 1, n_rays=N_RAYS,
                                max_bounces=N_BOUNCES, sample_rate=SR,
                                ir_length=T, uniforms=uniforms)
    assert torch.equal(k9, got)


@pytest.mark.parametrize("n_bands", [8, 32])
def test_equal_bands_are_copies_of_the_one_band_ir(n_bands):
    room = rooms.smoll_room(device=CPU)
    params = TraceParams.make(room.source, room.listener, device=CPU)
    emit, u = rng.philox_uniforms(4, 2, N_BOUNCES, N_RAYS, CPU)
    one = bk.trace_frames_ir_plain(room.scene, params, emit, u,
                                   sample_rate=SR, ir_length=T)
    same = room.scene._replace(
        absorption=room.scene.absorption.expand(-1, n_bands).contiguous())
    many = bk.trace_frames_ir_plain(same, params, emit, u, sample_rate=SR,
                                    ir_length=T)
    assert float(one.sum()) > 0
    for k in range(n_bands):
        assert torch.equal(many[..., k], one[..., 0])


def _grid(n):
    """``n`` listeners on a grid across SmollRoom."""
    g = np.random.default_rng(n)
    return np.stack([g.uniform(-18, 18, n), g.uniform(-4, 7, n)],
                    -1).astype(np.float32)


def test_24_listeners_equal_their_blocks_and_jax():
    room = jax_rooms.smoll_room(n_bands=4)
    lis = _grid(24)
    key = jax.random.PRNGKey(11)
    want = _jax_trace(room, lis, key, 1)
    scene = convert.scene_from_arrays(room.scene, device=CPU)
    emit, u = jax_frame_uniforms(key, 1, N_BOUNCES, N_RAYS)

    def trace(listeners):
        return bk.trace_frames_ir_plain(
            scene, TraceParams.make(room.source, listeners, device=CPU),
            emit, u, sample_rate=SR, ir_length=T)

    whole = trace(lis)
    assert tuple(whole.shape) == (24, T, 4)
    assert torch.equal(whole, torch.cat([trace(lis[:16]), trace(lis[16:])]))
    _close(to_numpy(whole), want)
    assert (whole.sum((1, 2)) > 0).sum() >= 12


def _city_batch(jax_side):
    """Two cities of 5,304 walls each (past the bounce kernel's 5,280),
    stacked, with a source and a listener in the open."""
    mod = jax_rooms if jax_side else rooms
    kw = {} if jax_side else dict(device=CPU)
    cities = [mod.city_scene(1325, seed=s, **kw) for s in (1, 2)]
    stack = JaxScene.stack if jax_side else Scene.stack
    src = np.stack([np.asarray(c.source) for c in cities])
    lis = np.stack([np.asarray(c.listener) for c in cities])
    return stack([c.scene for c in cities]), src, lis


def _close_large(got, want):
    """A large scene's IR against JAX's jitted trace of the same rays:
    energy 1%, 5 ms envelope L1 2%, under 0.2% of the bins apart. Read
    under ``PRNGKey(21)`` at 2,048 rays: energy 3.2e-6 and 4.5e-3 apart,
    envelope L1 3.2e-6 and 4.5e-3, 4 and 5 of 8,000 bins (0.05% and
    0.06%); per-bin L1 0.095 and 0.124, which is why it is not used."""
    g, w = np.asarray(got).ravel(), np.asarray(want).ravel()
    assert (w != 0).sum() > 50
    assert abs(g.sum() - w.sum()) / w.sum() < 1e-2
    env_g, env_w = g.reshape(-1, 80).sum(1), w.reshape(-1, 80).sum(1)
    assert np.abs(env_g - env_w).sum() / env_w.sum() < 2e-2
    assert (np.abs(g - w) > 1e-6 * w.max()).mean() < 2e-3


def test_large_scene_batch_plain_matches_jax_sweep():
    key = jax.random.PRNGKey(21)
    ref, src, lis = _city_batch(True)
    assert ref.a.shape[-2] > bk.MAX_WALLS
    # a city's listener hears few of 256 rays: 2,048
    kw = dict(n_rays=2048, max_bounces=N_BOUNCES, sample_rate=16000,
              ir_length=8000, n_frames=1, input_gain=100.0)
    want = np.asarray(jax_sweep.sweep_rooms(ref, src, lis, key,
                                            backend="jnp", **kw))
    scenes, src_p, lis_p = _city_batch(False)
    np.testing.assert_array_equal(src_p, src)
    assert not large_on_card(scenes)      # the CPU runs the plain route
    uniforms = jax_room_uniforms(key, 2, 1, N_BOUNCES, 2048)
    got = sweep_rooms(scenes, src, lis, 0, uniforms=uniforms, **kw)
    assert tuple(got.shape) == (2, 1, 8000, 1)
    for e in range(2):
        _close_large(to_numpy(got[e]), want[e])


def _hit_bins(hits, sample_rate):
    """Each hit record's IR bin as ``scatter_hits`` computes it (in the
    delay's precision), -1 where no hit landed."""
    delay, valid = np.asarray(hits.delay), np.asarray(hits.valid)
    return np.where(valid, np.floor(delay * delay.dtype.type(sample_rate)),
                    -1)


def test_large_scene_differences_from_jax_are_its_multiply_adds():
    # the second city of test_large_scene_batch_plain_matches_jax_sweep,
    # its rays and JAX's key (PRNGKey(21), room 1, frame 0)
    room = jax_rooms.city_scene(1325, seed=2)
    key = jax.random.fold_in(jax.random.PRNGKey(21), 1)
    n_rays, sr = 2048, 16000
    p = JaxTraceParams.make(room.source, room.listener, 0.5, 343.0, 100.0)
    hits = functools.partial(jax_trace_hits, room.scene, p,
                             jax.random.fold_in(key, 0), n_rays=n_rays,
                             max_bounces=N_BOUNCES)
    fused = _hit_bins(hits(), sr)
    with jax.disable_jit():         # op by op: no multiply-add contraction
        unfused = _hit_bins(hits(), sr)
    scene = convert.scene_from_arrays(room.scene, device=CPU)
    params = TraceParams.make(room.source, room.listener, input_gain=100.0,
                              device=CPU)
    emit, u = jax_frame_uniforms(key, 1, N_BOUNCES, n_rays)
    port = _hit_bins(trace_hits_only(scene, params, emit[0], u[0]), sr)

    def f64(x):
        return x.double() if x.is_floating_point() else x

    wide = _hit_bins(trace_hits_only(
        Scene(*map(f64, scene)), TraceParams(*(
            f64(x) if isinstance(x, torch.Tensor) else x for x in params)),
        emit[0].double(), u[0].double()), sr)
    # JAX without jit bins every hit as the port does
    assert np.array_equal(unfused, port)
    # under jit a few records move; at each the float64 trace agrees with
    # one side: a rounding across a bin edge or a cutoff, not a fault
    apart = fused != port
    assert 1 <= apart.sum() <= 8
    assert np.all((wide[apart] == fused[apart]) | (wide[apart] == port[apart]))


def test_large_scene_batch_cluster_route_entry_by_entry():
    scenes, src, lis = _city_batch(False)
    kw = dict(n_rays=1024, max_bounces=N_BOUNCES, sample_rate=16000,
              ir_length=8000)
    # on a CPU scene the cluster route runs its plain version
    got = ak.trace_rooms_ir_accel(scenes, src, lis, 5, 1, entry_offset=7,
                                  input_gain=100.0, **kw)
    assert tuple(got.shape) == (2, 1, 8000, 1)
    unsorted = bk.trace_rooms_ir_mega_plain(scenes, src, lis, 5, 1,
                                            entry_offset=7, input_gain=100.0,
                                            **kw)
    for e in range(2):
        # entry e draws the numbers of entry 7 + e, as K9's plain version
        # does; the walls' sort and the rays' re-sorts between bounces
        # change no hit of this data (no tie between two walls, no bin
        # summed in another order)
        one = ak.trace_frames_ir_accel_sorted_plain(
            scenes.row(e), TraceParams.make(src[e], lis[e], input_gain=100.0,
                                            device=CPU), 5, 1, entry=7 + e,
            **kw)
        assert torch.equal(got[e], one)
        assert float(one.sum()) > 0 and torch.equal(one, unsorted[e])


def test_banded_stream_with_air_matches_jax():
    # the configuration of tests/test_torch_streaming.py's one-band stream
    room = jart.rooms.smoll_room(n_bands=8)
    cfg = art.smoll_room_config(ray_count=512, n_bands=8)
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, reverb_duration=0.2, chunk_duration=0.05))
    alpha = np.asarray(jax_air.iso9613_alpha(jax_air.band_frequencies(8)),
                       np.float32)
    np.testing.assert_allclose(np.asarray(air.iso9613_alpha(
        air.band_frequencies(8))), alpha, rtol=1e-6)
    dry = noise_burst(0.12, cfg.audio.sample_rate, seed=1)
    key = jax.random.PRNGKey(0)
    jp = jart.Engine(room.scene, cfg).params(room.source, room.listener)
    want = np.asarray(jart.Streamer(room.scene, cfg, key,
                                    air_alpha=jnp.asarray(alpha)).stream_clip(
        jnp.asarray(dry), lambda i: jp))
    scene = convert.scene_from_arrays(room.scene, device=CPU)
    p = art.Engine(scene, cfg).params(room.source, room.listener)
    streamer = art.Streamer(scene, cfg, air_alpha=to_torch(alpha),
                            uniforms_fn=lambda i: jax_chunk_uniforms(
                                key, i, 1, cfg.sim.max_bounces,
                                cfg.sim.ray_count))
    assert tuple(streamer.state.prev_ir.shape) == (1, cfg.audio.ir_length, 8)
    got = to_numpy(streamer.stream_clip(to_torch(dry), lambda i: p))
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-5)


SMALL = ["--rays", str(N_RAYS), "--bounces", str(N_BOUNCES),
         "--sample-rate", "8000", "--reverb", "0.256", "--frames", "2",
         "--seed", "3"]


def test_cli_bake_banded_matches_jax(tmp_path, capsys, monkeypatch):
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, click_clip(0.5, 8000, click_times=(0.05, 0.3)), 8000)
    wet_j, wet_p = str(tmp_path / "j.wav"), str(tmp_path / "p.wav")
    args = ["bake", "--room", "smoll", *SMALL, "--bands", "8", "--in", dry]
    jax_cli.main(args + ["--out", wet_j])
    # the port traces JAX's draws of that seed (fold_in(key, frame))
    emit, u = jax_frame_uniforms(jax.random.PRNGKey(3), 2, N_BOUNCES,
                                 N_RAYS)
    trace_frames = art.Engine.trace_frames
    monkeypatch.setattr(art.Engine, "trace_frames", lambda self, p, seed=0,
                        n_frames=1, state=None: trace_frames(
                            self, p, n_frames=n_frames, state=state,
                            uniforms=(emit, u)))
    cli.main(args + ["--device", CPU, "--out", wet_p])
    assert "baked 4000 samples in" in capsys.readouterr().out
    want, rate_j = read_wav(wet_j)
    got, rate_p = read_wav(wet_p)
    assert rate_j == rate_p == 8000 and got.shape == want.shape
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max() + 2 / 32768)


def test_cli_sweep_banded_matches_jax(tmp_path, capsys, monkeypatch):
    out_j, out_p = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    args = ["sweep", "--rooms", "2", *SMALL, "--bands", "4"]
    jax_cli.main(args + ["--out", out_j])
    uniforms = jax_room_uniforms(jax.random.PRNGKey(3), 2, 2, N_BOUNCES,
                                 N_RAYS)
    sweep = sweep_mod.sweep_rooms
    monkeypatch.setattr(sweep_mod, "sweep_rooms", lambda *a, **kw: sweep(
        *a, uniforms=uniforms, **kw))
    cli.main(args + ["--device", CPU, "--out", out_p])
    assert "swept 2 rooms in" in capsys.readouterr().out
    want, got = np.load(out_j), np.load(out_p)
    np.testing.assert_array_equal(got["sources"], want["sources"])
    assert got["irs"].shape == want["irs"].shape == (2, 1, 2048, 4)
    for e in range(2):
        _close(got["irs"][e], want["irs"][e])
