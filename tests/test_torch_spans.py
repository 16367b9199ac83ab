"""PyTorch port: its own profiler spans (``utils/profiling.py::span``).

* one ``Streamer.process`` chunk on a CPU scene records one span of each
  stage, ``art.stream.retrace`` (holding ``art.trace.plain``, the route a
  CPU scene runs), ``art.stream.addenda``, ``art.stream.crossfade`` and
  ``art.stream.ring``, one after another, none of them a user-scope
  range (those get a device-side copy in a card's trace);
* ``Engine.params`` records ``art.params``; a binaural chunk adds
  ``art.stream.decode`` between the addenda and the crossfade; a live
  player's chunk (on its producer thread) records ``wet_chunk``'s stages
  and no ring of the stream's;
* a per-arrival chunk records its four stages inside the crossfade
  (``art.arrival.extract``, ``residual`` in a binaural stream, ``taps``,
  ``convolve``; the history window under a ``taps`` span of its own);
* ``art.stream.addenda`` holds ``art.addenda.diffraction`` and
  ``art.addenda.air``, each exactly when its addendum is on (a plain
  stream records neither), the diffraction first;
* ``engine.trace_ir`` names the route that ran (``k4``, ``k3``,
  ``cluster``, ``plain``), and the one-scene launch's argument preparation
  (``art.k4.prep``) ends before the launch;
* the spans change no output bit, and with no profiler running a span is
  the shared null context: nothing is recorded and nothing is left open.

Small shapes: 256 rays, 8 kHz, 0.05 s chunks and a 0.1 s IR."""

import dataclasses
import types
from collections import Counter

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile
from torch_parity import CPU

import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import engine, streaming
from realisticaudioraytracing2d_tpu_torch.live import LivePlayer
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.utils import profiling

STAGES = ["art.stream.retrace", "art.stream.addenda", "art.stream.crossfade",
          "art.stream.ring"]


@pytest.fixture(scope="module")
def small():
    room = art.rooms.smoll_room(device=CPU)
    cfg = art.smoll_room_config(ray_count=256)
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, sample_rate=8000, reverb_duration=0.1,
        chunk_duration=0.05))
    dry = torch.as_tensor(np.random.default_rng(5).normal(
        size=4 * cfg.audio.chunk_samples).astype(np.float32))
    return room, cfg, dry


def _spans(prof):
    """The port's spans a profiler recorded, by start time."""
    return sorted((e for e in prof.events() if e.name.startswith("art.")),
                  key=lambda e: e.time_range.start)


def _cpu_profile(**kw):
    return profile(activities=[ProfilerActivity.CPU], **kw)


def _inside(inner, outer):
    return outer.time_range.start <= inner.time_range.start and \
        inner.time_range.end <= outer.time_range.end


def _chunk(room, cfg, dry, binaural=False, n_chunks=1):
    """``Engine.params`` and ``n_chunks`` chunks of ``Streamer.process``,
    their outputs joined."""
    params = art.Engine(room.scene, cfg).params(room.source, room.listener)
    st = art.Streamer(room.scene, cfg, seed=4, binaural=binaural)
    n = cfg.audio.chunk_samples
    return torch.cat([st.process(dry[i * n:(i + 1) * n], params,
                                 facing=0.3 * i)
                      for i in range(n_chunks)], dim=-1)


def test_a_stream_chunk_records_each_stage_once_in_order(small):
    room, cfg, dry = small
    with _cpu_profile() as prof:
        _chunk(room, cfg, dry)
    spans = _spans(prof)
    assert Counter(e.name for e in spans) == Counter(
        ["art.params", "art.trace.plain"] + STAGES)
    by = {e.name: e for e in spans}
    # siblings, one after another: params, then the chunk's four stages
    order = ["art.params"] + STAGES
    assert [e.name for e in spans if e.name in order] == order
    for a, b in zip(order, order[1:]):
        assert by[a].time_range.end <= by[b].time_range.start, (a, b)
    assert _inside(by["art.trace.plain"], by["art.stream.retrace"])
    # the chunk's aten work runs inside the stages
    for name in STAGES + ["art.params"]:
        assert any(e.name.startswith("aten::") and _inside(e, by[name])
                   for e in prof.events()), name
    assert not any(e.is_user_annotation for e in spans)
    kineto = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("art.")]
    assert len(kineto) == len(spans)
    assert not any(e.is_user_annotation() for e in kineto)


def test_engine_params_records_one_span(small):
    room, cfg, _ = small
    eng = art.Engine(room.scene, cfg)
    with _cpu_profile() as prof:
        p = eng.params(room.source, room.listener)
    assert [e.name for e in _spans(prof)] == ["art.params"]
    assert torch.equal(p.source, torch.as_tensor(room.source,
                                                 dtype=torch.float32))


def test_a_binaural_chunk_adds_the_decode(small):
    room, cfg, dry = small
    with _cpu_profile() as prof:
        out = _chunk(room, cfg, dry, binaural=True)
    assert tuple(out.shape) == (2, cfg.audio.chunk_samples)
    names = [e.name for e in _spans(prof)]
    assert names.count("art.stream.decode") == 1
    stages = [n for n in names if n.startswith("art.stream.")]
    assert stages == STAGES[:2] + ["art.stream.decode"] + STAGES[2:]


@pytest.mark.parametrize("binaural", [False, True])
def test_a_per_arrival_chunk_splits_its_crossfade(small, binaural):
    """Per-arrival Doppler's stages, one after another inside the
    crossfade span: the table and removal, the residual's decode
    (binaural only), the history window, matching and tap synthesis, the
    residual's convolution."""
    room, cfg, dry = small
    params = art.Engine(room.scene, cfg).params(room.source, room.listener)
    st = art.Streamer(room.scene, cfg, seed=4, binaural=binaural)
    n = cfg.audio.chunk_samples
    wd = n + st.arrival_early + 2
    window = (dry, *streaming.window_scalars(0, n, wd, dry.shape[-1], True,
                                             None), True)
    with _cpu_profile() as prof:
        st.process(dry[:n], params, facing=0.3, window=window)
    spans = _spans(prof)
    arrival = [e for e in spans if e.name.startswith("art.arrival.")]
    assert [e.name for e in arrival] == (
        ["art.arrival.extract"]
        + (["art.arrival.residual"] if binaural else [])
        + ["art.arrival.taps", "art.arrival.convolve"])
    crossfade, = [e for e in spans if e.name == "art.stream.crossfade"]
    assert all(_inside(e, crossfade) for e in arrival)
    for a, b in zip(arrival, arrival[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)
    assert sum(e.name == "art.stream.decode" for e in spans) == binaural


@pytest.mark.parametrize("diffraction,air", [(False, False), (1, False),
                                             (False, True), (2, True)])
def test_the_addenda_record_their_own_spans_when_on(small, diffraction,
                                                    air):
    room, cfg, dry = small
    params = art.Engine(room.scene, cfg).params(room.source, room.listener)
    st = art.Streamer(room.scene, cfg, seed=4, diffraction=diffraction,
                      air_alpha=0.005 if air else None)
    with _cpu_profile() as prof:
        st.process(dry[:cfg.audio.chunk_samples], params)
    spans = _spans(prof)
    addenda, = [e for e in spans if e.name == "art.stream.addenda"]
    inner = [e for e in spans if e.name.startswith("art.addenda.")]
    assert [e.name for e in inner] == (
        ["art.addenda.diffraction"] * bool(diffraction)
        + ["art.addenda.air"] * air)
    assert all(_inside(e, addenda) for e in inner)
    for a, b in zip(inner, inner[1:]):
        assert a.time_range.end <= b.time_range.start
    for e in inner:
        assert any(x.name.startswith("aten::") and _inside(x, e)
                   for x in prof.events()), e.name


def test_a_live_chunk_records_the_wet_chunk_stages_and_no_ring(small):
    room, cfg, dry = small
    params = art.TraceParams.make(room.source, room.listener, device=CPU)
    # the player's chunks run on its producer thread
    with _cpu_profile(experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        rep = LivePlayer(room.scene, cfg, seed=1, device=CPU).run(
            dry, total_chunks=2, loop=False, realtime=False, params=params)
    assert rep.chunks == 2
    assert Counter(e.name for e in _spans(prof)) == Counter(
        {"art.stream.retrace": 2, "art.trace.plain": 2,
         "art.stream.addenda": 2, "art.stream.crossfade": 2})


def _route_spans(monkeypatch, device, n_walls, uniforms=None,
                 backend="auto"):
    out = torch.zeros(1, 8, 1)
    for mod, name in ((bk, "trace_frames_ir_mega"),
                      (bk, "trace_frames_ir_mega_plain"),
                      (bk, "trace_frames_ir_whole"),
                      (bk, "trace_frames_ir_plain"),
                      (engine, "_trace_accel")):
        monkeypatch.setattr(mod, name, lambda *a, **k: out)
    # what trace_ir reads of a scene before it routes
    scene = types.SimpleNamespace(device=torch.device(device),
                                  n_walls=n_walls)
    with _cpu_profile() as prof:
        got = engine.trace_ir(scene, None, n_rays=4, max_bounces=2,
                              sample_rate=8000, ir_length=8,
                              uniforms=uniforms, backend=backend)
    assert got is out
    return [e.name for e in _spans(prof)]


@pytest.mark.parametrize("device,n_walls,host_uniforms,backend,route", [
    ("cuda", 20, False, "auto", "k4"),
    ("cuda", 20, True, "auto", "k3"),
    ("cuda", bk.MAX_WALLS + 4, False, "auto", "cluster"),
    ("cuda", 20, False, "accel", "cluster"),
    ("cuda", 20, False, "plain", "plain"),
    ("cpu", 20, False, "auto", "plain"),
    ("cpu", 20, True, "auto", "plain"),
    ("cpu", 20, False, "accel", "plain"),
])
def test_trace_ir_names_the_route_that_ran(monkeypatch, device, n_walls,
                                           host_uniforms, backend, route):
    uniforms = (torch.zeros(1, 4), torch.zeros(1, 2, 4, 3)) \
        if host_uniforms else None
    assert _route_spans(monkeypatch, device, n_walls, uniforms,
                        backend) == [f"art.trace.{route}"]


def test_k4_prep_ends_before_the_launch(small, monkeypatch):
    room, _, _ = small
    params = art.TraceParams.make(room.source, room.listener, device=CPU)
    seen = []

    def launch(host_uniforms, walls, listeners, *rest):
        seen.append((walls.shape, listeners.shape))
        with profiling.span("test.launch"):
            return torch.zeros(1, 1, 8, 1)

    monkeypatch.setattr(bk, "_launch", launch)
    with _cpu_profile() as prof:
        bk._launch_scene(False, room.scene, params, None, None,
                         rng.seed_key(1), 1, 64, 3, 8000, 8, None, None)
    spans = _spans(prof)
    assert [e.name for e in spans] == ["art.k4.prep", "art.test.launch"]
    prep, launched = spans
    assert prep.time_range.end <= launched.time_range.start
    assert seen == [((1, 10 + room.scene.n_bands, room.scene.n_walls),
                     (1, 1, 2))]
    assert any(e.name.startswith("aten::") and _inside(e, prep)
               for e in prof.events())


def test_spans_change_no_bits_and_leave_nothing_without_a_profiler(small):
    room, cfg, dry = small
    assert profiling.span("stream.ring") is profiling._NO_SPAN
    plain_out = [_chunk(room, cfg, dry, b, 4) for b in (False, True)]
    assert profiling.span("stream.ring") is profiling._NO_SPAN
    with _cpu_profile() as prof:
        traced_out = [_chunk(room, cfg, dry, b, 4) for b in (False, True)]
    for a, b in zip(plain_out, traced_out):
        assert float(a.abs().max()) > 0 and torch.equal(a, b)
    # per chunk 5 spans (6 binaural) and one params a stream
    assert len(_spans(prof)) == 2 * (1 + 4 * 5) + 4
    # nothing of the unprofiled chunks reaches a later session
    _chunk(room, cfg, dry)
    with _cpu_profile() as prof:
        torch.zeros(1)
    assert _spans(prof) == []
