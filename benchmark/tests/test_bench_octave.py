"""The barrier cell (``samplescene_octave.barrier_walk``, driver
``stream_octave``): SampleScene in octave bands with order-2 diffraction
and ISO 9613-1 air. On the CPU at small sizes: a run is correct, compares
shadowed and lit chunks, and its traced line carries the new per-layer
metrics; the new readers and K2's roofline on events counted by hand; the
fault programs (order 2 dropped, the air off, the linear split in the
octave split's place, the diffraction off, the bands collapsed to the
scalar absorption) each read ``correct: false``; the bfloat16 control fails
the limits the sound runs pass. On the card (``-m cuda``): the octave
masks equal the CPU's, and the addenda's spans hold the K2 and air
launches."""

from __future__ import annotations

import contextlib
import io
import json
import time

import numpy as np
import pytest
import small_tree
import torch
from conftest import REPO, run_cell

from benchmark import capture, control, registry, roofline_k2
from benchmark.reference import addenda

CELL = "samplescene_octave.barrier_walk"
METRICS = REPO / "benchmark" / "metrics"
SPANS = {"diffraction": "art.addenda.diffraction",
         "air": "art.addenda.air",
         "band_crossfade": "art.stream.crossfade"}
NAMES = [f"{kind}.{s}" for kind in ("stage_host_ms", "stage_launches")
         for s in SPANS]
E = capture.Event


@pytest.fixture
def small(tree):
    """The test tree with the cell cut to a CPU's size: 128 rays x 4
    bounces, 8 kHz, a 0.25 s IR; the listener at 8 m/s, so a second's
    window goes most of the way round its circle, in and out of the
    barrier's shadow."""
    bench = tree / "benchmark"
    small_tree._rewrite(bench / "configs" / "samplescene_octave.json",
                        {"sim": {"ray_count": 128, "max_bounces": 4},
                         "audio": {"sample_rate": 8000,
                                   "reverb_duration": 0.25,
                                   "chunk_duration": 0.1}})
    small_tree._rewrite(bench / "traffic" / "barrier_walk.json",
                        {"speed_m_per_s": 8.0, "dry_chunks": 6,
                         "warm_chunks": 2, "trace_steps": 5})
    return tree


def reader(name):
    return registry.reader(METRICS, name).read


def test_the_cell_finds_its_parts():
    c = registry.cell(registry.load(REPO), CELL, REPO)
    assert c.chips == 1 and c.traffic["driver"] == "stream_octave"
    assert {m["name"] for m, _ in c.end_to_end} == {"gpu_ms_per_chunk",
                                                    "setup_s"}
    assert {m["name"] for m, _ in c.per_layer} == set(NAMES) | {
        "launches_per_chunk.octave", "host_chunk_ms.octave",
        "fft_device_ms_per_chunk.octave", "k4_roofline.octave",
        "k2_roofline.diffraction"}
    cfg = c.config
    assert cfg["reduced"] == [] and cfg["precision"] == "float32"
    assert (cfg["sim"]["ray_count"], cfg["sim"]["max_bounces"],
            cfg["sim"]["n_bands"]) == (15000, 5, 8)
    assert (cfg["audio"]["sample_rate"], cfg["audio"]["reverb_duration"],
            cfg["audio"]["chunk_duration"]) == (44100, 2.0, 0.1)
    assert cfg["band_split"] == "octave" and cfg["diffraction"]["order"] == 2
    assert (cfg["air"]["temperature_c"], cfg["air"]["rel_humidity"]) == (
        20.0, 50.0)
    assert cfg["scene"]["walk"] == {"center": [18.5, 14.12], "radius": 4.0}
    assert cfg["scene"]["source"] == [0.07, 10.01]
    assert c.traffic["speed_m_per_s"] == 1.4 and c.traffic["compare"] == 3
    assert set(c.limits) == {"out_gap", "band_ir_gap"}


def test_the_walk_is_shadowed_on_a_good_part_of_its_circle():
    """The reference's own test on 720 points of the walk: the barrier
    blocks the direct segment on 44% of the circle, and every blocked pose
    hears a diffraction path."""
    cfg = json.loads((REPO / "benchmark" / "configs"
                      / "samplescene_octave.json").read_text())
    walk = cfg["scene"]["walk"]
    add = addenda.Addenda(addenda.band_walls(cfg), cfg["band_centres_hz"],
                          speed=343.0, gain=1.0, sample_rate=44100,
                          ir_length=88200, dtype=torch.float64,
                          acc_dtype=torch.float64, device="cpu")
    a = np.arange(720) * 2 * np.pi / 720
    poses = np.stack([walk["center"][0] + walk["radius"] * np.cos(a),
                      walk["center"][1] + walk["radius"] * np.sin(a)], 1)
    shadow = [add.blocked(cfg["scene"]["source"], p) for p in poses]
    assert 0.40 < np.mean(shadow) < 0.48
    for p in poses[np.flatnonzero(shadow)[::20]]:
        assert add.paths(cfg["scene"]["source"], p)[0].numel() > 0


def test_a_run_is_correct_compares_both_strata_and_carries_the_stages(
        small):
    rc, last, err = run_cell(small, CELL, seconds=1.0)
    assert rc == 0 and last["correct"] and last["failed"] == 0, err[-3:]
    assert set(last["metrics"]) == {"setup_s"}   # no card: no device time
    assert set(last["checks"]) == {"out_gap", "band_ir_gap"}
    shadow = [ln for ln in err if ln.startswith("window 1:")]
    assert shadow and " 0 shadowed" not in shadow[0], err
    rc, last, err = run_cell(small, CELL, trace=1)
    assert rc == 0 and last["correct"], err[-3:]
    got = last["metrics"]
    for s in SPANS:
        assert got[f"stage_host_ms.{s}"]["value"] > 0, s
        assert got[f"stage_launches.{s}"] == {"value": 0.0,
                                              "unit": "launches"}, s
    assert got["host_chunk_ms.octave"]["value"] > 0
    for name in ("launches_per_chunk.octave", "fft_device_ms_per_chunk."
                 "octave", "k4_roofline.octave", "k2_roofline.diffraction"):
        assert name not in got, name


def test_the_strata_keep_shadowed_and_lit_answers():
    from benchmark.drivers import stream_octave
    for seed in range(20):
        s = stream_octave.Strata(3, seed)
        s.active = True
        for i in range(200):
            s.offer((i, None), shadowed=(i // 25) % 2 == 0)
        kinds = {(i // 25) % 2 == 0 for i, _ in s.items}
        assert len(s.items) == 3 and kinds == {True, False}
        assert len({i for i, _ in s.items}) == 3
    assert s.windows == 1


def _chunk(t0):
    """One banded chunk's events from ``t0`` (us): the addenda with the
    diffraction and air spans inside, the crossfade, launch calls in
    them."""
    def host(name, a, b):
        return E("host", name, -1, t0 + a, t0 + b)

    def launch(t):
        return E("launch", "cudaLaunchKernel", -1, t0 + t, t0 + t + 1)

    return [host("art.stream.addenda", 100, 500), launch(110),
            host("art.addenda.diffraction", 120, 400), launch(130),
            launch(200), launch(300),
            host("art.addenda.air", 400, 480), launch(410), launch(450),
            host("art.stream.crossfade", 500, 900), launch(600),
            launch(950)]


def test_the_new_readers_by_hand():
    r = capture.Reading(_chunk(0) + _chunk(5000), [0], 2, 2, 0.01, {})
    ms = {s: reader(f"stage_host_ms.{s}")(r) for s in SPANS}
    assert ms == pytest.approx({"diffraction": 0.28, "air": 0.08,
                                "band_crossfade": 0.4})
    n = {s: reader(f"stage_launches.{s}")(r) for s in SPANS}
    assert n == {"diffraction": 3.0, "air": 2.0, "band_crossfade": 1.0}
    bare = [e for e in _chunk(0) if not e.name.startswith("art.")]
    for events in (bare, []):
        r = capture.Reading(events, [0], 1, 1, 0.01, {})
        for name in NAMES:
            assert reader(name)(r) is None, name


def test_k2_roofline_by_hand():
    """577 segments of 12 walls: 13 x 12 x 577 FLOP (90,012) against
    (6 x 577 + 5 x 12) x 4 bytes (14,088); the bytes bind. K1's launches
    (the same kernel with an index) are not K2's."""
    work = addenda.Work(1000.0, 500.0, 577.0)
    least = roofline_k2.least_seconds({"n_walls": 12}, work)
    assert least == pytest.approx(14088 / 3.35e12)
    evs = [E("kernel", "void wall_sweep_kernel<false, 4>(SweepRays, ...)",
             0, 0, 3),
           E("kernel", "void wall_sweep_kernel<false, 1>(SweepRays, ...)",
             0, 10, 12),
           E("kernel", "void wall_sweep_kernel<true, 4>(SweepRays, ...)",
             0, 20, 120)]
    r = capture.Reading(evs, [0], 1, 1, 0.01, {"n_walls": 12}, work)
    assert reader("k2_roofline.diffraction")(r) == pytest.approx(
        100 * least / 5e-6)
    assert reader("k2_roofline.diffraction")(r._replace(work=None)) is None
    assert reader("k2_roofline.diffraction")(r._replace(events=evs[2:])) \
        is None


def _modules():
    from realisticaudioraytracing2d_tpu_torch import streaming
    from realisticaudioraytracing2d_tpu_torch.models import materials
    return streaming, materials


def _addenda(monkeypatch, **over):
    """``_augment_ir`` with some of its arguments replaced."""
    streaming, _ = _modules()
    orig = streaming._augment_ir

    def augment(ir, scene, params, sr, diffraction, air_alpha, plain=False):
        kw = dict(diffraction=diffraction, air_alpha=air_alpha)
        kw.update({k: f(kw[k]) for k, f in over.items()})
        return orig(ir, scene, params, sr, kw["diffraction"],
                    kw["air_alpha"], plain)
    monkeypatch.setattr(streaming, "_augment_ir", augment)


def order_one(monkeypatch):
    """Order-2 diffraction dropped: order 1 only."""
    _addenda(monkeypatch, diffraction=lambda d: min(int(d), 1))


def air_off(monkeypatch):
    _addenda(monkeypatch, air_alpha=lambda a: None)


def diffraction_off(monkeypatch):
    _addenda(monkeypatch, diffraction=lambda d: False)


def linear_split(monkeypatch):
    """The crossfade in the linear split's bands."""
    streaming, _ = _modules()
    orig = streaming._crossfaded_wet
    monkeypatch.setattr(
        streaming, "_crossfaded_wet",
        lambda chunk, prev, cur, split="linear", sample_rate=None:
        orig(chunk, prev, cur, "linear", sample_rate))


def bands_collapsed(monkeypatch):
    """Every band of a material takes its scalar absorption."""
    _, materials = _modules()
    monkeypatch.setattr(
        materials.AudioMaterial, "absorption_bands",
        lambda self, n_bands: np.full((n_bands,), self.absorption,
                                      np.float32))


FAULTS = [order_one, air_off, linear_split, diffraction_off,
          bands_collapsed]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_fault_is_not_correct(small, monkeypatch, fault):
    fault(monkeypatch)
    rc, last, err = run_cell(small, CELL, seconds=1.0)
    assert rc == 0 and last["correct"] is False, err[-4:]
    assert last["failed"] > 0 and any("FAILED" in ln for ln in err[-2:])


def test_the_control_fails_where_sound_runs_pass(small):
    limits = registry.cell(registry.load(small), CELL, small).limits
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert control.main(["--workload", CELL, "--seeds", "21,22",
                             "--control", "2", "--seconds", "1.0"],
                            root=small, card=False) == 0
    for line in out.getvalue().strip().splitlines():
        got = json.loads(line)
        for name, limit in limits.items():
            assert got["lower"][name] <= limit
        assert max(got["control"][n] / limits[n] for n in limits) > 3


def _lead_in(n: int = 64) -> None:
    """Open a profiled window with 50 ms of host time and ``n`` spin
    kernels: late in a long process the profiler drops a session's first
    device events, and the lead-in takes the loss."""
    torch.cuda.synchronize()
    time.sleep(0.05)
    for _ in range(n):
        torch.cuda._sleep(1000)


@pytest.mark.cuda
def test_octave_masks_on_the_card_equal_the_cpu(card):
    from realisticaudioraytracing2d_tpu_torch.ops import convolve as cv
    for k, n_fft, sr in ((8, 131072, 44100), (8, 8192, 8000),
                         (4, 4096, 48000)):
        got = cv.split_masks(k, n_fft, torch.device("cuda"), "octave", sr)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), cv.octave_filterbank(k, n_fft, sr))


@pytest.mark.cuda
def test_the_addenda_spans_hold_k2_and_the_air_on_the_card(card):
    """One banded chunk with order-2 diffraction and air under the
    profiler: two K2 launches (no other stage launches K2), at least two
    launches inside ``art.addenda.diffraction`` and the air's inside
    ``art.addenda.air``."""
    import realisticaudioraytracing2d_tpu_torch as art
    from torch.profiler import ProfilerActivity, profile
    room = art.rooms.sample_scene(n_bands=8, device="cuda")
    cfg = art.sample_scene_config(n_bands=8, ray_count=2048)
    alpha = torch.tensor(art.ops.air.iso9613_alpha(
        art.ops.air.band_frequencies(8)), dtype=torch.float32,
        device="cuda")
    st = art.Streamer(room.scene, cfg, seed=3, diffraction=2,
                      air_alpha=alpha, band_split="octave")
    params = art.Engine(room.scene, cfg).params(
        room.source, np.array([18.5, 18.12], np.float32))  # in the shadow
    n = cfg.audio.chunk_samples
    dry = torch.rand(n, device="cuda") - 0.5
    st.process(dry, params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _lead_in()
        st.process(dry, params)
        torch.cuda.synchronize()
    evs = prof.events()
    spans = {name: [e for e in evs if e.name == name]
             for name in ("art.addenda.diffraction", "art.addenda.air")}
    assert all(len(v) == 1 for v in spans.values()), spans
    k2 = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA
          and "wall_sweep_kernel<false" in e.name]
    assert len(k2) == 2
    launches = [e for e in evs if e.name in capture.LAUNCH_CALLS]

    def inside(name):
        s = spans[name][0].time_range
        return [e for e in launches
                if s.start <= e.time_range.start <= s.end]
    assert len(inside("art.addenda.diffraction")) >= 2
    assert len(inside("art.addenda.air")) >= 1
