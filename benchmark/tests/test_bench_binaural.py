"""The headphone cell with per-arrival Doppler
(``smollroom_binaural.walk_turn_doppler``, driver ``stream_binaural``) on
the CPU at small sizes: a run is correct and its traced line carries the
per-stage metrics of the binaural decode and of per-arrival Doppler
(``benchmark/span_stages.py``); the new readers on events counted by hand
and their silence without the spans; the fault programs (the facing
ignored, the ears swapped, the taps frozen at their current delay, the
decorrelation signs dropped, the taps dropped with their bins still
removed) each read ``correct: false``; the bfloat16 control fails the
limit the sound runs pass."""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import small_tree
import torch
from conftest import REPO, run_cell

from benchmark import capture, control, registry

CELL = "smollroom_binaural.walk_turn_doppler"
METRICS = REPO / "benchmark" / "metrics"
SPANS = {"decode": "art.stream.decode",
         "arrival_extract": "art.arrival.extract",
         "arrival_residual": "art.arrival.residual",
         "arrival_taps": "art.arrival.taps",
         "arrival_convolve": "art.arrival.convolve"}
NAMES = [f"{kind}.{s}" for kind in ("stage_host_ms", "stage_launches")
         for s in SPANS]
E = capture.Event


@pytest.fixture
def small(tree):
    """The test tree with the cell cut to a CPU's size: 128 rays x 4
    bounces (SmollRoom's slant wall passes sound after two), 4.8 kHz."""
    bench = tree / "benchmark"
    small_tree._rewrite(bench / "configs" / "smollroom_binaural.json",
                        {"sim": {**small_tree.SIM, "ray_count": 128,
                                 "max_bounces": 4},
                         "audio": small_tree.AUDIO})
    small_tree._rewrite(bench / "traffic" / "walk_turn_doppler.json",
                        {"dry_chunks": 6, "warm_chunks": 2,
                         "trace_steps": 5})
    return tree


def reader(name):
    return registry.reader(METRICS, name).read


def test_the_cell_finds_its_parts():
    spec = registry.load(REPO)
    c = registry.cell(spec, CELL, REPO)
    assert c.chips == 1 and c.traffic["driver"] == "stream_binaural"
    assert {m["name"] for m, _ in c.end_to_end} == {"gpu_ms_per_chunk",
                                                    "setup_s"}
    got = {m["name"] for m, _ in c.per_layer}
    assert got == set(NAMES) | {"launches_per_chunk.binaural",
                                "host_chunk_ms.binaural",
                                "fft_device_ms_per_chunk.binaural",
                                "k4_roofline.binaural"}
    assert c.config["reduced"] == [] and c.config["precision"] == "float32"


def test_a_run_is_correct_and_traced_runs_carry_the_stages(small):
    rc, last, err = run_cell(small, CELL)
    assert rc == 0 and last["correct"] and last["failed"] == 0, err[-3:]
    assert set(last["metrics"]) == {"setup_s"}   # no card: no device time
    rc, last, err = run_cell(small, CELL, trace=1)
    assert rc == 0 and last["correct"], err[-3:]
    got = last["metrics"]
    for s in SPANS:
        assert got[f"stage_host_ms.{s}"]["value"] > 0, s
        # a CPU run launches no kernel
        assert got[f"stage_launches.{s}"] == {"value": 0.0,
                                              "unit": "launches"}, s
    assert got["host_chunk_ms.binaural"]["value"] > 0
    for name in ("launches_per_chunk.binaural",
                 "fft_device_ms_per_chunk.binaural", "k4_roofline.binaural"):
        assert name not in got, name


def test_a_program_without_the_spans_reads_none_and_stays_correct(
        small, monkeypatch):
    from realisticaudioraytracing2d_tpu_torch import streaming
    monkeypatch.setattr(streaming, "span",
                        lambda name: contextlib.nullcontext())
    rc, last, err = run_cell(small, CELL, trace=1)
    assert rc == 0 and last["correct"], err[-3:]
    assert not set(NAMES) & set(last["metrics"])


def _chunk(t0):
    """One composed chunk's events from ``t0`` (us): the decode, then the
    per-arrival stages inside the crossfade, with launch calls in them."""
    def host(name, a, b):
        return E("host", name, -1, t0 + a, t0 + b)

    def launch(t):
        return E("launch", "cudaLaunchKernel", -1, t0 + t, t0 + t + 1)

    return [host("art.stream.decode", 100, 200), launch(110), launch(150),
            host("art.stream.crossfade", 200, 900),
            host("art.arrival.taps", 210, 230), launch(220),
            host("art.arrival.extract", 240, 300), launch(250),
            launch(260), launch(270),
            host("art.arrival.residual", 300, 450), launch(310),
            host("art.arrival.taps", 460, 700), launch(500), launch(600),
            host("art.arrival.convolve", 700, 850), launch(800),
            launch(880), launch(950)]        # in no arrival stage


def test_the_new_readers_by_hand():
    r = capture.Reading(_chunk(0) + _chunk(5000), [0], 2, 2, 0.01, {})
    ms = {s: reader(f"stage_host_ms.{s}")(r) for s in SPANS}
    assert ms == pytest.approx({"decode": 0.1, "arrival_extract": 0.06,
                                "arrival_residual": 0.15,
                                "arrival_taps": 0.26,
                                "arrival_convolve": 0.15})
    n = {s: reader(f"stage_launches.{s}")(r) for s in SPANS}
    assert n == {"decode": 2.0, "arrival_extract": 3.0,
                 "arrival_residual": 1.0, "arrival_taps": 3.0,
                 "arrival_convolve": 1.0}


def test_the_new_readers_read_nothing_without_their_spans():
    bare = [e for e in _chunk(0) if not e.name.startswith("art.")]
    for events in (bare, []):
        r = capture.Reading(events, [0], 1, 1, 0.01, {})
        for name in NAMES:
            assert reader(name)(r) is None, name
    mono = [e for e in _chunk(0) if e.name not in ("art.stream.decode",
                                                   "art.arrival.residual")]
    r = capture.Reading(mono, [0], 1, 1, 0.01, {})
    assert reader("stage_launches.arrival_residual")(r) is None
    assert reader("stage_launches.arrival_taps")(r) == 3.0


def _modules():
    from realisticaudioraytracing2d_tpu_torch import spatial, streaming
    return spatial, streaming


def facing_ignored(monkeypatch):
    _, streaming = _modules()
    orig = streaming.Streamer.process

    def process(self, dry, params, scene=None, facing=0.0, window=None):
        return orig(self, dry, params, scene, facing=0.0, window=window)
    monkeypatch.setattr(streaming.Streamer, "process", process)


def ears_swapped(monkeypatch):
    _, streaming = _modules()
    orig = streaming.Streamer.process
    monkeypatch.setattr(streaming.Streamer, "process",
                        lambda *a, **k: orig(*a, **k).flip(0))


def taps_frozen(monkeypatch):
    """Every tap at its current delay all chunk long: no glide."""
    _, streaming = _modules()
    orig = streaming._tap_chunk
    monkeypatch.setattr(
        streaming, "_tap_chunk",
        lambda w, tau0, tau1, g0, g1, valid, n: orig(w, tau1, tau1, g0, g1,
                                                     valid, n))


def signs_dropped(monkeypatch):
    spatial, _ = _modules()
    monkeypatch.setattr(
        spatial, "_ear_signs_tensor",
        lambda n_t, ear, device: torch.ones(1, n_t, 1, device=device))


def taps_dropped(monkeypatch):
    """The taps' bins leave the convolution, and the taps are not
    played."""
    _, streaming = _modules()
    monkeypatch.setattr(
        streaming, "_tap_chunk",
        lambda w, tau0, tau1, g0, g1, valid, n: torch.zeros(
            tau0.shape[0], n, device=w.device))


FAULTS = [facing_ignored, ears_swapped, taps_frozen, signs_dropped,
          taps_dropped]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_fault_is_not_correct(small, monkeypatch, fault):
    fault(monkeypatch)
    rc, last, err = run_cell(small, CELL)
    assert rc == 0 and last["correct"] is False
    assert last["failed"] > 0 and "FAILED" in err[-1]


def test_the_control_fails_where_sound_runs_pass(small):
    limits = registry.cell(registry.load(small), CELL, small).limits
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert control.main(["--workload", CELL, "--seeds", "21,22",
                             "--control", "2", "--seconds", "0.3"],
                            root=small, card=False) == 0
    for line in out.getvalue().strip().splitlines():
        got = json.loads(line)
        for name, limit in limits.items():
            assert got["lower"][name] <= limit
            assert got["control"][name] > 3 * limit
