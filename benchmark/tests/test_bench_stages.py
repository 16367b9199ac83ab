"""The per-stage readers (``benchmark/stages.py``, ``stage_host_ms.*``,
``stage_launches.*``) on synthetic events of two stream chunks, counted
by hand; their silence where the program records no span; the reduction
of the program's ``art.*`` spans to host events; and a traced run of the
stream cell on the CPU that reports them."""

from __future__ import annotations

import types

import pytest
from conftest import REPO, run_cell

from benchmark import capture, registry, stages

E = capture.Event
METRICS = REPO / "benchmark" / "metrics"
STAGES = ["params", "retrace", "k4_prep", "addenda", "crossfade", "ring"]
NAMES = [f"{kind}.{s}" for kind in ("stage_host_ms", "stage_launches")
         for s in STAGES]


def reader(name):
    return registry.reader(METRICS, name).read


def _chunk(t0, crossfade_launches):
    """One chunk's events from ``t0`` (us): the benchmark's spans, the
    program's nested stage spans, and launch calls in and out of them."""
    def host(name, a, b):
        return E("host", name, -1, t0 + a, t0 + b)

    def launch(t):
        return E("launch", "cudaLaunchKernel", -1, t0 + t, t0 + t + 2)

    return [E("span", "bench.pose", -1, t0, t0 + 100),
            E("span", "bench.step", -1, t0 + 100, t0 + 1000),
            host("art.params", 10, 90), host("aten::copy_", 20, 30),
            host("art.stream.retrace", 110, 400),
            host("art.trace.k4", 120, 390),
            host("art.k4.prep", 130, 200),
            launch(150), launch(250),
            host("art.stream.addenda", 400, 450), launch(420),
            host("art.stream.crossfade", 450, 800),
            *[launch(500 + 50 * i) for i in range(crossfade_launches)],
            host("art.stream.ring", 800, 990), launch(850), launch(900),
            launch(995), launch(1050)]          # in no stage


def _reading(events, steps=2):
    return capture.Reading(events, [0], steps, steps, 0.01, {})


def test_stage_readers_by_hand():
    r = _reading(_chunk(0, 3) + _chunk(2000, 1))
    ms = {s: reader(f"stage_host_ms.{s}")(r) for s in STAGES}
    assert ms == pytest.approx({"params": 80e-3, "retrace": 290e-3,
                                "k4_prep": 70e-3, "addenda": 50e-3,
                                "crossfade": 350e-3, "ring": 190e-3})
    n = {s: reader(f"stage_launches.{s}")(r) for s in STAGES}
    # retrace holds k4_prep's launch; params launches nothing and reads 0
    assert n == {"params": 0.0, "retrace": 2.0, "k4_prep": 1.0,
                 "addenda": 1.0, "crossfade": 2.0, "ring": 2.0}
    # pose and step launch 9 and 7 times, once a chunk outside any stage
    siblings = sum(n[s] for s in STAGES if s != "k4_prep")
    assert siblings == (9 + 7) / 2 - 1


def test_a_launch_at_a_span_edge_counts_and_none_before_it():
    evs = [E("host", "art.stream.ring", -1, 10, 20),
           E("host", "art.stream.ring", -1, 30, 40),
           E("launch", "cudaLaunchKernel", -1, 5, 6),
           E("launch", "cudaLaunchKernel", -1, 20, 21),
           E("launch", "cudaLaunchKernel", -1, 25, 26),
           E("launch", "cudaLaunchKernel", -1, 30, 31)]
    assert stages.launches(_reading(evs, steps=1), "ring") == 2.0


def test_stage_readers_read_nothing_without_the_spans():
    bare = [e for e in _chunk(0, 3) if not e.name.startswith("art.")]
    for r in (_reading(bare), _reading([])):
        for name in NAMES:
            assert reader(name)(r) is None, name
    # a route without K4 leaves its preparation alone silent
    no_k4 = [e for e in _chunk(0, 3) if e.name != "art.k4.prep"]
    assert reader("stage_launches.k4_prep")(_reading(no_k4)) is None
    assert reader("stage_launches.retrace")(_reading(no_k4)) == 1.0


def test_program_spans_are_host_events_of_the_window():
    import torch
    kinds = torch.autograd.DeviceType

    def ev(name, start, end, dev=None):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=start,
                                                        end=end),
            device_type=kinds.CUDA if dev is not None else kinds.CPU,
            device_index=dev)

    prof = types.SimpleNamespace(events=lambda: [
        ev("bench.window", 100, 900), ev("spin_kernel", 90, 95, dev=0),
        ev("bench.step", 120, 800), ev("art.stream.retrace", 130, 400),
        ev("art.trace.k4", 140, 390), ev("art.params", 50, 60),
        ev("cudaLaunchKernel", 150, 160),
        ev("frames_ir_kernel", 200, 300, dev=0),
        ev("spin_kernel", 950, 960, dev=0)])
    got = capture.events(prof, [torch.device("cuda", 0)])
    kind = {e.name: e.kind for e in got}
    assert kind == {"bench.window": "span", "bench.step": "span",
                    "art.stream.retrace": "host", "art.trace.k4": "host",
                    "cudaLaunchKernel": "launch",
                    "frames_ir_kernel": "kernel"}


def test_a_traced_stream_run_reports_the_stage_metrics(tree):
    rc, last, err = run_cell(tree, "shipped_rooms.stream_walk", trace=1)
    assert rc == 0 and last["correct"], err[-5:]
    got = last["metrics"]
    for s in STAGES:
        ms, n = (got.get(f"{kind}.{s}")
                 for kind in ("stage_host_ms", "stage_launches"))
        if s == "k4_prep":      # a CPU scene runs the plain trace, not K4
            assert ms is None and n is None
        else:
            assert ms["value"] > 0 and ms["unit"] == "ms", s
            assert n == {"value": 0.0, "unit": "launches"}, s


@pytest.mark.cuda
def test_the_stage_metrics_on_the_card(card):
    rc, last, err = run_cell(REPO, "shipped_rooms.stream_walk", seconds=1.0,
                             trace=1, card=True)
    assert rc == 0 and last["correct"], err[-5:]
    got = {k: v["value"] for k, v in last["metrics"].items()}
    assert set(NAMES) <= set(got)
    assert got["stage_launches.k4_prep"] <= got["stage_launches.retrace"]
    assert sum(got[f"stage_launches.{s}"] for s in STAGES
               if s != "k4_prep") <= got["launches_per_chunk"]
