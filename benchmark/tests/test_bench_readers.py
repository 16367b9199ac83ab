"""The per-layer readers on synthetic profiler events, the roofline's
arithmetic against hand counts, and the reduction of a profiler's
events to the window's."""

from __future__ import annotations

import types

import pytest
from conftest import REPO

from benchmark import capture, registry, roofline
from benchmark.reference.physics import Work

E = capture.Event
METRICS = REPO / "benchmark" / "metrics"


def reader(name):
    return registry.reader(METRICS, name).read


def reading(events, steps=2, window_s=0.01, shapes=None, work=None,
            devices=(0,)):
    return capture.Reading(events, list(devices), steps, steps, window_s,
                           shapes or {}, work)


STREAM_EVENTS = [
    E("launch", "cudaLaunchKernel", -1, 0, 1),
    E("launch", "cuLaunchKernel", -1, 2, 3),
    E("launch", "cudaLaunchKernel", -1, 4, 5),
    E("kernel", "void frames_ir_kernel<false, false, 1, 4>(...)", 0, 10, 35),
    E("kernel", "void regular_fft_factor<256u>(...)", 0, 40, 50),
    E("kernel", "void postprocess_kernel<float>(...)", 0, 50, 52),
    E("kernel", "vector_fft<...>", 0, 60, 66),
    E("memcpy", "Memcpy DtoH (Device -> Pageable)", 0, 66, 70),
    E("span", "bench.step", -1, 0, 9000),
]


def test_launches_fft_and_idle_share():
    r = reading(STREAM_EVENTS)
    assert reader("launches_per_chunk")(r) == 1.5
    assert reader("fft_device_ms_per_chunk")(r) == pytest.approx(
        (10 + 6) / 1e3 / 2)
    # busy: [10, 35], [40, 52], [60, 70] = 47 us of 10 ms
    assert r.busy_s() == pytest.approx(47e-6)
    for tag in ("stream", "sweep"):
        assert reader(f"device_idle_share.{tag}")(r) == pytest.approx(
            100 * (1 - 47e-6 / 0.01))


def test_copies_and_busy_time_over_cards():
    evs = [E("kernel", "void frames_ir_kernel<true, false, 1, 4>(...)", 0,
             0, 1700),
           E("kernel", "void frames_ir_kernel<true, false, 1, 4>(...)", 1,
             0, 1600),
           E("memcpy", "Memcpy DtoH (Device -> Pageable)", 0, 2000, 9000),
           E("memcpy", "Memcpy PtoP (Device -> Device)", 1, 2000, 3000)]
    r = reading(evs, steps=1, devices=(0, 1))
    assert reader("copy_ms_per_call")(r) == pytest.approx(8.0)
    # card 0: [0, 1700], [2000, 9000]; card 1: [0, 1600], [2000, 3000]
    assert r.busy_s() == pytest.approx(((1700 + 7000) + 2600) / 2 / 1e6)


def test_readers_find_nothing_in_an_empty_window():
    r = reading([E("span", "bench.step", -1, 0, 10)], devices=())
    for name in ("launches_per_chunk", "fft_device_ms_per_chunk",
                 "k4_roofline", "k9_roofline", "copy_ms_per_call",
                 "device_idle_share.stream", "device_idle_share.sweep",
                 "host_chunk_ms"):
        assert reader(name)(r) is None, name
    window = capture.Window([capture.Step(0.0, 1.0, 4)], 9.0)
    assert registry.reader(E2E, "gpu_ms_per_chunk").read(window) is None


E2E = REPO / "benchmark" / "end_to_end"


def test_card_time_and_host_time_per_chunk():
    steps = [capture.Step(0.0, 0.5, 1), capture.Step(0.5, 2.0, 3)]
    window = capture.Window(steps, 9.0, device_s=0.06)
    assert registry.reader(E2E, "gpu_ms_per_chunk").read(window) == \
        pytest.approx(1e3 * 0.06 / 4)
    r = reading(STREAM_EVENTS)._replace(host=window)
    assert reader("host_chunk_ms")(r) == pytest.approx(1e3 * 2.0 / 4)


def _kineto(name, dev, start, length, note=False):
    import torch
    kind = torch.autograd.DeviceType.CUDA if dev >= 0 else \
        torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: kind,
        device_index=lambda: dev, start_ns=lambda: start,
        duration_ns=lambda: length, is_user_annotation=lambda: note)


def test_device_seconds_of_a_profiled_window():
    import torch
    evs = [_kineto("frames_ir_kernel<false>", 0, 0, 1000),
           _kineto("vector_fft", 0, 500, 1000),             # overlaps
           _kineto("Memcpy DtoH (Device -> Pageable)", 0, 3000, 500),
           _kineto("bench.step", 0, 0, 9000, note=True),    # an annotation
           _kineto("cudaLaunchKernel", -1, 0, 9000),        # on the host
           _kineto("frames_ir_kernel<false>", 1, 0, 2000)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    # card 0: [0, 1500] and [3000, 3500]; card 1: [0, 2000]
    assert capture._device_seconds(prof, cards, {"frames_ir_kernel": 2}) \
        == pytest.approx((2000 + 2000) / 2 / 1e9)
    with pytest.raises(RuntimeError, match="lost launches"):
        capture._device_seconds(prof, cards, {"frames_ir_kernel": 3})


SMOLL = dict(n_rays=15000, n_bounces=5, n_frames=1, n_entries=1,
             n_listeners=1, n_bands=1, n_walls=20, ir_length=72000)
SWEEP = dict(SMOLL, n_frames=8, n_entries=1024, n_walls=28)


def test_roofline_by_hand_smoll_room():
    work = Work(alive=75000, heard=35000)
    ops = 13 * 20 * (75000 + 35000)                 # 28.6 M operations
    nbytes = 4 * (20 * 10 + 2 + 2 + 72000)          # walls, source, IR
    least, bound = roofline.least_seconds(SMOLL, work)
    assert bound == "operations" and least == pytest.approx(ops / 67e12)
    assert nbytes / 3.35e12 < least
    evs = [E("kernel", "frames_ir_kernel<false, false, 1, 4>", 0, 0, 25),
           E("kernel", "frames_ir_kernel<false, false, 1, 4>", 0, 30, 55)]
    share = reader("k4_roofline")(reading(evs, steps=2, shapes=SMOLL,
                                          work=work))
    assert share == pytest.approx(100 * ops / 67e12 / 25e-6)


def test_roofline_by_hand_sweep():
    work = Work(alive=6.0e8, heard=3.0e8)
    least, bound = roofline.least_seconds(SWEEP, work)
    assert bound == "operations"
    assert least == pytest.approx(13 * 28 * 9.0e8 / 67e12)   # 4.89 ms
    evs = [E("kernel", "frames_ir_kernel<false, false, 1, 1>", 0, 0,
             53500)]
    share = reader("k9_roofline")(reading(evs, steps=1, shapes=SWEEP,
                                          work=work))
    assert share == pytest.approx(100 * least / 0.0535)
    # bytes bind where the walls are few and the IR long
    few = dict(SWEEP, n_walls=1)
    assert roofline.least_seconds(few, Work(10, 0))[1] == "bytes"


def test_events_keep_what_lies_between_markers():
    import torch
    kinds = torch.autograd.DeviceType

    def ev(name, start, end, dev=None):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=start,
                                                        end=end),
            device_type=kinds.CUDA if dev is not None else kinds.CPU,
            device_index=dev)

    prof = types.SimpleNamespace(events=lambda: [
        ev("bench.window", 100, 900),
        ev("cudaLaunchKernel", 50, 60), ev("cudaLaunchKernel", 150, 160),
        ev("bench.step", 120, 800), ev("bench.step", 120, 800, dev=0),
        ev("spin_kernel", 90, 95, dev=0), ev("k_before", 60, 80, dev=0),
        ev("k_in", 200, 300, dev=0), ev("Memcpy DtoH", 300, 350, dev=0),
        ev("spin_kernel", 950, 960, dev=0), ev("k_after", 970, 990, dev=0)])
    got = capture.events(prof, [torch.device("cuda", 0)])
    assert sorted(e.name for e in got) == sorted(
        ["bench.window", "cudaLaunchKernel", "bench.step", "k_in",
         "Memcpy DtoH"])
    assert {e.kind for e in got if e.name == "Memcpy DtoH"} == {"memcpy"}
    assert {e.kind for e in got if e.name == "k_in"} == {"kernel"}


def test_breakdown_labels_gaps_by_host_work():
    evs = [E("kernel", "a", 0, 0, 10), E("kernel", "b", 0, 30, 40),
           E("kernel", "a", 0, 100, 110),
           E("span", "bench.step", -1, 0, 60),
           E("span", "bench.readback", -1, 60, 200),
           E("host", "cudaMemcpyAsync", -1, 61, 190)]
    b = capture.breakdown(reading(evs, steps=1))
    assert b["device_ops"][0] == ["a", pytest.approx(20e-6)]
    assert b["idle_gaps"] == [
        ["bench.readback / cudaMemcpyAsync", pytest.approx(60e-6)],
        ["bench.step / python", pytest.approx(20e-6)]]
