"""The measured window, and the traced window with its reduction to events.

:func:`timed` runs closed-loop steps until ``seconds`` have passed and
records each step's host-clock start, end and units; given the cards, it
runs under ``torch.profiler`` with device activity alone and records the
seconds in which something ran on them. :func:`traced` runs
steps under ``torch.profiler`` (host and device activity) between two
markers on each card (``torch.cuda._sleep``'s spin kernel), with one
untraced step before the first marker and one after the second, as the
program's own smoke does: only what lies between the markers counts. A
reading that lost a launch the driver says a step makes is dropped and
taken again (the profiler now and then misses a launch).

:class:`Reading` is what the per-layer readers read: the window's events
(device kernels, copies and fills by card; the host's launch calls and
the benchmark's ``bench.*`` spans), its length, the steps and units in it,
the driver's shapes, the work the reference counted and, where a cell
reads the host's clock per layer, an untraced window timed before it.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from benchmark import harness

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
MARKER = "spin_kernel"
TRIES = 5


class Step(NamedTuple):
    t0: float
    t1: float
    units: int


class Window(NamedTuple):
    """``device_s``: the seconds in which something ran on the cards over
    the window (the mean over the cards), where it was profiled."""

    steps: List[Step]
    setup_s: float
    device_s: Optional[float] = None

    @property
    def seconds(self) -> float:
        return self.steps[-1].t1 - self.steps[0].t0

    @property
    def units(self) -> int:
        return sum(s.units for s in self.steps)


class Event(NamedTuple):
    """``kind``: ``kernel``, ``memcpy``, ``memset`` (on card ``device``),
    ``launch`` (a host launch call), ``span`` (a ``bench.*`` span) or
    ``host`` (any other host event); times in microseconds."""

    kind: str
    name: str
    device: int
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6


class Reading(NamedTuple):
    events: List[Event]
    devices: List[int]
    steps: int
    units: int
    window_s: float
    shapes: Dict
    work: Optional[object] = None
    host: Optional[Window] = None

    def device_events(self, kinds=("kernel", "memcpy", "memset")):
        return [e for e in self.events if e.kind in kinds]

    def kernel_seconds(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(e.seconds for e in self.events
                   if e.kind == "kernel" and match(e.name))

    def busy_s(self) -> float:
        """Seconds in which something ran on a card, the mean over the
        cards: the union of each card's kernel, copy and fill intervals."""
        return _busy_s([(e.device, e.start, e.end)
                        for e in self.device_events()], self.devices) / 1e6


def _busy_s(intervals, devices) -> float:
    """The mean over ``devices`` of the length of the union of each one's
    ``(device, start, end)`` intervals."""
    per = []
    for d in devices:
        spans = sorted((a, b) for dd, a, b in intervals if dd == d)
        per.append(sum(b - a for a, b in _union(spans)))
    return sum(per) / len(per) if per else 0.0


def _union(spans):
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def timed(drv, seconds: float, setup_s: float, sample,
          devices=None) -> Window:
    """Closed-loop steps for ``seconds`` of host clock; with ``devices``
    (cards), under the profiler's device activity, whose busy seconds the
    window then carries (:func:`_device_seconds`)."""
    if not devices:
        return _timed(drv, seconds, setup_s, sample)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window = _timed(drv, seconds, setup_s, sample)
        harness.sync(devices)
    return window._replace(device_s=_device_seconds(
        prof, devices, {k: n * len(window.steps)
                        for k, n in drv.launches().items()}))


def _device_seconds(prof, devices, want) -> float:
    """Busy seconds of the profiled cards, from the profiler's raw device
    events; refused where the kernels ``want`` names (launches in the
    window) lost more than 1% of their launches."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ids = sorted({d.index or 0 for d in devices})
    spans, seen = [], dict.fromkeys(want, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        start = e.start_ns()
        spans.append((e.device_index(), start, start + e.duration_ns()))
        for k in seen:
            seen[k] += k in e.name()
    if any(seen[k] < 0.99 * n for k, n in want.items()):
        raise RuntimeError(f"the profiled window lost launches: want {want}, "
                           f"seen {seen}")
    return _busy_s(spans, ids) / 1e9


def _timed(drv, seconds: float, setup_s: float, sample) -> Window:
    steps = []
    sample.active = True
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t0 = time.perf_counter()
        units = drv.step()
        t1 = time.perf_counter()
        steps.append(Step(t0, t1, units))
        if t1 >= deadline:
            break
    sample.active = False
    return Window(steps, setup_s)


def _marker(devices) -> None:
    import torch
    for d in devices:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda._sleep(1000)


def traced(drv, seconds: float, max_steps: int, setup_s: float, sample,
           devices):
    """Steps under the profiler, at most ``max_steps`` and ``seconds``;
    returns the window and its events (:func:`events`), retaken while a
    kernel misses the launches ``drv.launches()`` names per step."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    seen = []
    for _ in range(TRIES):
        steps = []
        with profile(activities=acts) as prof:
            drv.step()
            harness.sync(devices)
            _marker(devices)
            sample.active = True
            with harness.span("window"):
                start = time.perf_counter()
                while len(steps) < max_steps and \
                        time.perf_counter() - start < seconds:
                    t0 = time.perf_counter()
                    units = drv.step()
                    steps.append(Step(t0, time.perf_counter(), units))
                harness.sync(devices)
            sample.active = False
            _marker(devices)
            drv.step()
            harness.sync(devices)
        evs = events(prof, devices)
        counts = {k: sum(1 for e in evs if e.kind == "kernel" and k in e.name)
                  for k in drv.launches()}
        want = {k: n * len(steps) for k, n in drv.launches().items()}
        if not any(d.type == "cuda" for d in devices) or counts == want:
            return Window(steps, setup_s), evs
        seen.append(counts)
    raise RuntimeError(f"no traced window held the launches {want}; "
                       f"seen {seen}")


def events(prof, devices) -> List[Event]:
    """The profiler's events inside the window: device events between each
    card's two markers, host events inside the ``bench.window`` span."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev_ev, host_ev = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if e.name.startswith("bench."):     # a span's device echo
                continue
            low = e.name.lower()
            kind = "memcpy" if low.startswith("memcpy") else \
                "memset" if low.startswith("memset") else "kernel"
            dev_ev.append(Event(kind, e.name, int(e.device_index), start,
                                end))
        elif e.name in LAUNCH_CALLS:
            host_ev.append(Event("launch", e.name, -1, start, end))
        elif e.name.startswith("bench."):
            host_ev.append(Event("span", e.name, -1, start, end))
        else:
            host_ev.append(Event("host", e.name, -1, start, end))
    windows = [e for e in host_ev if e.name == "bench.window"]
    out = []
    if windows:
        w = windows[0]
        out += [e for e in host_ev
                if w.start <= e.start and e.end <= w.end]
    for d in {d.index or 0 for d in devices if d.type == "cuda"}:
        marks = sorted(e.start for e in dev_ev
                       if e.device == d and MARKER in e.name)
        if len(marks) != 2:
            continue
        out += [e for e in dev_ev if e.device == d
                and marks[0] < e.start < marks[1] and MARKER not in e.name]
    return out


def reading(window: Window, evs: List[Event], devices, shapes, work,
            host: Optional[Window] = None) -> Reading:
    spans = [e for e in evs if e.name == "bench.window"]
    window_s = spans[0].seconds if spans else window.seconds
    return Reading(evs, sorted({d.index or 0 for d in devices
                                if d.type == "cuda"}),
                   len(window.steps), window.units, window_s, shapes, work,
                   host)


def breakdown(r: Reading, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps (summed by what the host was doing in their middle: the
    innermost ``bench.*`` span and the host call then running)."""
    ops: Dict[str, float] = {}
    for e in r.device_events():
        ops[e.name[:160]] = ops.get(e.name[:160], 0.0) + e.seconds
    gaps: Dict[str, float] = {}
    host = [e for e in r.events if e.device < 0 and e.name != "bench.window"]
    start = np.array([e.start for e in host])
    end = np.array([e.end for e in host])
    length = end - start
    is_span = np.array([e.kind == "span" for e in host], bool)
    for d in r.devices:
        busy = _union(sorted((e.start, e.end) for e in r.device_events()
                             if e.device == d))
        for (_, a), (b, _) in zip(busy, busy[1:]):
            label = _label(host, start, end, length, is_span, (a + b) / 2)
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    by = lambda kv: -kv[1]  # noqa: E731
    return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=by)
                           [:top]],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=by)
                          [:top]]}


def _label(host, start, end, length, is_span, t) -> str:
    """The innermost ``bench.*`` span and host call running at ``t``."""
    names = []
    for spans, default in ((is_span, "between steps"), (~is_span, "python")):
        on = np.flatnonzero(spans & (start <= t) & (t <= end))
        names.append(host[on[np.argmin(length[on])]].name if on.size
                     else default)
    return " / ".join(names)
