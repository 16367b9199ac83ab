"""Profiling and metrics (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/utils/profiling.py``: wall-clock
timers around steps, the domain's derived counts (ray-bounce
intersections), a metric log that dumps the JAX package's JSON, and a
device trace around a block (``torch.profiler`` in place of
``jax.profiler``), plus the port's own spans (:func:`span`) at the stage
boundaries of a stream chunk, which show up in that trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

# what span() returns while no profiler records: stateless, so one object
# serves every (nested) use
_NO_SPAN = contextlib.nullcontext()


def _sync(sync) -> None:
    """Wait for the devices of ``sync``: a tensor, a ``torch.device``, or a
    (nested) tuple, list or dict of them. A CPU tensor needs no wait."""
    if isinstance(sync, dict):
        for v in sync.values():
            _sync(v)
    elif isinstance(sync, (tuple, list)):
        for v in sync:
            _sync(v)
    elif isinstance(sync, (torch.Tensor, torch.device)):
        dev = sync.device if isinstance(sync, torch.Tensor) else sync
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def span(name: str):
    """A context manager around one stage of the port's work, named
    ``art.<name>``. While a ``torch.profiler`` session records (for one,
    :func:`device_trace`) it is a host event on the profiler's own
    timeline, the clock of the card's kernels in the same trace. It is not
    a user-scope range (``torch.profiler.record_function``), so the card's
    trace holds no device-side copy of it. With no profiler recording it
    is a shared null context: one flag read, nothing allocated."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast("art." + name)


@dataclass
class Timer:
    """Accumulating wall-clock timer. Device work is asynchronous: pass
    what :meth:`stop` must wait for as ``sync`` (a tensor, its device, or a
    structure of tensors), where JAX's timer blocks until it is ready."""

    total_s: float = 0.0
    count: int = 0
    _t0: float = 0.0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self, sync=None) -> float:
        if sync is not None:
            _sync(sync)
        dt = time.perf_counter() - self._t0
        self.total_s += dt
        self.count += 1
        return dt

    @property
    def mean_s(self) -> float:
        return self.total_s / max(1, self.count)


@contextlib.contextmanager
def timed(label: str, metrics: Optional["Metrics"] = None):
    t = Timer().start()
    yield t
    dt = t.stop()
    if metrics is not None:
        metrics.record(label + "_s", dt)


def ray_bounce_intersections(n_rays: int, max_bounces: int, n_walls: int,
                             nee: bool = True) -> int:
    """Intersection tests per trace frame: the nearest-hit pass is
    rays x bounces x walls; NEE occlusion adds the same again
    (BASELINE.md workload accounting)."""
    per = n_rays * max_bounces * n_walls
    return per * 2 if nee else per


@dataclass
class Metrics:
    """Structured metric log; dumps one JSON object of each metric's mean
    (the JAX package's format)."""

    values: Dict[str, List[float]] = field(default_factory=dict)

    def record(self, name: str, value: float) -> None:
        self.values.setdefault(name, []).append(float(value))

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.values.items() if v}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block, exported as a Chrome trace
    (``trace_<pid>_<ns>.json``, viewable in Perfetto) into ``log_dir``. It
    records the CUDA kernels when the block runs on the card and CUDA is
    available; the host's activity always. Yields the profiler
    (``key_averages()`` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
