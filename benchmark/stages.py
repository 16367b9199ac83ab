"""Per-stage numbers of a stream chunk from the program's own spans: the
``art.*`` host events the port records at its stage boundaries while a
profiler runs, which :func:`benchmark.capture.events` keeps as kind
``host``. Each stage is read per chunk of the traced window:

* :func:`host_ms`: the summed length of the stage's spans (inclusive of
  the spans inside them), in host milliseconds under the profiler's CPU
  activity, which costs time of its own: the stages sum above the
  untraced ``host_chunk_ms``;
* :func:`launches`: the host's launch calls that start inside one of the
  stage's spans.

A stage whose span is not in the window reads None (a program without the
spans, or a route that does not run the stage)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from benchmark.capture import Event, Reading

# the metrics' stage names and the spans they read
SPANS = {
    "params": "art.params",
    "retrace": "art.stream.retrace",
    "k4_prep": "art.k4.prep",
    "addenda": "art.stream.addenda",
    "crossfade": "art.stream.crossfade",
    "ring": "art.stream.ring",
}


def spans(r: Reading, stage: str) -> List[Event]:
    """The window's spans of ``stage`` (``SPANS``), by start."""
    name = SPANS[stage]
    return sorted((e for e in r.events if e.kind == "host" and e.name == name),
                  key=lambda e: e.start)


def host_ms(r: Reading, stage: str) -> Optional[float]:
    """Host milliseconds inside the stage's spans per chunk."""
    s = spans(r, stage)
    if not s or r.steps == 0:
        return None
    return 1e3 * sum(e.seconds for e in s) / r.steps


def launches(r: Reading, stage: str) -> Optional[float]:
    """Launch calls that start inside the stage's spans per chunk (0 where
    the stage launches nothing). A stage's spans never overlap one
    another, so each launch is looked up in the one span that starts last
    before it."""
    s = spans(r, stage)
    if not s or r.steps == 0:
        return None
    starts = np.array([e.start for e in s])
    ends = np.array([e.end for e in s])
    t = np.array([e.start for e in r.events if e.kind == "launch"])
    i = np.searchsorted(starts, t, side="right") - 1
    inside = (i >= 0) & (t <= ends[np.maximum(i, 0)])
    return int(inside.sum()) / r.steps
