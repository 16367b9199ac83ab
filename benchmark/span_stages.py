"""Per-stage numbers of a stream chunk from the program's own spans, keyed
by the span's name: :mod:`benchmark.stages`' two readings for spans that
its ``SPANS`` does not list (the binaural decode and the four stages of
per-arrival Doppler). Each is read per chunk of the traced window:

* :func:`host_ms`: the summed length of the span's occurrences (inclusive
  of the spans inside them), in host milliseconds under the profiler's
  CPU activity;
* :func:`launches`: the host's launch calls that start inside one of
  them.

A span that is not in the window reads None (a program without it, or a
route that does not run its stage)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from benchmark.capture import Event, Reading


def spans(r: Reading, name: str) -> List[Event]:
    """The window's occurrences of span ``name``, by start."""
    return sorted((e for e in r.events if e.kind == "host" and e.name == name),
                  key=lambda e: e.start)


def host_ms(r: Reading, name: str) -> Optional[float]:
    """Host milliseconds inside span ``name`` per chunk."""
    s = spans(r, name)
    if not s or r.steps == 0:
        return None
    return 1e3 * sum(e.seconds for e in s) / r.steps


def launches(r: Reading, name: str) -> Optional[float]:
    """Launch calls that start inside span ``name`` per chunk (0 where it
    launches nothing). The occurrences of one span never overlap one
    another, so each launch is looked up in the one that starts last
    before it."""
    s = spans(r, name)
    if not s or r.steps == 0:
        return None
    starts = np.array([e.start for e in s])
    ends = np.array([e.end for e in s])
    t = np.array([e.start for e in r.events if e.kind == "launch"])
    i = np.searchsorted(starts, t, side="right") - 1
    inside = (i >= 0) & (t <= ends[np.maximum(i, 0)])
    return int(inside.sum()) / r.steps
