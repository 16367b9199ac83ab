"""Runs of each cell with the timed path broken underneath, on the CPU at
small sizes, past the harness's look for a card: ``correct`` has to come
out false for every fault the cell can have (a step that leaves its state
unchanged, half of the rays left out and the rest counted twice, the
exchange between cards left out, an answer altered where it is made),
and the control (the reference in bfloat16 in the program's place) has
to fail the limits that sound runs pass."""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch
from conftest import run_cell
from small_tree import SHARDED

from benchmark import control

STREAM = "shipped_rooms.stream_walk"
SWEEP = "shipped_rooms.sweep_1024"


def _modules():
    from realisticaudioraytracing2d_tpu_torch import engine, streaming
    from realisticaudioraytracing2d_tpu_torch.parallel import sweep
    return engine, streaming, sweep


def stale(monkeypatch, cell):
    """Every step after the first returns the first step's answer: the
    state never moves on."""
    engine, streaming, sweep = _modules()
    if cell == STREAM:
        owner, name = streaming.Streamer, "process"
    else:
        owner, name = sweep, ("sweep_rooms_sharded" if cell == SHARDED
                              else "sweep_rooms")
    orig, first = getattr(owner, name), []

    def frozen(*a, **k):
        if not first:
            first.append(orig(*a, **k))
        return first[0].clone()
    monkeypatch.setattr(owner, name, frozen)


def half(monkeypatch, cell):
    """Half of the rays traced, their IR counted twice (the mean over the
    rest)."""
    engine, _, sweep = _modules()
    owner, name = (sweep, "trace_batch") if cell in (SWEEP, SHARDED) \
        else (engine, "trace_ir")
    orig = getattr(owner, name)

    def halved(*a, **k):
        k["n_rays"] = k["n_rays"] // 2
        return orig(*a, **k) * 2.0
    monkeypatch.setattr(owner, name, halved)


def altered(monkeypatch, cell):
    """Each IR 5% too loud where the trace makes it."""
    engine, _, sweep = _modules()
    owner, name = (sweep, "trace_batch") if cell in (SWEEP, SHARDED) \
        else (engine, "trace_ir")
    orig = getattr(owner, name)
    monkeypatch.setattr(owner, name, lambda *a, **k: orig(*a, **k) * 1.05)


def no_exchange(monkeypatch, cell):
    """The gather keeps the first card's shard in every card's place."""
    _, _, sweep = _modules()
    monkeypatch.setattr(sweep, "gather",
                        lambda mesh, parts: torch.cat([parts[0]] * len(parts)))


FAULTS = [(c, f) for c in (STREAM, SWEEP, SHARDED)
          for f in (stale, half, altered)] + [(SHARDED, no_exchange)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_step_is_not_correct(tree, monkeypatch, cell, fault):
    rc, last, _ = run_cell(tree, cell, seconds=0.3)
    assert rc == 0 and last["correct"] is True
    fault(monkeypatch, cell)
    rc, last, err = run_cell(tree, cell, seconds=0.3)
    assert rc == 0 and last["correct"] is False
    assert last["failed"] > 0 and "FAILED" in err[-1]


@pytest.mark.parametrize("cell", [STREAM, SWEEP, SHARDED])
def test_the_control_fails_where_sound_runs_pass(tree, cell):
    from benchmark import registry
    limits = registry.cell(registry.load(tree), cell, tree).limits
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert control.main(["--workload", cell, "--seeds", "21,22",
                             "--control", "2", "--seconds", "0.3"],
                            root=tree, card=False) == 0
    for line in out.getvalue().strip().splitlines():
        got = json.loads(line)
        for name, limit in limits.items():
            assert got["lower"][name] <= limit
            assert got["control"][name] > 3 * limit
