"""A run's last line (keys, metrics of the cell, checks last) and the
top-level-name check of the modules a run loaded."""

from __future__ import annotations

import subprocess
import sys
import types

import pytest
import small_tree
from conftest import REPO, run_cell

from benchmark import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


# On the CPU no device activity is profiled: the stream's card time,
# gpu_ms_per_chunk, is left out of the line (the card tests read it).
@pytest.mark.parametrize("cell,metrics", [
    ("shipped_rooms.stream_walk", {"setup_s"}),
    ("shipped_rooms.sweep_1024", {"rooms_per_s", "setup_s"}),
    (small_tree.SHARDED, {"rooms_per_s", "setup_s"}),
])
def test_last_line_of_each_cell(tree, cell, metrics):
    rc, last, err = run_cell(tree, cell)
    assert rc == 0 and last is not None
    assert list(last)[:5] == KEYS and list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    assert set(last["metrics"]) == metrics
    assert all(set(v) == {"value", "unit"} for v in last["metrics"].values())
    assert set(last["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = list(last["checks"])
    assert err[-len(names):] == [
        f"check {n} {last['checks'][n]['value']!r} limit "
        f"{last['checks'][n]['limit']!r} ok" for n in names]


def test_traced_line_has_device_window_and_breakdown(tree):
    rc, last, _ = run_cell(tree, "shipped_rooms.stream_walk", trace=1)
    assert rc == 0 and last["correct"]
    assert {"busy_s", "window_s"} <= set(last["device"])
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(last)[-1] == "checks"
    assert last["metrics"]["host_chunk_ms"]["value"] > 0


def test_forbidden_names_are_compared_whole():
    mods = ["realisticaudioraytracing2d_tpu_torch",
            "realisticaudioraytracing2d_tpu_torch.engine", "jaxtyping",
            "flax_lite", "numpy"]
    assert run.forbidden_loaded(mods) == []
    assert run.forbidden_loaded(mods + ["jax.numpy", "jaxlib.xla_client",
                                        "flax", "realisticaudioraytracing2d"
                                        "_tpu.engine"]) == [
        "flax", "jax", "jaxlib", "realisticaudioraytracing2d_tpu"]


def test_a_run_loads_no_jax(tree):
    """A whole run in a fresh process, then the loaded modules' top-level
    names."""
    code = (
        "import sys, contextlib, io, pathlib\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'benchmark' / 'tests')!r}]\n"
        "from benchmark import run\n"
        "with contextlib.redirect_stdout(io.StringIO()), "
        "contextlib.redirect_stderr(io.StringIO()):\n"
        f"    rc = run.main(['--workload', 'shipped_rooms.stream_walk', "
        f"'--seed', '9', '--seconds', '0.2'], root=pathlib.Path({str(tree)!r}), "
        "card=False)\n"
        "print(rc, run.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stderr[-2000:]


def test_a_loaded_jax_module_stops_the_run(tree, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, last, err = run_cell(tree, "shipped_rooms.stream_walk")
    assert rc != 0 and last is None
    assert any("jax" in line for line in err)


def test_no_card_no_result(tree):
    """On a machine without a card the run stops before any result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, last, err = run_cell(tree, "shipped_rooms.stream_walk", card=True)
    assert rc != 0 and last is None and "CUDA" in err[-1]
