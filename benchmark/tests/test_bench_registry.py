"""BENCHMARK.json against the benchmark's contract, and the harness finding
every part by name, including parts added as new files only."""

from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import REPO, run_cell

from benchmark import registry

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).is_file()
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert all(NAME.match(n) for n in names)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_parts(cell):
    c = registry.cell(SPEC, cell, REPO)
    e2e = [m["name"] for m, _ in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    for m, _ in c.per_layer:
        assert m["moves"] in e2e, (m["name"], cell)
    assert hasattr(c.driver, "Driver")


def test_a_config_traffic_and_metric_added_as_files(tree):
    """A new configuration, traffic mix and per-layer metric, added as new
    files and new BENCHMARK.json entries, run without an edit of any file
    that was there."""
    bench = tree / "benchmark"
    shutil.copy(bench / "configs" / "shipped_rooms.json",
                bench / "configs" / "tiny_room.json")
    cfg = json.loads((bench / "configs" / "tiny_room.json").read_text())
    cfg["sim"]["ray_count"] = 32
    (bench / "configs" / "tiny_room.json").write_text(json.dumps(cfg))
    walk = json.loads((bench / "traffic" / "stream_walk.json").read_text())
    walk["speed_m_per_s"] = 3.0
    (bench / "traffic" / "stream_run.json").write_text(json.dumps(walk))
    (bench / "metrics" / "steps_traced.py").write_text(
        "def read(r):\n    return float(r.steps)\n")
    (bench / "limits" / "tiny_room.stream_run.json").write_text(
        json.dumps({"out_gap": 1e-3}))
    spec = json.loads((tree / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_room", "source": "https://x.org",
                            "file": "benchmark/configs/tiny_room.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny_room.stream_run",
                              "config": "tiny_room", "traffic": "stream_run",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "gpu_ms_per_chunk":
            m["workloads"].append("tiny_room.stream_run")
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps",
                              "better": "higher", "source": "device_trace",
                              "layer": "stream driver",
                              "moves": "gpu_ms_per_chunk",
                              "workloads": ["tiny_room.stream_run"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(spec))

    c = registry.cell(spec, "tiny_room.stream_run", tree)
    assert {m["name"] for m, _ in c.end_to_end} == {"gpu_ms_per_chunk",
                                                    "setup_s"}
    rc, last, _ = run_cell(tree, "tiny_room.stream_run")
    assert rc == 0 and last["correct"]
    assert set(last["metrics"]) == {"setup_s"}      # no card: no device time
    rc, last, _ = run_cell(tree, "tiny_room.stream_run", trace=1)
    assert rc == 0 and last["metrics"]["steps_traced"]["value"] >= 1


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        registry.cell(SPEC, "no.such_cell", REPO)
