"""A copy of the benchmark at sizes a CPU test run holds: the same files,
with each configuration and traffic mix cut to a few rays, bins and
rooms, and one cell more, ``SHARDED``: the sweep driver's mesh path over
four devices, which no cell of ``BENCHMARK.json`` drives. ``make(tmp)``
returns the copy's root."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SIM = {"ray_count": 64, "max_bounces": 3}
AUDIO = {"sample_rate": 4800, "reverb_duration": 0.5, "chunk_duration": 0.1}
CONFIGS = {
    "shipped_rooms": {"sim": SIM, "audio": AUDIO,
                      "room_batch": {"n_obstacles": 3, "frames_per_room": 2}},
}
TRAFFIC = {
    "stream_walk": {"dry_chunks": 6, "warm_chunks": 2, "trace_steps": 5},
    "sweep_1024": {"rooms": 8, "warm_calls": 1, "trace_steps": 2},
}
SHARDED = "shipped_rooms.sweep_sharded"
SHARDED_TRAFFIC = {"driver": "sweep", "rooms": 8, "pool": 1,
                   "warm_calls": 1, "compare": 1, "compare_rooms": 4,
                   "trace_steps": 2}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and \
            isinstance(base.get(k), dict) else v
    return out


def _rewrite(path: Path, over: dict) -> None:
    path.write_text(json.dumps(_merge(json.loads(path.read_text()), over)))


def make(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, over in CONFIGS.items():
        _rewrite(root / "benchmark" / "configs" / f"{name}.json", over)
    for name, over in TRAFFIC.items():
        _rewrite(root / "benchmark" / "traffic" / f"{name}.json", over)
    bench = root / "benchmark"
    (bench / "traffic" / "sweep_sharded.json").write_text(
        json.dumps(SHARDED_TRAFFIC))
    (bench / "limits" / f"{SHARDED}.json").write_text(
        json.dumps({"ir_gap": 1e-3}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": SHARDED, "config": "shipped_rooms",
                              "traffic": "sweep_sharded", "chips": 4,
                              "why": "the sweep over a mesh of four"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "shipped_rooms.sweep_1024" in m.get("workloads", []):
            m["workloads"].append(SHARDED)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
