"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

* ``workloads[].config`` names a ``configs[]`` entry, whose ``file`` holds
  the configuration as it is run (sizes, scene, source);
* ``workloads[].traffic`` names ``benchmark/traffic/<traffic>.json``, the
  traffic's parameters, whose ``driver`` names the general generator
  ``benchmark/drivers/<driver>.py``;
* ``benchmark/limits/<cell>.json`` holds the limit of each number the
  cell's comparison gives;
* an end-to-end metric is read by ``benchmark/end_to_end/<name>.py``, a
  per-layer metric by ``benchmark/metrics/<name>.py``: each a ``read``
  function. Where no file has the whole name, the part of the name
  before its first dot names it, so ``device_idle_share.stream`` and
  ``device_idle_share.sweep`` share ``device_idle_share.py``. A metric
  with a ``workloads`` list belongs to those cells only; one without
  belongs to every cell.

So a configuration, a traffic mix or a metric is added as new files and
new entries, and no file already there changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple, Tuple


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict
    traffic: Dict
    driver: ModuleType
    limits: Dict[str, float]
    end_to_end: List[Tuple[Dict, ModuleType]]
    per_layer: List[Tuple[Dict, ModuleType]]


def load(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def module(path: Path) -> ModuleType:
    """The Python file at ``path``, loaded by its path (a metric's name may
    hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: no file {path}")
    name = "benchmark_part_" + hashlib.sha1(
        str(path).encode()).hexdigest()[:12]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(folder: Path, name: str) -> ModuleType:
    """The reader of metric ``name`` in ``folder``: ``<name>.py``, else
    the file of the part of the name before its first dot."""
    whole = folder / f"{name}.py"
    return module(whole if whole.is_file()
                  else folder / f"{name.split('.')[0]}.py")


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(spec: Dict, name: str, root: Path) -> Cell:
    bench = root / "benchmark"
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"benchmark: no workload {name!r}; known: "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{name}.json").read_text())
    return Cell(
        name, int(w["chips"]), config, traffic,
        module(bench / "drivers" / f"{traffic['driver']}.py"), limits,
        [(m, reader(bench / "end_to_end", m["name"]))
         for m in spec["end_to_end"] if applies(m, name)],
        [(m, reader(bench / "metrics", m["name"]))
         for m in spec["per_layer"] if applies(m, name)])
