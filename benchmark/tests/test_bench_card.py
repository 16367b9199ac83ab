"""The benchmark on the card (``cuda``: skipped without an NVIDIA GPU):

    python -m pytest benchmark/tests -m cuda -q
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
from conftest import REPO, run_cell

STREAM = "shipped_rooms.stream_walk"


@pytest.mark.cuda
def test_stream_cell_runs_correct_on_the_card(card):
    rc, last, err = run_cell(REPO, STREAM, seconds=1.0, card=True)
    assert rc == 0 and last["correct"], err[-5:]
    assert last["device"]["platform"] == "gpu"
    gpu_ms = last["metrics"]["gpu_ms_per_chunk"]["value"]
    assert 0 < gpu_ms < 1e3 * 0.1           # busy less than a chunk of audio


@pytest.mark.cuda
def test_traced_window_holds_the_per_layer_metrics(card):
    rc, last, err = run_cell(REPO, STREAM, seconds=1.0, trace=1, card=True)
    assert rc == 0 and last["correct"], err[-5:]
    assert {"launches_per_chunk", "fft_device_ms_per_chunk", "k4_roofline",
            "host_chunk_ms"} <= set(last["metrics"])
    assert 0 < last["device"]["busy_s"] <= last["device"]["window_s"]


@pytest.mark.cuda
def test_a_checkout_of_the_benchmark_alone_gives_no_result(card, tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", STREAM, "--seed",
         "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
