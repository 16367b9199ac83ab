"""Fixtures of the benchmark's tests. They run on the CPU at the sizes of
``small_tree``; the tests marked ``cuda`` need an NVIDIA GPU and skip
elsewhere, decided inside a fixture."""

from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import small_tree  # noqa: E402


@pytest.fixture
def tree(tmp_path) -> Path:
    """A small copy of the benchmark (``small_tree.make``)."""
    return small_tree.make(tmp_path)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def run_cell(root: Path, cell: str, seed: int = 2 ** 31 + 7,
             seconds: float = 0.3, trace: int = 0, card: bool = False):
    """``benchmark/run.py`` on a cell: ``(exit code, last stdout line as
    JSON or None, stderr lines)``."""
    from benchmark import run
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], root=root,
                      card=card)
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return rc, last, err.getvalue().strip().splitlines()
