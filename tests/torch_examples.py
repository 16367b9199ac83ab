"""Shared helpers of the example twins' CPU tests
(``test_torch_examples_*.py``).

``examples/torch/`` holds one twin of every top-level JAX example
(``examples/*.py`` but ``sweep_mxu_microbench.py``, which is TPU-only),
named as its JAX twin. Each twin runs here in a subprocess with
``--device cpu`` (the plain PyTorch versions of the kernels), one thread
a process, and the tiny arguments of ``tests/test_examples.py::CASES``;
its stdout must hold the substrings pinned in :data:`TWINS`. Each twin's
``setup`` (scenes, materials, poses, aims, dry signals) is held exactly
against the same construction through the JAX package's builders."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch
from test_torch_scene import assert_scene_equal  # noqa: F401
from torch_parity import to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN_DIR = os.path.join(ROOT, "examples", "torch")

# twin -> (tiny arguments, stdout substrings). The arguments are those of
# tests/test_examples.py::CASES plus ADDED_ARGS; the substrings hold the
# JAX twin's pinned ones and the twin's own claim lines.
TWINS = {
    "demo.py": ([], ["traced 8 frames", "localized", "rt60", "bake",
                     "done ->"]),
    "dataset_sweep.py": (["--rooms", "4", "--rays", "256"],
                         ["rooms", "dataset sweep ok"]),
    "quad_mic.py": (["--grid", "2"], ["first arrival", "4-channel"]),
    "speaker_array.py": (["--elements", "4"], ["contrast", "OK"]),
    "spatial_doa.py": (["--rays", "8192", "--frames", "1"],
                       ["bearing", "post-hoc cardioids", "OK"]),
    "occlusion_walkby.py": ([], ["shadow", "OK: shadow filled"]),
    "doppler_walkby.py": (["--rays", "1024", "--chunks", "8"],
                          ["direct shifts up, echo shifts down"]),
    "binaural_walkby.py": (["--rays", "1024", "--chunks", "8"],
                           ["direct shifts up, echo shifts down",
                            "lateralized right"]),
    "live_steering.py": (["--rays", "256"],
                         ["byte-identical", "flushed", "live steering ok"]),
    "inverse_materials.py": (["--steps", "25", "--rays", "128"],
                             ["fitted", "Adam steps"]),
    "locate_source.py": (["--starts", "4", "--steps", "60",
                          "--rays", "128"], ["fitted", "|err|"]),
    "track_source.py": (["--chunks", "8", "--rays", "128",
                         "--track-steps", "40"],
                        ["tracked 8 chunks", "wrote track.png"]),
    # the JAX twin takes no arguments; the twin adds --steps and --grid so
    # that the CPU can run it small (2 x 2 starts, 4 steps)
    "obstacle_pose_negative.py": (["--steps", "4", "--grid", "2"],
                                  ["best", "top3:"]),
}
ADDED_ARGS = {"obstacle_pose_negative.py": ["--steps", "4", "--grid", "2"]}


def load_twin(name: str):
    """The twin ``examples/torch/<name>`` as a module (its ``main`` does
    not run)."""
    spec = importlib.util.spec_from_file_location(
        "twin_" + name[:-3], os.path.join(TWIN_DIR, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_jax_cases():
    """``CASES`` of ``tests/test_examples.py`` (loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_cases", os.path.join(ROOT, "tests", "test_examples.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


def run_twin(name: str, tmp_path):
    """Run a twin on the CPU at its tiny arguments in ``tmp_path``; assert
    exit 0 and its pinned substrings. Returns its stdout."""
    args, claims = TWINS[name]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, os.path.join(TWIN_DIR, name), "--device", "cpu",
         *args], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=600)
    assert proc.returncode == 0, \
        f"{name} exited {proc.returncode}:\n{proc.stdout[-3000:]}"
    low = proc.stdout.lower()
    for claim in claims:
        assert claim.lower() in low, \
            f"{name}: expected {claim!r} in output:\n{proc.stdout[-3000:]}"
    return proc.stdout


def assert_params_equal(port, ref) -> None:
    """Every field of a port ``TraceParams`` equals the JAX one's (None
    where it is None)."""
    for f in port._fields:
        got, want = getattr(port, f), getattr(ref, f)
        assert (got is None) == (want is None), f
        if got is not None:
            np.testing.assert_array_equal(to_numpy(got), np.asarray(want),
                                          err_msg=f)


def assert_config_equal(port, ref) -> None:
    """The port's ``EngineConfig`` equals the JAX one field by field."""
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def assert_array_equal(port, ref) -> None:
    """A tensor or array equals a JAX or numpy array, dtype too."""
    got = to_numpy(port) if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    want = np.asarray(ref)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)
