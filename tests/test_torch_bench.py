"""PyTorch port: ``realisticaudioraytracing2d_tpu_torch/bench.py``, the JAX
bench suite (``bench.py`` at the root) measured through the port, on the
CPU at small sizes (the JAX sizes take hours on the plain versions).

* every function runs at a few hundred rays, 2 bounces, 2 frames or
  chunks, 8 rooms and small cities (one past 5,280 walls, the K8 route's
  size on the card) and returns finite positive numbers; the stream
  functions take a small ``smoll_room_config`` by monkeypatching;
* each function's parameters and defaults are the JAX function's, read
  with ``ast`` from the root ``bench.py`` (importing it would set the
  process's JAX compile-cache directory), plus ``device``;
* the counted work is JAX's: SmollRoom padded to 32 walls has JAX's
  valid walls, each city JAX's wall count, and the rates the port
  returns times its own times give JAX's formulas on JAX's scenes,
  exactly;
* ``cli bench --device cpu`` reaches ``bench.main`` and prints, as its
  last stdout line, one JSON object with the keys and constants of the
  JAX bench's last line and its 4-significant-figure rounding.
"""

import ast
import dataclasses
import inspect
import json
import math
import os

import pytest
from torch_parity import CPU

from realisticaudioraytracing2d_tpu_torch import bench, cli
from realisticaudioraytracing2d_tpu_torch.config import smoll_room_config

JAX_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")
FUNCTIONS = ("bench_trace", "bench_quad", "bench_ir_build",
             "bench_streaming_xrt", "bench_sweep", "bench_stream_chunk",
             "bench_stream_chunk_modes", "bench_accel", "main")


def jax_bench_tree():
    with open(JAX_BENCH) as f:
        return ast.parse(f.read())


def jax_signatures():
    """``{name: [(parameter, default), ...]}`` of the JAX bench's
    functions, defaults as literals."""
    out = {}
    for node in jax_bench_tree().body:
        if isinstance(node, ast.FunctionDef):
            a = node.args
            defaults = [None] * (len(a.args) - len(a.defaults)) + [
                ast.literal_eval(d) for d in a.defaults]
            out[node.name] = [(p.arg, d) for p, d in zip(a.args, defaults)]
    return out


def small_config():
    cfg = smoll_room_config(ray_count=192)
    return dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, max_bounces=2))


def positive(*xs):
    return all(math.isfinite(x) and x > 0 for x in xs)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_defaults_are_jax(name):
    want = jax_signatures()[name]
    params = inspect.signature(getattr(bench, name)).parameters.values()
    got = [(p.name, None if p.default is p.empty else p.default)
           for p in params]
    assert got == want + [("device", None)]


SMALL = {
    "bench_trace": dict(n_rays=256, max_bounces=2, n_frames=2),
    "bench_quad": dict(n_frames=1),
    "bench_ir_build": dict(n_frames=2),
    "bench_streaming_xrt": dict(n_chunks=2),
    "bench_sweep": dict(n_rooms=8, n_rays=256, max_bounces=2,
                        ir_length=2400),
    "bench_stream_chunk": dict(n_chunks=2),
    "bench_stream_chunk_modes": dict(n_chunks=2),
    "bench_accel": dict(n_boxes=40, n_rays=256, max_bounces=2)}


@pytest.mark.parametrize("name, kw", [
    *SMALL.items(),
    # 5,288 walls: past the 5,280 of K4's shared memory, where the card
    # routes to K8 (here its plain version)
    ("bench_accel", dict(n_boxes=1321, n_rays=96, max_bounces=2))])
def test_each_function_runs_small(name, kw, monkeypatch):
    monkeypatch.setattr(bench, "smoll_room_config", small_config)
    out = getattr(bench, name)(**kw, device=CPU)
    out = out if isinstance(out, tuple) else (out,)
    assert positive(*out), out


def test_counts_are_jax():
    from realisticaudioraytracing2d_tpu.models import rooms as jrooms
    from realisticaudioraytracing2d_tpu_torch.models import rooms

    n_valid = int(jrooms.smoll_room(pad_to=32).scene.n_valid)
    assert int(rooms.smoll_room(pad_to=32, device=CPU).scene.n_valid) \
        == n_valid == 20
    for n_boxes in (40, 10000):
        assert rooms.city_scene(n_boxes, device=CPU).scene.n_walls \
            == jrooms.city_scene(n_boxes).scene.n_walls
    assert rooms.city_scene(10000, device=CPU).scene.n_walls == 40008

    # the port's rate x its time = JAX's formula on JAX's scene
    kw = SMALL["bench_trace"]
    rate, frame_ms = bench.bench_trace(**kw, device=CPU)
    tests = kw["n_rays"] * kw["max_bounces"] * n_valid * 2 * kw["n_frames"]
    assert rate * frame_ms * kw["n_frames"] / 1e3 == pytest.approx(
        tests, rel=1e-9)
    kw = SMALL["bench_accel"]
    ms, gts, speedup, walls = bench.bench_accel(**kw, device=CPU)
    jax_walls = jrooms.city_scene(kw["n_boxes"]).scene.n_walls
    assert walls == jax_walls
    assert gts * 1e9 * ms / 1e3 == pytest.approx(
        kw["n_rays"] * kw["max_bounces"] * 2 * jax_walls * 4, rel=1e-9)


def jax_result_line():
    """The keys of the dict ``main`` prints and its constant values."""
    main = next(n for n in jax_bench_tree().body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    result = next(n.value for n in ast.walk(main)
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "result")
    return {k.value: (v.value if isinstance(v, ast.Constant) else None)
            for k, v in zip(result.keys, result.values)}


def test_cli_bench_prints_jax_line(monkeypatch, capsys):
    rates = []
    for name, kw in SMALL.items():
        real = getattr(bench, name)

        def small(*_, _real=real, _kw=kw, device=None, **__):
            out = _real(**_kw, device=device)
            if _real.__name__ == "bench_trace":
                rates.append(out[0])
            return out

        monkeypatch.setattr(bench, name, small)
    monkeypatch.setattr(bench, "smoll_room_config", small_config)
    cli.main(["bench", "--device", "cpu"])
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    want = jax_result_line()
    assert list(line) == list(want) == ["metric", "value", "unit",
                                        "vs_baseline"]
    assert line["metric"] == want["metric"] \
        == "ray_bounce_intersections_per_sec_per_chip"
    assert line["unit"] == want["unit"] == "intersections/s"
    rps = rates[0]          # the first bench_trace call is the headline
    assert line["value"] == float(f"{rps:.4g}") and line["value"] > 0
    assert line["vs_baseline"] == float(f"{rps / 100e6:.4g}")
    lines = err.strip().splitlines()
    assert lines[0].startswith("device=cpu")
    assert "trace frame @131k rays x 8 bounces" in lines[-1]
    assert "large scene (" in lines[-1]
