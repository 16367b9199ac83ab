#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``realisticaudioraytracing2d_tpu_
torch``) on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(the cell's scene and state, the kernels' build on a checkout's first
run, the warm-up of every shape the window uses), a closed-loop window of
``--seconds``, then the comparison of a sample of the window's answers
with the plain reference (``benchmark/reference/``). It prints one JSON
line last on standard output: ``correct``, ``attempted`` (units of work
completed in the window), ``failed`` (compared answers over a limit),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics from a profiled window), ``device`` and, last,
``checks``: each compared number with its limit, which also close
standard error.

A cell with an end-to-end metric of ``source`` ``device_trace`` times its
window under the profiler's device activity alone (the cards' busy
seconds); one with a per-layer metric of ``source`` ``host_clock`` times,
with ``--trace 1``, an untraced window of ``--seconds`` before the traced
one.

It exits non-zero and prints no result where no card is found or fewer
than the cell asks for, and where a module of JAX or of the JAX package
was loaded (top-level names compared whole). Build and kernel caches stay
inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "realisticaudioraytracing2d_tpu")


def forbidden_loaded(modules=None) -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, each compared whole (the port's name begins with the JAX
    package's and is not one of them)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e})"
    return "; ".join(out)


def prepare(args, root: Path, card: bool, t0: float = T0):
    """Everything before the window: the cell's parts, the devices, the
    driver set up. Returns ``(cell, env, driver, devices, setup_s)``, or
    None where the cards are missing (said on standard error)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import torch
    from benchmark import harness, registry

    marks = [("imports", time.perf_counter())]
    cell = registry.cell(registry.load(root), args.workload, root)
    if card:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA "
                  f"device(s), found {n}", file=sys.stderr)
            return None
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
        for d in devices:
            torch.empty(1, device=d)
    else:
        devices = [torch.device("cpu")] * cell.chips
    marks.append(("devices", time.perf_counter()))
    env = harness.Env(root, cell.name, cell.config, cell.traffic, args.seed,
                      devices, card)
    drv = cell.driver.Driver(env)
    marks.append(("program import and draws", time.perf_counter()))
    drv.setup()
    harness.sync(devices)
    marks.append(("driver set-up and warm-up", time.perf_counter()))
    print("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, b), (_, a) in
        zip(marks, [("start", t0)] + marks)), file=sys.stderr)
    return cell, env, drv, devices, time.perf_counter() - t0


def compare(drv, env, card: bool, control=None):
    """The sampled answers against the plain reference, once the program's
    state is dropped: ``(keys, gaps, work, seconds, control_gaps)``. With
    ``control`` (a dtype) the reference computed in that precision also
    stands in for the program's answers: ``control_gaps``."""
    import torch
    keys = [k for k, _ in env.sample.items]
    answers = drv.answers()
    drv.release()
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref, work = drv.reference(keys, torch.float32, torch.float64)
    secs = time.perf_counter() - t
    ctl = None
    if control is not None:
        ctl = drv.gaps(drv.reference(keys, control, control)[0], ref)
    return keys, drv.gaps(answers, ref), work, secs, ctl


def main(argv=None, root: Path = ROOT, card: bool = True) -> int:
    """One run. ``card=False`` (the tests) skips the look for a card and
    runs on the CPU, where the program runs its plain paths."""
    args = parse(argv)
    ready = prepare(args, root, card)
    if ready is None:
        return 2
    cell, env, drv, devices, setup_s = ready
    import torch
    from benchmark import capture, harness

    if args.trace:
        host = capture.timed(drv, args.seconds, setup_s, env.sample) \
            if any(m["source"] == "host_clock" for m, _ in cell.per_layer) \
            else None
        window, evs = capture.traced(drv, args.seconds,
                                     int(cell.traffic["trace_steps"]),
                                     setup_s, env.sample, devices)
    else:
        profiled = card and any(m["source"] == "device_trace"
                                for m, _ in cell.end_to_end)
        window = capture.timed(drv, args.seconds, setup_s, env.sample,
                               devices if profiled else None)
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) \
        if card else 0
    if forbidden_loaded():
        print(f"benchmark: loaded {forbidden_loaded()}", file=sys.stderr)
        return 3

    keys, gaps, work, t_ref, _ = compare(drv, env, card)
    checks = [harness.Check(n, max(v), cell.limits[n])
              for n, v in gaps.items()]
    failed = sum(1 for n, v in gaps.items() for x in v
                 if not harness.Check(n, x, cell.limits[n]).ok)

    metrics, extra = {}, {}
    device = {"platform": "gpu" if card else "cpu",
              "kind": torch.cuda.get_device_name(devices[0]) if card
              else "cpu", "count": cell.chips, "memory_peak_bytes": peak}
    if args.trace:
        r = capture.reading(window, evs, devices, drv.shapes(), work, host)
        for m, reader in cell.per_layer:
            value = reader.read(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = r.busy_s()
        device["window_s"] = r.window_s
        extra["breakdown"] = capture.breakdown(r)
    else:
        for m, reader in cell.end_to_end:
            value = reader.read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if forbidden_loaded():
        print(f"benchmark: loaded {forbidden_loaded()}", file=sys.stderr)
        return 3

    result = {"correct": all(c.ok for c in checks),
              "attempted": window.units, "failed": failed,
              "metrics": metrics, "device": device, **extra,
              "checks": {c.name: {"value": c.value, "limit": c.limit}
                         for c in checks}}
    print(f"card: {card_line() if card else 'cpu'}", file=sys.stderr)
    print(f"window: {len(window.steps)} steps, {window.units} "
          f"{drv.unit}, {window.seconds:.3f} s; setup {setup_s:.3f} s; "
          f"compared {keys} in {t_ref:.3f} s; work per step {work}",
          file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
