#!/usr/bin/env python3
"""What the port's own spans (``utils/profiling.py::span``) cost and what
they account for, on one NVIDIA GPU, in the benchmark's stream cell.

Sets up ``shipped_rooms.stream_walk`` through the benchmark's own set-up
(``benchmark/run.py::prepare``: the configuration's scene, the seeded walk
and noise, the warm-up), then:

1. a traced window of the benchmark's (``benchmark/capture.py::traced``,
   200 chunks): every ``stage_*`` metric, the launch calls inside
   ``bench.pose`` and ``bench.step`` against the sum of the five sibling
   stages' (params, retrace, addenda, crossfade, ring), the share of those
   spans' host time the five stages cover, the device events named
   ``art.*`` (none wanted), the busy seconds per chunk and the idle gaps
   by label (``capture.breakdown``);
2. the cost with tracing off: blocks of untraced chunks alternate between
   the spans as written and a null context patched into the three modules
   that open them (``streaming``, ``engine``, ``bounce_kernel``), at least
   2,000 chunks each way, host ms per chunk each; and the helper alone,
   ``with span(...)`` against an empty loop, times the spans a chunk opens;
3. the cost with tracing on: the same alternation, each block inside its
   own profiler session (CPU and CUDA activity), the loop timed inside it;
   and the helper alone inside a session, where each span is recorded.

    python3 scripts/torch_profile_spans.py [--seed N] [--blocks 20] \\
        [--block 100] [--out FILE]

Prints a summary and one JSON line last; ``--out`` writes the JSON too.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "shipped_rooms.stream_walk"
SIBLINGS = ("params", "retrace", "addenda", "crossfade", "ring")
NULL = contextlib.nullcontext()


def null_span(name):
    return NULL


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}


def inside(t, spans):
    return any(s.start <= t <= s.end for s in spans)


def traced_window(drv, env, devices, setup_s):
    from benchmark import capture, registry, stages
    window, evs = capture.traced(drv, 30.0, 200, setup_s, env.sample,
                                 devices)
    r = capture.reading(window, evs, devices, drv.shapes(), None)
    metrics = {}
    for kind in ("stage_host_ms", "stage_launches"):
        for s in stages.SPANS:
            name = f"{kind}.{s}"
            metrics[name] = registry.reader(ROOT / "benchmark" / "metrics",
                                            name).read(r)
    outer = [e for e in evs if e.kind == "span"
             and e.name in ("bench.pose", "bench.step")]
    launches = [e for e in evs if e.kind == "launch"]
    in_outer = sum(1 for e in launches if inside(e.start, outer))
    sib_launches = sum(metrics[f"stage_launches.{s}"] for s in SIBLINGS)
    outer_s = sum(e.seconds for e in outer)
    sib_s = sum(e.seconds for s in SIBLINGS for e in stages.spans(r, s))
    art = [e for e in evs if e.name.startswith("art.")]
    b = capture.breakdown(r)
    return {
        "steps": r.steps, "window_s": r.window_s,
        "busy_s": r.busy_s(),
        "busy_ms_per_chunk": 1e3 * r.busy_s() / r.steps,
        "metrics": metrics,
        "launches_per_chunk": len(launches) / r.steps,
        "launches_in_pose_and_step_per_chunk": in_outer / r.steps,
        "sibling_launches_per_chunk": sib_launches,
        "pose_and_step_host_ms_per_chunk": 1e3 * outer_s / r.steps,
        "sibling_host_share": sib_s / outer_s if outer_s else None,
        "art_spans_per_chunk": {n: sum(1 for e in art if e.name == n)
                                / r.steps for n in sorted({e.name
                                                           for e in art})},
        "art_device_events": sorted({e.name for e in art if e.device >= 0}),
        "python_gap_s": sum(v for k, v in b["idle_gaps"]
                            if k == "bench.step / python"),
        "breakdown": b,
    }


def patch(on: bool):
    """The spans as written (``on``) or a null context in their place."""
    from realisticaudioraytracing2d_tpu_torch import engine, streaming
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel
    from realisticaudioraytracing2d_tpu_torch.utils import profiling
    for mod in (engine, streaming, bounce_kernel):
        mod.span = profiling.span if on else null_span


def alternate(drv, devices, blocks, block, profiled):
    """Host ms per chunk of ``blocks`` blocks of ``block`` chunks each way,
    spans and null context in turns (each block under its own profiler
    session when ``profiled``)."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * any(
        d.type == "cuda" for d in devices)
    out = {"spans": [], "null": []}
    for b in range(2 * blocks):
        side = ("spans", "null")[(b + b // 2) % 2]    # s n n s s n ...
        patch(side == "spans")
        session = profile(activities=acts) if profiled \
            else contextlib.nullcontext()
        with session:
            harness.sync(devices)
            t0 = time.perf_counter()
            for _ in range(block):
                drv.step()
            harness.sync(devices)
            dt = time.perf_counter() - t0
        out[side].append(1e3 * dt / block)
    patch(True)
    res = {k: quartiles(v) for k, v in out.items()}
    res["chunks_each_way"] = blocks * block
    res["spans_minus_null_us"] = 1e3 * (res["spans"]["median"]
                                        - res["null"]["median"])
    res["blocks"] = out
    return res


def helper_alone(n=200_000, profiled=False):
    """Microseconds of one ``with span(...)`` over an empty loop, best of
    five; ``profiled``: each loop inside a profiler session (CPU and CUDA
    activity), where every span records a host event."""
    from torch.profiler import ProfilerActivity, profile

    from realisticaudioraytracing2d_tpu_torch.utils.profiling import span
    best = []
    for _ in range(5):
        session = profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) \
            if profiled else contextlib.nullcontext()
        with session:
            t = time.perf_counter()
            for _ in range(n):
                with span("stream.ring"):
                    pass
            a = time.perf_counter() - t
            t = time.perf_counter()
            for _ in range(n):
                pass
            best.append((a - (time.perf_counter() - t)) / n * 1e6)
    return min(best)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=4210000001)
    ap.add_argument("--blocks", type=int, default=20)
    ap.add_argument("--block", type=int, default=100)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import run
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    ready = run.prepare(run.parse(["--workload", CELL, "--seed",
                                   str(args.seed), "--seconds", "10"]),
                        ROOT, True)
    _, env, drv, devices, setup_s = ready
    res = {"card": run.card_line(), "torch": torch.__version__,
           "seed": args.seed, "setup_s": setup_s}
    res["traced"] = traced_window(drv, env, devices, setup_s)
    res["off"] = alternate(drv, devices, args.blocks, args.block, False)
    res["helper_us"] = helper_alone()
    spans = sum(res["traced"]["art_spans_per_chunk"].values())
    res["helper_us_per_chunk"] = res["helper_us"] * spans
    res["helper_on_us"] = helper_alone(20_000, profiled=True)
    res["helper_on_us_per_chunk"] = res["helper_on_us"] * spans
    res["on"] = alternate(drv, devices, max(3, args.blocks // 4),
                          args.block, True)
    t = res["traced"]
    print(f"card: {res['card']}; torch {res['torch']}")
    print(f"traced: {t['steps']} chunks, busy {t['busy_ms_per_chunk']:.6f} "
          f"ms a chunk, launches {t['launches_per_chunk']:.4f} (pose+step "
          f"{t['launches_in_pose_and_step_per_chunk']:.4f}, siblings "
          f"{t['sibling_launches_per_chunk']:.4f}), sibling host share "
          f"{t['sibling_host_share']:.4f}, art device events "
          f"{t['art_device_events']}, step/python gaps "
          f"{t['python_gap_s']:.6f} s")
    for k, v in t["metrics"].items():
        print(f"  {k} {v!r}")
    for k in ("off", "on"):
        a = res[k]
        print(f"tracing {k}: spans {a['spans']['median']:.5f} ms, null "
              f"{a['null']['median']:.5f} ms a chunk "
              f"({a['chunks_each_way']} chunks each way): "
              f"{a['spans_minus_null_us']:+.2f} us")
    print(f"helper alone {res['helper_us']:.4f} us a span, "
          f"{res['helper_us_per_chunk']:.3f} us a chunk ({spans:g} spans); "
          f"recording {res['helper_on_us']:.4f} us a span, "
          f"{res['helper_on_us_per_chunk']:.3f} us a chunk")
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
