#!/usr/bin/env python3
"""Where the PyTorch port's per-arrival Doppler chunk spends its time, on one
NVIDIA GPU.

Streams the shipped SmollRoom configuration (15,000 rays x 5 bounces,
48 kHz, 72,000-bin IR, 4,800-sample chunks; K4 once a chunk) in three
modes: the plain mono stream, the per-arrival mono stream and the
per-arrival binaural stream (static poses, as ``chip_smoke.py`` [14d]).
For each it prints:

1. host ms per chunk, median and p99 of 100 chunks synced after each;
2. one 20-chunk stream under ``torch.profiler``, per chunk: the
   device-busy ms, ``cudaLaunchKernel`` calls, copies
   (``cudaMemcpyAsync``) and stream syncs (``cudaStreamSynchronize``);
3. the host ms per chunk inside each stage of the step, from
   ``record_function`` ranges this script wraps around the port's
   functions (the library carries no instrumentation): the trace
   (``engine.trace_accumulate``), the binaural decode, the arrival table,
   the match, the tap removal, the tap synthesis, the crossfaded
   convolution, and the whole per-arrival part;
4. the operators with the most host time per chunk.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_profile_doppler.py [--out FILE]

``--out`` also writes the profiler's operator tables.
"""

import argparse
import functools
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, CHUNK = 48000, 4800
RAYS = 15000
STAGES = {"engine.trace_accumulate": ("engine", "trace_accumulate"),
          "spatial.binaural_decode_ir": ("spatial", "binaural_decode_ir"),
          "_arrival_table": ("streaming", "_arrival_table"),
          "_match_arrivals": ("streaming", "_match_arrivals"),
          "_remove_taps": ("streaming", "_remove_taps"),
          "_tap_chunk": ("streaming", "_tap_chunk"),
          "_crossfaded_wet": ("streaming", "_crossfaded_wet"),
          "_per_arrival_parts": ("streaming", "_per_arrival_parts"),
          "_per_arrival_binaural": ("streaming", "_per_arrival_binaural")}


def wrap_stages(torch, pkg):
    """Wrap each stage in a ``record_function`` range (module attributes
    only, so the callers that look the names up at call time see it)."""
    import importlib
    for label, (mod, name) in STAGES.items():
        m = importlib.import_module(f"{pkg}.{mod}")
        fn = getattr(m, name)

        @functools.wraps(fn)
        def ranged(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(f"stage:{_label}"):
                return _fn(*a, **k)
        setattr(m, name, ranged)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the profiler's tables here")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_doppler: no CUDA device")
    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build
    from realisticaudioraytracing2d_tpu_torch.utils.audio_io import click_clip
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"device: {card} | torch {torch.__version__}", flush=True)
    build.build()
    build.load_library()
    wrap_stages(torch, "realisticaudioraytracing2d_tpu_torch")
    dev = torch.device("cuda")
    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config(ray_count=RAYS)
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    dry = torch.as_tensor(click_clip(2.0, SR, click_times=(0.1, 0.7, 1.3)),
                          device=dev)
    modes = {
        "mono": (dict(), None, False),
        "per-arrival mono": (dict(), None, "per_arrival"),
        "per-arrival binaural": (dict(binaural=True),
                                 lambda i: 0.4 - 0.05 * i, "per_arrival")}
    tables = []
    for name, (kw, facing, doppler) in modes.items():
        def stream(n, on_chunk=None):
            return art.Streamer(room.scene, cfg, seed=71, **kw).stream_clip(
                dry, lambda i: p, loop=True, total_chunks=n,
                facing_fn=facing, doppler=doppler, on_chunk=on_chunk)

        stream(5)
        torch.cuda.synchronize()
        chunk_ms, t_last = [], [time.perf_counter()]

        def tick(i, st):
            torch.cuda.synchronize()
            now = time.perf_counter()
            chunk_ms.append((now - t_last[0]) * 1e3)
            t_last[0] = now

        stream(101, tick)
        steady = np.asarray(chunk_ms[1:])
        n = 20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            stream(n)
            torch.cuda.synchronize()
        events = prof.events()
        # device kernels and copies; the stage ranges' own device-side
        # annotations span the kernels they hold and are left out
        busy = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("stage:")) / 1e3
        count = {k: sum(1 for e in events if e.name == k) / n
                 for k in ("cudaLaunchKernel", "cudaMemcpyAsync",
                           "cudaStreamSynchronize")}
        print(f"[{name}] host ms per chunk median {np.median(steady):.3f}, "
              f"p99 {np.percentile(steady, 99):.3f} (100 chunks, synced); "
              f"profiled, per chunk: device busy {busy / n:.4f} ms, "
              + ", ".join(f"{k} {v:.1f}" for k, v in count.items()),
              flush=True)
        stages = {}
        for e in events:
            if e.name.startswith("stage:") and e.device_type == \
                    torch.autograd.DeviceType.CPU:
                stages.setdefault(e.name[6:], []).append(
                    e.time_range.elapsed_us() / 1e3)
        print(f"[{name}] host ms per chunk by stage (inclusive; calls per "
              "chunk): " + "; ".join(
                  f"{k} {sum(v) / n:.3f} ({len(v) / n:g})"
                  for k, v in stages.items()), flush=True)
        ka = prof.key_averages()
        top = sorted((a for a in ka if not a.key.startswith("stage:")),
                     key=lambda a: -a.self_cpu_time_total)[:12]
        print(f"[{name}] top operators by host time per chunk: " + "; ".join(
            f"{a.key} {a.self_cpu_time_total / 1e3 / n:.3f} ms x "
            f"{a.count / n:g}" for a in top), flush=True)
        tables.append(f"== {name}\n" + ka.table(
            sort_by="self_cpu_time_total", row_limit=60))
    if args.out:
        with open(args.out, "w") as f:
            f.write(f"{card}\n" + "\n".join(tables))


if __name__ == "__main__":
    main()
