#!/usr/bin/env python3
"""Split the port's bench headline (``realisticaudioraytracing2d_tpu_torch/
bench.py::bench_trace``) on one NVIDIA GPU: the host time of a call, as the
bench takes it, against the device time of its kernel.

    python3 scripts/torch_profile_bench.py [--trials N] [--out FILE]

Two calls, at the bench's sizes: SmollRoom padded to 32 walls, 131,072
rays x 8 bounces x 50 frames, then 15,000 x 5 x 50 frames, each through
``engine.trace_accumulate`` (one K4 launch), a fresh IR state made before
the clock starts. For each: the best and the median host time of
``--trials`` calls (a synchronize before and after each, a fresh seed a
call as the bench's are), and K4's device time a call (the profiler, every
launch of the call held, ``chip_smoke.kernel_device_ms``). The bench's K8
call is split by ``scripts/torch_profile_accel.py``. Prints one line a
call; ``--out`` writes them as JSON.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.bench import card_line  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.engine import \
    trace_accumulate  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.rooms import \
    smoll_room  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops.ir import IRState  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops.trace import \
    TraceParams  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_bench: no CUDA device")
    dev = torch.device("cuda")
    card = card_line()
    room = smoll_room(pad_to=32, device=dev)
    p = TraceParams.make(room.source, room.listener, room.listener_radius,
                         343.0, 1.0, device=dev)
    rows = {}
    for n_rays, n_bounces in ((131072, 8), (15000, 5)):
        def call(seed):
            state = IRState.zeros(72000, 1, 1, device=dev)
            return lambda: trace_accumulate(
                room.scene, p, state, n_rays=n_rays, max_bounces=n_bounces,
                sample_rate=48000, n_frames=50, seed=seed)

        call(0)()                      # the kernels' build
        host = []
        for seed in range(1, 1 + args.trials):
            run = call(seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        dev_ms = cs.kernel_device_ms(torch, call(0), 3, "frames_ir_kernel",
                                     1)
        name = f"trace {n_rays} x {n_bounces} x 50"
        rows[name] = dict(host_best_ms=min(host),
                          host_median_ms=statistics.median(host),
                          host_ms=host, kernel_device_ms=dev_ms)
        print(f"{name} on {card}: host best {min(host):.4f} ms, median "
              f"{statistics.median(host):.4f} (best {min(host) / 50:.5f} ms "
              f"a frame); K4 device "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'} "
              "ms a call", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "trials": args.trials, **rows}, f,
                      indent=1)


if __name__ == "__main__":
    main()
