#!/usr/bin/env python3
"""Where the PyTorch port's large-scene path (the cluster kernel K8) spends
its time, on one NVIDIA GPU.

Runs ``trace_frames_ir_accel_sorted`` (``ops/cuda/accel_kernel.py``) at
the JAX package's large-scene bench (``bench.py:249-282``): the procedural
city of ``--boxes`` boxes (10,000: 40,008 walls), 131,072 rays x 6
bounces x 4 frames, 16 kHz, 24,000 bins, input gain 100. Prints:

1. the call's time with CUDA events (three calls after a warm-up), with
   ``early_out`` on;
2. one call under ``torch.profiler``: the device's busy share of the
   call's wall time, and the device time split between the K8 launches,
   the re-sorts between bounces (Morton keys, one ``argsort``, two
   gathers), the near-to-far cluster order of each block, the per-call
   Morton sort and boxing of the walls (``prepare``), the u64 -> f32
   conversion pass and everything else. The re-sort, order and prepare
   steps are told apart by ``record_function`` ranges that this script
   wraps around them; the kernels by name.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_profile_accel.py [--boxes 10000] [--out FILE]

``--out`` also writes the profiler's table of device kernels.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAYS, BOUNCES, FRAMES, SR, T, GAIN = 131072, 6, 4, 16000, 24000, 100.0
RANGES = {"art::resort": "re-sorts (keys, argsort, gathers)",
          "art::cluster_order": "cluster order per block",
          "art::prepare": "prepare (wall sort + boxes)"}


def main():
    sys.path.insert(0, HERE)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--boxes", type=int, default=10000)
    ap.add_argument("--out", help="also write the kernel table here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch.ops import accel
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        accel_kernel as ak
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_accel: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; build {build.build():.1f} s", flush=True)

    def ranged(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    ak._resort = ranged("art::resort", ak._resort)
    accel.block_cluster_order = ranged("art::cluster_order",
                                       accel.block_cluster_order)
    ak.prepare = ranged("art::prepare", ak.prepare)

    dev = torch.device("cuda")
    room = art.rooms.city_scene(args.boxes, device=dev)
    params = art.TraceParams.make(room.source, room.listener,
                                  room.listener_radius, 343.0, GAIN,
                                  device=dev)
    kw = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR,
              ir_length=T)

    def call():
        return ak.trace_frames_ir_accel_sorted(room.scene, params, 1, FRAMES,
                                               **kw)

    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        call()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / 3
    print(f"[1] K8 path, city_scene({args.boxes}) = {room.scene.n_walls} "
          f"walls, {RAYS} x {BOUNCES} x {FRAMES} frames, {T} bins: "
          f"{call_ms:.3f} ms per call (CUDA events, 3 calls)", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = {"K8 accel_bounce_kernel": 0.0, "conversion (fixed_to_float)": 0.0}
    total, launches = 0.0, 0
    for e in prof.events():
        if e.name in RANGES and \
                e.device_type == torch.autograd.DeviceType.CUDA:
            continue    # the range's span on the device timeline
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            total += ms
            if "accel_bounce_kernel" in e.name:
                busy["K8 accel_bounce_kernel"] += ms
            elif "fixed_to_float" in e.name:
                busy["conversion (fixed_to_float)"] += ms
        elif e.name == "cudaLaunchKernel":
            launches += 1
        elif e.name in RANGES:
            label = RANGES[e.name]
            busy[label] = busy.get(label, 0.0) + e.device_time_total / 1e3
    busy["other (scale, zeros, emission order, ...)"] = \
        total - sum(busy.values())
    print(f"[2] one call under the profiler: {wall_ms:.3f} ms on the host "
          f"clock; device busy {total:.4f} ms = {100 * total / wall_ms:.1f}%"
          f" of it, {100 * total / call_ms:.1f}% of the unprofiled "
          f"{call_ms:.3f} ms; {launches} cudaLaunchKernel", flush=True)
    for label, ms in sorted(busy.items(), key=lambda kv: -kv[1]):
        print(f"    {label}: {ms:.4f} ms ({100 * ms / total:.2f}% of device "
              "time)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(f"{card}\n")
            f.write(prof.key_averages().table(
                sort_by="cuda_time_total", row_limit=40))


if __name__ == "__main__":
    main()
