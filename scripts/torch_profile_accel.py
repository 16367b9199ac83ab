#!/usr/bin/env python3
"""Where the PyTorch port's large-scene path (the cluster kernel K8) spends
its time, on one NVIDIA GPU.

Runs ``trace_frames_ir_accel_sorted`` (``ops/cuda/accel_kernel.py``) at
the JAX package's large-scene bench (``bench.py:249-282``): the procedural
city of ``--boxes`` boxes (10,000: 40,008 walls), 131,072 rays x 6
bounces x 4 frames, 16 kHz, 24,000 bins, input gain 100. Prints:

1. the first call on the scene under ``torch.profiler``: the device time
   of ``prepare`` (the Morton sort and boxing of the walls, which later
   calls on the same scene tensors find cached), told apart by a
   ``record_function`` range that this script wraps around it;
2. the call's time with CUDA events (three calls after a warm-up), with
   ``early_out`` on;
3. one later call under ``torch.profiler``: the device's busy share of the
   call's wall time, and the device time split between the K8 launches
   (``accel_bounce_kernel``: one per bounce; each writes its rays' next
   Morton keys, reads its rays through the last sort's permutation and
   orders the super boxes per block itself), the sorts of the keys
   between bounces (``torch.sort``: cub's radix sort passes), the u64 ->
   f32 conversion pass and everything else (the fixed-point scale, the
   accumulator's zeroing, the scalars), by kernel name.

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
PREPARE = "art::prepare"


def kind(name):
    """Group a device event by what launched it."""
    low = name.lower()
    if "accel_bounce_kernel" in name:
        return "K8 accel_bounce_kernel"
    if "fixed_to_float" in name:
        return "conversion (fixed_to_float)"
    if "sort" in low or "scan" in low or "histogram" in low:
        return "sorts of the keys (torch.sort)"
    return "other (scale, zeros, scalars, ...)"


def main():
    sys.path.insert(0, HERE)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--boxes", type=int, default=10000)
    ap.add_argument("--out", help="also write the kernel table here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        accel_kernel as ak
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_accel: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; build {build.build():.1f} s", flush=True)

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

    build_prepared = ak._build

    def ranged_build(*a, **k):
        with record_function(PREPARE):
            return build_prepared(*a, **k)

    ak._build = ranged_build
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
    ak._build = build_prepared
    prep_ms = sum(e.device_time_total for e in prof.events()
                  if e.name == PREPARE
                  and e.device_type != torch.autograd.DeviceType.CUDA) / 1e3
    print(f"[1] first call on the scene (library load included): "
          f"{first_ms:.1f} ms on the host clock; prepare (wall sort + boxes"
          f", once per scene): {prep_ms:.4f} ms on the device, "
          f"{ak.prepare.builds} build", flush=True)

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
    print(f"[2] K8 path, city_scene({args.boxes}) = {room.scene.n_walls} "
          f"walls, {RAYS} x {BOUNCES} x {FRAMES} frames, {T} bins: "
          f"{call_ms:.3f} ms per call (CUDA events, 3 calls); prepare built "
          f"{ak.prepare.builds} scene over all calls so far", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, counts = {}, {}
    total, launches = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            total += ms
            busy[kind(e.name)] = busy.get(kind(e.name), 0.0) + ms
            counts[kind(e.name)] = counts.get(kind(e.name), 0) + 1
        elif e.name == "cudaLaunchKernel":
            launches += 1
    print(f"[3] one call under the profiler: {wall_ms:.3f} ms on the host "
          f"clock; device busy {total:.4f} ms = {100 * total / wall_ms:.1f}%"
          f" of it, {100 * total / call_ms:.1f}% of the unprofiled "
          f"{call_ms:.3f} ms; {launches} cudaLaunchKernel", flush=True)
    for label, ms in sorted(busy.items(), key=lambda kv: -kv[1]):
        print(f"    {label}: {ms:.4f} ms in {counts[label]} kernels "
              f"({100 * ms / total:.2f}% of device time)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(f"{card}\n")
            f.write(prof.key_averages().table(
                sort_by="cuda_time_total", row_limit=40))
    print(f"card: {card}")


if __name__ == "__main__":
    main()
