#!/usr/bin/env python3
"""Where the PyTorch port's stream spends its time, on one NVIDIA GPU.

Streams the shipped SmollRoom configuration of the port
(``realisticaudioraytracing2d_tpu_torch``: 15,000 rays x 5 bounces, 48 kHz,
72,000-bin IR, 4,800-sample chunks, one K4 launch per chunk) and prints:

1. host time per chunk of five unprofiled 35-chunk streams (2.0 s of
   clicks + 15 tail chunks), each after a warm-up;
2. the distribution (median, p90, p99, max) of 200 single chunks, each
   followed by a device sync;
3. one 35-chunk stream under ``torch.profiler``: device busy time per chunk
   by kind of kernel, device events and ``cudaLaunchKernel`` calls per
   chunk, and the device's idle share of the profiled wall time;
4. the K4 kernel at the bench frame (131,072 rays x 8 bounces) with 1, 8
   and 50 frames per launch: ms per frame (CUDA events) and the nominal
   wall-test rate ``R * W * B * (1 + L)`` per second.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_profile_stream.py [--out FILE]

``--out`` also writes the profiler's full table of device kernels.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, T, CHUNK = 48000, 72000, 4800
RAYS, BOUNCES = 15000, 5
N_CHUNKS = 20 + 15


def kind(name):
    """Group a device event by what launched it."""
    low = name.lower()
    if "frames_ir_kernel" in name:
        return "K4 frames_ir_kernel"
    if "fixed_to_float" in name:
        return "K4 fixed_to_float_kernel"
    if "fft" in low:
        return "cuFFT"
    if "memcpy" in low:
        return "device copies"
    if "memset" in low:
        return "memsets"
    return "elementwise / reduce / fill"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the full device-kernel table here")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        bounce_kernel as bk
    from realisticaudioraytracing2d_tpu_torch.utils.audio_io import \
        click_clip

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_stream: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config(ray_count=RAYS)
    params = art.Engine(room.scene, cfg).params(room.source, room.listener)
    dry = torch.as_tensor(click_clip(2.0, SR, click_times=(0.1, 0.7, 1.3)),
                          device=dev)

    # --- 1. unprofiled streams ----------------------------------------------
    runs = []
    for r in range(5):
        streamer = art.Streamer(room.scene, cfg, seed=100 + r)
        streamer.stream_clip(dry, lambda i: params, total_chunks=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streamer.stream_clip(dry, lambda i: params)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / N_CHUNKS)
    print("[1] 35-chunk streams, ms per chunk (host clock): "
          + ", ".join(f"{ms:.3f}" for ms in runs), flush=True)

    # --- 2. single chunks, each synced --------------------------------------
    streamer = art.Streamer(room.scene, cfg, seed=200)
    piece = dry[:CHUNK]
    for _ in range(5):
        streamer.process(piece, params)
    torch.cuda.synchronize()
    one = []
    for _ in range(200):
        t0 = time.perf_counter()
        streamer.process(piece, params)
        torch.cuda.synchronize()
        one.append((time.perf_counter() - t0) * 1e3)
    one = np.asarray(one)
    print(f"[2] 200 single chunks + sync, ms: median "
          f"{np.median(one):.3f}, p90 {np.percentile(one, 90):.3f}, p99 "
          f"{np.percentile(one, 99):.3f}, max {one.max():.3f}", flush=True)

    # --- 3. one stream under the profiler -----------------------------------
    streamer = art.Streamer(room.scene, cfg, seed=300)
    streamer.stream_clip(dry, lambda i: params, total_chunks=5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        streamer.stream_clip(dry, lambda i: params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, count, launches = {}, 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kind(e.name)
            busy[k] = busy.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
            count += 1
        elif e.name == "cudaLaunchKernel":
            launches += 1
    total = sum(busy.values())
    print(f"[3] profiled 35-chunk stream: {wall_ms / N_CHUNKS:.3f} ms per "
          f"chunk on the host clock (profiler on); device busy "
          f"{total / N_CHUNKS:.4f} ms per chunk = "
          f"{100 * total / wall_ms:.1f}% of the wall time (idle "
          f"{100 * (1 - total / wall_ms):.1f}%); {count / N_CHUNKS:.1f} "
          f"device events and {launches / N_CHUNKS:.1f} cudaLaunchKernel "
          f"per chunk", flush=True)
    if not busy:
        print("    the profiler recorded no device events: device time not "
              "measured", flush=True)
    for k, ms in sorted(busy.items(), key=lambda kv: -kv[1]):
        print(f"    {k:30s} {ms / N_CHUNKS:.4f} ms per chunk", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(f"card: {card}\n")
            f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=60))

    # --- 4. K4 at the bench frame -------------------------------------------
    big = dict(n_rays=131072, max_bounces=8, sample_rate=SR, ir_length=T)
    tests = 131072 * room.scene.n_walls * 8 * (1 + 1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for nf in (1, 8, 50):
        reps = max(2, 50 // nf)
        bk.trace_frames_ir_mega(room.scene, params, 1, nf, **big)
        torch.cuda.synchronize()
        start.record()
        for r in range(reps):
            bk.trace_frames_ir_mega(room.scene, params, 2 + r, nf, **big)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps / nf
        print(f"[4] K4 131072 x 8, {room.scene.n_walls} walls, 1 listener, "
              f"{nf} frames per launch: {ms:.4f} ms per frame = "
              f"{tests / ms * 1e3 / 1e9:.1f} G nominal wall tests/s",
              flush=True)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
