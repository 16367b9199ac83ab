#!/usr/bin/env python3
"""Where the PyTorch port's room sweep and mixdown spend their time, on one
NVIDIA GPU.

Runs the port's batched-trace path (``realisticaudioraytracing2d_tpu_torch``,
the rooms-batched kernel K9) at the CLI sweep's defaults (15,000 rays x 5
bounces x 8 frames, 48 kHz, 72,000-bin IRs) and prints:

1. the phases of ``cli sweep --rooms N`` on the host clock, each ended by
   a device sync: building the rooms on the host, uploading them, the
   ``sweep_rooms`` call, copying the IR dataset to the host, writing the
   npz; then the whole CLI once, end to end;
2. one ``sweep_rooms`` call under ``torch.profiler``: device time by kind
   of kernel (K9 is one launch of ``frames_ir_kernel<false>``; then the
   accumulator's memset, ``fixed_to_float_kernel`` and the division by the
   frame count) and the device's idle share of the call's wall time;
3. the same for one 64-source stereo ``trace_sources_mixdown`` in
   SmollRoom (BASELINE.json config #4).

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_profile_sweep.py [--rooms 1024] [--out FILE]

``--out`` also writes the profiler's tables of device kernels.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, T = 48000, 72000
RAYS, BOUNCES, FRAMES = 15000, 5, 8
N_SOURCES = 64


def kind(name):
    """Group a device event by what launched it."""
    low = name.lower()
    if "frames_ir_kernel" in name:
        return "K9 frames_ir_kernel"
    if "fixed_to_float" in name:
        return "K9 fixed_to_float_kernel"
    if "memset" in low:
        return "memsets (the u64 accumulator)"
    if "memcpy" in low:
        return "copies"
    if "divfunctor" in low:
        return "division by the frame count"
    if "reduce" in low:
        return "reductions (scales, mixdown sum)"
    return "other elementwise / fill"


def profiled(torch, fn, label, out):
    """Run ``fn`` once after a warm-up under the profiler; print its device
    time by kind and the idle share of its wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, launches = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kind(e.name)
            busy[k] = busy.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
        elif e.name == "cudaLaunchKernel":
            launches += 1
    total = sum(busy.values())
    print(f"{label}: {wall_ms:.3f} ms on the host clock (profiler on); "
          f"device busy {total:.4f} ms = {100 * total / wall_ms:.1f}% "
          f"(idle {100 * (1 - total / wall_ms):.1f}%); {launches} "
          "cudaLaunchKernel", flush=True)
    if not busy:
        print("    the profiler recorded no device events: device time not "
              "measured", flush=True)
    for k, ms in sorted(busy.items(), key=lambda kv: -kv[1]):
        print(f"    {k:34s} {ms:.4f} ms", flush=True)
    if out:
        out.write(f"{label}\n")
        out.write(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=30) + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rooms", type=int, default=1024)
    ap.add_argument("--out", help="write the profiler's tables here")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch import cli
    from realisticaudioraytracing2d_tpu_torch.parallel.multisource import \
        trace_sources_mixdown
    from realisticaudioraytracing2d_tpu_torch.parallel.sweep import \
        sweep_rooms

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_sweep: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    kw = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR, ir_length=T)
    out = open(args.out, "w") if args.out else None
    if out:
        out.write(f"card: {card}\n")

    # --- 1. the CLI's phases ---------------------------------------------
    warm, wsrc, wlis = art.rooms.random_rooms(2, seed=1, device=dev)
    sweep_rooms(warm, wsrc, wlis, 0, n_frames=1, **kw)     # builds K9
    torch.cuda.synchronize()
    phases = {}
    t0 = time.perf_counter()
    scenes, src, lis = art.rooms.random_rooms(args.rooms, seed=0,
                                              device="cpu")
    phases["build rooms (host)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scenes = scenes.to(dev)
    torch.cuda.synchronize()
    phases["upload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    irs = sweep_rooms(scenes, src, lis, 0, n_frames=FRAMES, **kw)
    torch.cuda.synchronize()
    phases["sweep_rooms"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = irs.cpu().numpy()
    phases["copy to host"] = time.perf_counter() - t0
    del irs
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        np.savez_compressed(os.path.join(tmp, "irs.npz"), irs=host,
                            sources=src, listeners=lis)
        phases["npz write"] = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(tmp, "irs.npz"))
        t0 = time.perf_counter()
        cli.main(["sweep", "--rooms", str(args.rooms), "--out",
                  os.path.join(tmp, "cli.npz")])
        cli_s = time.perf_counter() - t0
    total = sum(phases.values())
    print(f"[1] cli sweep --rooms {args.rooms} ({RAYS} x {BOUNCES} x "
          f"{FRAMES} frames, {T} bins), phases on the host clock: "
          + "; ".join(f"{k} {v:.3f} s ({100 * v / total:.1f}%)"
                      for k, v in phases.items())
          + f"; npz {size / 2 ** 20:.1f} MiB of {host.nbytes / 2 ** 20:.1f} "
          f"MiB; the whole CLI call {cli_s:.3f} s", flush=True)
    del host

    # --- 2. one sweep under the profiler -----------------------------------
    profiled(torch, lambda: sweep_rooms(scenes, src, lis, 0, n_frames=FRAMES,
                                        **kw),
             f"[2] sweep_rooms, {args.rooms} rooms", out)

    # --- 3. one mixdown under the profiler ---------------------------------
    room = art.rooms.smoll_room(device=dev)
    g = np.random.default_rng(11)
    sources = np.stack([g.uniform(-15, 15, N_SOURCES),
                        g.uniform(-3, 8, N_SOURCES)], -1).astype(np.float32)
    ears = np.array([[-0.2, -3.68], [0.2, -3.68]], np.float32)
    params = art.TraceParams.make(sources, ears, device=dev)
    profiled(torch, lambda: trace_sources_mixdown(room.scene, params, 7,
                                                  **kw),
             f"[3] trace_sources_mixdown, {N_SOURCES} sources, 2 ears", out)
    if out:
        out.close()
    print(f"card: {card}")


if __name__ == "__main__":
    main()
