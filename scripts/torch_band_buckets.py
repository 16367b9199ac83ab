#!/usr/bin/env python3
"""The band buckets of the PyTorch port's banded kernels against their
scratch instantiation, on one NVIDIA GPU.

K3, K4, K9 and K7 keep a ray's K band energies in registers when K fits a
register bucket (``csrc/trace_common.cuh::by_bucket``) and in a device
scratch, band-major by thread, past the largest one. This script builds the
sources as they are (``buckets``) and a copy under ``build/ablate/scratch/``
whose ``by_bucket`` sends every K > 1 to the scratch (``scratch``), and
times the same banded calls through both libraries, alternating
``buckets, scratch, scratch, buckets`` (device time of the kernel from the
profiler, per call). Both must give the same IR bit for bit: the script
checks it. It also prints each library's ptxas line (registers, spills) of
the banded instantiations.

Calls, at each of ``--bands`` (default 8 and 32):

* K3 and K4 on one SmollRoom frame of 15,000 rays x 5 bounces, 72,000 bins
  at 48 kHz (the shipped configuration);
* K4 on the bench frame: 131,072 rays x 8 bounces x 8 frames;
* K9 on the 64-source mixdown in SmollRoom (two ears) and on a sweep of
  ``--rooms`` random rooms x 8 frames x 15,000 x 5;
* K7 on the ``--boxes`` city (10,000 boxes: 40,008 walls) at 131,072 x 6 x
  4 frames.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_band_buckets.py [--bands 8 32] [--rooms 256]
"""

import argparse
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))
from torch_profile_ablate import (CITY, CITY_FRAMES, CITY_GAIN,  # noqa: E402
                                  N_SOURCES, make_variant)

SR, T = 48000, 72000
RAYS, BOUNCES, FRAMES = 15000, 5, 8
# every register bucket above 1 out of by_bucket: K > 1 takes the scratch
SCRATCH = (r"\n  if \(n_bands <= \w+\) return f\(std::integral_constant<int, "
           r"\w+>\{\}\);", "")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bands", type=int, nargs="*", default=[8, 32])
    ap.add_argument("--rooms", type=int, default=256)
    ap.add_argument("--boxes", type=int, default=10000)
    ap.add_argument("--calls", nargs="*", default=None,
                    help="the calls to time, by the start of their name "
                         "(default: all)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    from pathlib import Path

    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch.models.scene import Scene
    from realisticaudioraytracing2d_tpu_torch.ops import rng
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        accel_kernel as ak
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        bounce_kernel as bk
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_band_buckets: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    kw = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR, ir_length=T)
    g = np.random.default_rng(11)
    sources = np.stack([g.uniform(-15, 15, N_SOURCES),
                        g.uniform(-3, 8, N_SOURCES)], -1).astype(np.float32)
    ears = np.array([[-0.2, -3.68], [0.2, -3.68]], np.float32)

    def calls(n_bands):
        smoll = art.rooms.smoll_room(n_bands=n_bands, device=dev)
        p = art.TraceParams.make(smoll.source, smoll.listener, device=dev)
        emit, u = rng.philox_uniforms(5, 1, BOUNCES, RAYS, dev)
        mix = art.TraceParams.make(sources, ears, device=dev)
        shared = Scene(*(x[None] for x in smoll.scene))
        rooms, src, lis = art.rooms.random_rooms(args.rooms, seed=0,
                                                 n_bands=n_bands, device=dev)
        city = art.rooms.city_scene(args.boxes, n_bands=n_bands, device=dev)
        city_p = art.TraceParams.make(city.source, city.listener,
                                      city.listener_radius, 343.0, CITY_GAIN,
                                      device=dev)
        return {
            "K3 15k x 5 x 1": (lambda: bk.trace_frames_ir_whole(
                smoll.scene, p, emit, u, sample_rate=SR, ir_length=T), 10,
                bk.trace_frames_ir_whole),
            "K4 15k x 5 x 1": (lambda: bk.trace_frames_ir_mega(
                smoll.scene, p, 5, 1, **kw), 10, bk.trace_frames_ir_mega),
            "K4 131k x 8 x 8": (lambda: bk.trace_frames_ir_mega(
                smoll.scene, p, 5, 8, n_rays=131072, max_bounces=8,
                sample_rate=SR, ir_length=T), 3, bk.trace_frames_ir_mega),
            "K9 mixdown 64 x 15k x 5": (lambda: bk.trace_rooms_ir_mega(
                shared, mix.source, mix.listeners.expand(N_SOURCES, -1, 2),
                7, 1, **kw), 5, bk.trace_rooms_ir_mega),
            f"K9 sweep {args.rooms} x 8 x 15k x 5": (
                lambda: bk.trace_rooms_ir_mega(rooms, src, lis, 0, FRAMES,
                                               **kw), 1,
                bk.trace_rooms_ir_mega),
            "K7 131k x 6 x 4, 40,008 walls": (lambda: ak.trace_frames_ir_accel(
                city.scene, city_p, 5, CITY_FRAMES, **CITY), 1,
                ak.trace_frames_ir_accel),
        }

    source_dir = build.SOURCE_DIR
    dirs = {"buckets": source_dir,
            "scratch": Path(make_variant(str(source_dir), "scratch",
                                         (SCRATCH,)))}
    buckets = {"buckets": (bk.BAND_BUCKETS, ak.BAND_BUCKETS),
               "scratch": ((1,), (1,))}

    def use(name):
        build.SOURCE_DIR = dirs[name]
        build.load_library.cache_clear()
        bk.BAND_BUCKETS, ak.BAND_BUCKETS = buckets[name]
        return build.build()

    for name in dirs:
        secs = use(name)
        lines = [ln for ln in _ptxas(build.build_log())
                 if "frames_ir_kernel" in ln or "accel_frames" in ln]
        print(f"[{name}] built in {secs:.1f} s; ptxas of the banded "
              "instantiations: " + " | ".join(lines), flush=True)
    for n_bands in args.bands:
        for call, (fn, reps, wrapper) in calls(n_bands).items():
            if args.calls and not any(call.startswith(c)
                                      for c in args.calls):
                continue
            got, irs = {}, {}
            for name in ("buckets", "scratch", "scratch", "buckets"):
                use(name)
                if name not in irs:
                    irs[name] = fn()
                got.setdefault(name, []).append(
                    device_ms(torch, fn, reps, wrapper))
            torch.cuda.synchronize()
            same = torch.equal(irs["buckets"], irs["scratch"])
            ms = {k: float(np.median(v)) for k, v in got.items()}
            print(f"[K = {n_bands}] {call}: buckets "
                  + " ".join(f"{x:.4f}" for x in got["buckets"])
                  + " ms, scratch "
                  + " ".join(f"{x:.4f}" for x in got["scratch"])
                  + f" ms; scratch / buckets "
                  f"{ms['scratch'] / ms['buckets']:.3f}; the same IR bit "
                  f"for bit: {same}", flush=True)
            if not same:
                raise SystemExit(f"{call} at K = {n_bands}: the scratch "
                                 "and the buckets disagree")
            del irs
            torch.cuda.empty_cache()
    use("buckets")
    build.SOURCE_DIR = source_dir
    print(f"card: {card}")


def device_ms(torch, fn, reps, wrapper):
    """Device milliseconds per call of the trace kernel that ``wrapper``
    launches, over ``reps`` calls: the first of up to five profiler
    readings that holds all its launches (``wrapper.launches`` counts them:
    the scratch may take a call's planes in several)."""
    from torch.profiler import ProfilerActivity, profile
    name = ("accel_bounce_kernel" if "accel" in wrapper.__name__
            else "frames_ir_kernel")
    before = wrapper.launches
    fn()
    torch.cuda.synchronize()
    launches = (wrapper.launches - before) * reps
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name]
        if len(us) == launches:
            return sum(us) / reps / 1e3
    raise SystemExit(f"{name}: no profiler reading held {launches} "
                     "launches")


def _ptxas(log):
    """(kernel<template args> registers, spills) of each instantiation."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            base = re.findall(r"\d+([a-z][a-z_]*_kernel)", m.group(1))
            args = re.findall(r"L([bi])(\d+)E", m.group(1))
            name = (base[-1] if base else m.group(1)) + (
                "<" + ",".join(v for _, v in args) + ">" if args else "")
        elif name and "spill stores" in ln:
            s = re.search(r"(\d+) bytes spill stores", ln).group(1)
            out.append([name, None, s])
        elif name and "Used" in ln and out and out[-1][0] == name \
                and out[-1][1] is None:
            out[-1][1] = re.search(r"Used (\d+) registers", ln).group(1)
    return [f"{n} {r} regs, spill {s} B" for n, r, s in out]


if __name__ == "__main__":
    main()
