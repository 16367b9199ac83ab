#!/usr/bin/env python3
"""The redesigned K7 and K3/K4 of the PyTorch port against the kernels
they replace and against the designs they were chosen over, on one NVIDIA
GPU.

Runs the same calls through two checkouts of the repository: ``--parent
DIR`` (a checkout of the commit before the redesign, e.g. ``git archive``
of it unpacked under ``build/``) and the checkout this script lives in,
each in processes of its own that import that checkout's package and
build its kernels, in the order parent, change, change, parent. Calls
(device ms of the trace kernel's launches per call from the profiler, the
median of three readings; beside it the call's device-busy ms, sorts and
conversion included, and its CUDA-event ms):

* K7 on the 40,008-wall city (``city_scene(10000)``) at 131,072 rays x 6
  bounces x 4 frames, 16 kHz, 24,000 bins, gain 100 (``chip_smoke.py``'s
  8d shape) at K = 1, 8 and 32 bands;
* K7 at the city stream's shape: ``city_scene(2500)`` (10,008 walls),
  15,000 x 5 x 1 frame, 48 kHz, 72,000 bins, 8 bands;
* K4 and K3 on one SmollRoom frame of 15,000 x 5 at 48 kHz, 72,000 bins
  (the stream's), K4 on two such frames (30,000 items), K4 on one bench
  frame (131,072 x 8), and K4 with 64 listeners at 8 bands.

This checkout also runs the K3/K4 calls with lane groups of 1 and 4
(``bounce_kernel.lane_group`` forced), and, through copies of its sources
under ``build/ablate/`` built into libraries of their own, the designs
the kernels were chosen over:

* ``groups2``, ``groups8``: lane groups of 2 or 8 (``kLaneGroup``) in place
  of 4;
* ``blocks64``: blocks of 64 threads (``kThreads``) without lane groups,
  the other way to spread a small grid over the card;
* ``layouts``: K7's energy buffer in the other layout, band-major for the
  register bucket (K <= 8) and ray-major for the wide kernel.

Every process prints each call's IR hash and work counts (wall tests,
sweeps, slab tests) and the ptxas line (registers, stack frame, spill
stores / loads) of each kernel instantiation of its build; the script
checks that the two checkouts, both lane groups and every copy give the
same IR bits, and that the sweeps are the same.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_redesign_k7_k4.py --parent build/parent \\
        [--out chiprun_out/redesign.json]
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))
from torch_profile_ablate import make_variant  # noqa: E402

CITY = dict(n_rays=131072, max_bounces=6, sample_rate=16000,
            ir_length=24000)
CITY_FRAMES, CITY_GAIN = 4, 100.0
SR, T, RAYS, BOUNCES = 48000, 72000, 15000, 5

# The register bucket's ray-major rows read and written band-major, and
# the wide kernel's band-major planes ray-major (csrc/accel_kernel.cu).
_BUCKET_LOAD = "load_bands(r.en, en_in + from * ((nk + 3) & ~3), nk);"
_BUCKET_STORE = ("if (alive) store_bands(r.en, en_out + slot * "
                 "((nk + 3) & ~3), nk);")
LAYOUTS = (
    (re.escape(_BUCKET_LOAD),
     "{\n#pragma unroll\n  for (int k = 0; k < kMaxK; ++k)\n"
     "    r.en[k] = k < nk ? en_in[k * n + from] : 0.0f;\n}"),
    (re.escape(_BUCKET_STORE),
     "if (alive) {\n#pragma unroll\n  for (int k = 0; k < kMaxK; ++k)\n"
     "    if (k < nk) en_out[k * n + slot] = r.en[k];\n}"),
    (re.escape("const WideBands wide{en_out + slot, n};"),
     "const WideBands wide{en_out + slot * ((nk + 3) & ~3), 1};"),
    (re.escape("wide[k] = en_in[k * n + from];"),
     "wide[k] = en_in[from * ((nk + 3) & ~3) + k];"),
)
# name: (edits, lanes the wrapper passes, the K3/K4 or K7 calls it times)
VARIANTS = {
    "groups2": (((r"constexpr int kLaneGroup = 4;",
                  "constexpr int kLaneGroup = 2;"),), 2, "K4"),
    "groups8": (((r"constexpr int kLaneGroup = 4;",
                  "constexpr int kLaneGroup = 8;"),), 8, "K4"),
    "blocks64": (((r"constexpr int kThreads = 256;",
                   "constexpr int kThreads = 64;"),), 1, "K4"),
    "layouts": (LAYOUTS, None, "K7"),
}


def ptxas(log):
    """'kernel<template args> R regs, stack S B, spill st/ld B' of each
    instantiation in an nvcc -Xptxas -v log."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            base = re.findall(r"\d+([a-z][a-z_]*_kernel)", m.group(1))
            args = re.findall(r"L([bi])(\d+)E", m.group(1))
            name = (base[-1] if base else m.group(1)) + (
                "<" + ",".join(v for _, v in args) + ">" if args else "")
        elif name and "spill stores" in ln:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            out.append([name, None, *m.groups()])
        elif name and "Used" in ln and out and out[-1][0] == name \
                and out[-1][1] is None:
            out[-1][1] = re.search(r"Used (\d+) registers", ln).group(1)
    return [f"{n} {r} regs, stack {st} B, spill {s}/{ld} B"
            for n, r, st, s, ld in out]


def build_all(parent):
    """Build every library the workers load, all at once (one process
    per checkout or copy, each running one nvcc per source)."""
    dirs = {name: make_variant(
        os.path.join(HERE, "realisticaudioraytracing2d_tpu_torch", "csrc"),
        name, edits) for name, (edits, _, _) in VARIANTS.items()}
    jobs = [(HERE, None)] + [(HERE, d) for d in dirs.values()]
    if parent:
        jobs.append((parent, None))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from pathlib "
            "import Path; from realisticaudioraytracing2d_tpu_torch.ops."
            "cuda import build\nif len(sys.argv) > 2: build.SOURCE_DIR = "
            "Path(sys.argv[2])\nbuild.build()")
    procs = [subprocess.Popen([sys.executable, "-c", code, root]
                              + ([src] if src else []), cwd=root,
                              stderr=subprocess.PIPE, text=True)
             for root, src in jobs]
    for (root, src), proc in zip(jobs, procs):
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise SystemExit(f"build of {src or root} failed:\n{err[-4000:]}")
    return dirs


def worker(root, role, dirs):
    """Time every call through the package of checkout ``root``; return
    {call: {"ms", "device_ms", "busy_ms", "hash", "work"}}."""
    sys.path.insert(0, root)
    import torch
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch.ops import rng
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        accel_kernel as ak
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        bounce_kernel as bk
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build
    build.build()
    dev = torch.device("cuda")

    def readings(fn, reps, name):
        """(trace-kernel ms, busy ms) per call: the median of three
        profiles of ``reps`` calls."""
        fn()
        torch.cuda.synchronize()
        kern, busy = [], []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            kern.append(sum(e.time_range.elapsed_us() for e in ev
                            if name in e.name) / reps / 1e3)
            busy.append(sum(e.time_range.elapsed_us() for e in ev)
                        / reps / 1e3)
        return float(np.median(kern)), float(np.median(busy))

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def measure(fn, reps, name):
        out = fn()
        work = torch.zeros(3, dtype=torch.int64, device=dev)
        fn(work_counts=work)
        torch.cuda.synchronize()
        kern, busy = readings(fn, reps, name)
        return dict(ms=event_ms(fn, reps), device_ms=kern, busy_ms=busy,
                    hash=hashlib.sha1(out.cpu().numpy().tobytes()
                                      ).hexdigest()[:16],
                    work=[int(x) for x in work.cpu()],
                    energy=float(out.double().sum()))

    def city(n_boxes, n_bands):
        room = art.rooms.city_scene(n_boxes, n_bands=n_bands, device=dev)
        return room.scene, art.TraceParams.make(
            room.source, room.listener, room.listener_radius, 343.0,
            CITY_GAIN, device=dev)

    def smoll(n_bands, listeners=None):
        room = art.rooms.smoll_room(n_bands=n_bands, device=dev)
        return room.scene, art.TraceParams.make(
            room.source, room.listener if listeners is None else listeners,
            device=dev)

    one = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR,
               ir_length=T)
    res = {"ptxas": ptxas(build.build_log())}
    k7 = {}
    for n_bands in (1, 8, 32):
        scene, p = city(10000, n_bands)
        k7[f"K7 K={n_bands} 40,008 walls"] = (
            lambda scene=scene, p=p, **kw: ak.trace_frames_ir_accel(
                scene, p, 5, CITY_FRAMES, **CITY, **kw), 2)
    scene, p = city(2500, 8)
    k7["K7 K=8 city stream 15k x 5 x 1"] = (
        lambda scene=scene, p=p, **kw: ak.trace_frames_ir_accel(
            scene, p, 5, 1, **one, **kw), 5)
    for key, (fn, reps) in k7.items():
        res[key] = measure(fn, reps, "accel_")
    sc, p = smoll(1)
    emit, u = rng.philox_uniforms(13, 1, BOUNCES, RAYS, dev)
    grid = torch.stack(torch.meshgrid(torch.linspace(-16, 16, 8),
                                      torch.linspace(-4, 7, 8),
                                      indexing="ij"), -1).reshape(-1, 2)
    sc64, p64 = smoll(8, grid.to(dev))
    k4 = {"K4 15k x 5 x 1": (lambda **kw: bk.trace_frames_ir_mega(
              sc, p, 5, 1, **one, **kw), 10),
          "K3 15k x 5 x 1": (lambda **kw: bk.trace_frames_ir_whole(
              sc, p, emit, u, sample_rate=SR, ir_length=T, **kw), 10),
          "K4 15k x 5 x 2": (lambda **kw: bk.trace_frames_ir_mega(
              sc, p, 5, 2, **one, **kw), 10),
          "K4 131k x 8 x 1": (lambda **kw: bk.trace_frames_ir_mega(
              sc, p, 6, 1, n_rays=131072, max_bounces=8, sample_rate=SR,
              ir_length=T, **kw), 5),
          "K4 64 listeners K=8 15k x 5 x 1": (
              lambda **kw: bk.trace_frames_ir_mega(sc64, p64, 31, 1, **one,
                                                   **kw), 3)}
    for key, (fn, reps) in k4.items():
        res[key] = measure(fn, reps, "frames_ir_kernel")
    if role != "change":
        return res
    chosen = bk.lane_group
    for g in (1, bk.LANE_GROUP):
        bk.lane_group = lambda n, k, g=g: g
        for key, (fn, reps) in k4.items():
            res[f"{key} [G={g}]"] = measure(fn, reps, "frames_ir_kernel")
    source_dir = build.SOURCE_DIR
    for name, (_, lanes, calls) in VARIANTS.items():
        build.SOURCE_DIR = Path(dirs[name])
        build.load_library.cache_clear()
        bk.lane_group = chosen if lanes is None else (
            lambda n, k, g=lanes: g)
        res[f"ptxas {name}"] = ptxas(build.build_log())
        for key, (fn, reps) in (k4 if calls == "K4" else k7).items():
            if calls == "K7" and "K=1 " in key:
                continue    # one band: no energy buffer
            res[f"{key} [{name}]"] = measure(
                fn, reps, "frames_ir_kernel" if calls == "K4" else "accel_")
    build.SOURCE_DIR = source_dir
    build.load_library.cache_clear()
    bk.lane_group = chosen
    res["card"] = torch.cuda.get_device_name(0)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=False,
                    help="root of the checkout before the redesign")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--role", default="change", help=argparse.SUPPRESS)
    ap.add_argument("--dirs", default="{}", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.role,
                                json.loads(args.dirs))))
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    parent = os.path.abspath(args.parent) if args.parent else None
    dirs = build_all(parent)
    order = [("change", HERE)]
    if parent:
        order = [("parent", parent), ("change", HERE), ("change", HERE),
                 ("parent", parent)]
    runs = {"parent": [], "change": []}
    for role, root in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root, "--role", role, "--dirs",
                              json.dumps(dirs)],
                             capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            raise SystemExit(f"{role} worker failed:\n{out.stderr[-4000:]}")
        runs[role].append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(f"card: {card}; order {[r for r, _ in order]}; device ms of the "
          "trace launches per call (median of three profiles) [busy ms, "
          "call ms]; readings of each run", flush=True)
    for role in runs:
        for key in [k for k in runs[role][0] if k.startswith("ptxas")]:
            print(f"{key} ({role}): " + " | ".join(runs[role][0][key]),
                  flush=True)
    ok = True
    change = runs["change"][0]
    for key in [k for k in change if k != "card"
                and not k.startswith("ptxas")]:
        line = f"{key}:"
        for role in ("parent", "change"):
            rs = [r[key] for r in runs[role] if key in r]
            if rs:
                line += (f" {role} " + " / ".join(
                    f"{r['device_ms']:.4f} [{r['busy_ms']:.4f}, "
                    f"{r['ms']:.4f}]" for r in rs))
        base = key.split(" [")[0]
        hashes = {r[k]["hash"] for role in runs for r in runs[role]
                  for k in (key, base) if k in r}
        works = {tuple(r[key]["work"]) for role in runs for r in runs[role]
                 if key in r}
        sweeps = {w[1] for w in works}
        line += (f"; IR bits equal across runs and to the chosen design: "
                 f"{len(hashes) == 1}; work {sorted(works)}")
        ok &= len(hashes) == 1 and len(sweeps) == 1
        print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, runs=runs), f)
    if not ok:
        raise SystemExit("bits or sweeps differ")


if __name__ == "__main__":
    main()
