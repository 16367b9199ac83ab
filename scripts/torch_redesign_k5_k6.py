#!/usr/bin/env python3
"""The redesigned K5 and K6 of the PyTorch port against the per-bounce step
kernel they replace, on one NVIDIA GPU.

K5 (``trace_fused_rows``: one frame's hit rows) and K6
(``trace_frame_ir_fused``: one frame's IR, binned in the kernel) ran one
launch per bounce of one step kernel, the ray state in device memory
between launches. Now K5 runs the bounce loop of K3 with a row sink in
one launch (``frame_rows_kernel``), and K6 is K3's launch at one frame
(K4's with a seed).

Runs the same calls through two checkouts of the repository: ``--parent
DIR`` (a checkout of the commit before the redesign, e.g. ``git archive``
of it unpacked under ``build/``) and the checkout this script lives in,
each in processes of its own that import that checkout's package and
build its kernels, in the order parent, change, change, parent. Calls, on
one SmollRoom frame with host uniforms (48 kHz, 72,000 bins):

* K5 and K6 at 15,000 rays x 5 bounces (the stream's and the CLI's frame)
  and at 131,072 x 8 (the bench frame);
* K6 with a seed at 15,000 x 5 (K4's launch at one frame).

For each: the device ms of the trace kernel's launches per call (the
profiler, the median of three readings; ``bounce_step_kernel`` in the
parent, ``frame_rows_kernel`` or ``frames_ir_kernel`` here), the call's
device-busy ms (memsets and the IR conversion included) and its
CUDA-event ms, a hash of its output and its work counts (wall tests,
sweeps, slab tests). This checkout also runs K5 with lane groups of 1 and
4 (``bounce_kernel.lane_group`` forced): one lane in four stores the rows
in groups of 4; and, through copies of its sources under
``build/ablate/`` built into libraries of their own, the designs
``frame_rows_kernel`` was chosen over: ``rows_lb4`` asks the compiler
for four resident blocks of 256 per SM (at most 64 registers, K3's
count) in lane groups too, ``rows_free`` for none at one lane a ray (the
compiler then takes 79 registers). Every process prints the ptxas line
(registers, stack, spill stores / loads) of each kernel instantiation of
its build; the script checks that both checkouts, both lane groups and
the copy give the same bits and the same work counts.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_redesign_k5_k6.py --parent build/parent \\
        [--out FILE.json]
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))
from torch_profile_ablate import make_variant  # noqa: E402
from torch_redesign_k7_k4 import ptxas  # noqa: E402

SR, T = 48000, 72000
SHAPES = {"15k x 5": (15000, 5), "131k x 8": (131072, 8)}
# name: the edits of the copy of csrc/ (regex, replacement): K5 asks for
# 4 resident blocks of 256 in lane groups too, or for none at G = 1
VARIANTS = {
    "rows_lb4": ((r"kLanes == 1 \? 4 : 1;", "4;"),),
    "rows_free": ((r"kLanes == 1 \? 4 : 1;", "1;"),)}


def build_all(parent):
    """Build every library the workers load, all at once (one process per
    checkout or copy, each running one nvcc per source)."""
    dirs = {name: make_variant(
        os.path.join(HERE, "realisticaudioraytracing2d_tpu_torch", "csrc"),
        name, edits) for name, edits in VARIANTS.items()}
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
            raise SystemExit(f"build of {src or root} failed:\n"
                             f"{err[-4000:]}")
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
                    work=[int(x) for x in work.cpu()])

    room = art.rooms.smoll_room(device=dev)
    sc, p = room.scene, art.TraceParams.make(room.source, room.listener,
                                             device=dev)
    step = "bounce_step_kernel"
    names = {"K5": step if role == "parent" else "frame_rows_kernel",
             "K6": step if role == "parent" else "frames_ir_kernel"}
    calls = {}
    for shape, (n_rays, n_b) in SHAPES.items():
        emit, u = rng.philox_uniforms(27, 1, n_b, n_rays, dev)
        reps = 10 if n_rays < 20000 else 5
        calls[f"K5 {shape}"] = (
            lambda e=emit[0], v=u[0], **kw: bk.trace_fused_rows(
                sc, p, e, v, **kw), reps, "K5")
        calls[f"K6 {shape}"] = (
            lambda e=emit[0], v=u[0], **kw: bk.trace_frame_ir_fused(
                sc, p, e, v, sample_rate=SR, ir_length=T, **kw), reps, "K6")
    calls["K6 seed 15k x 5"] = (
        lambda **kw: bk.trace_frame_ir_fused(
            sc, p, seed=27, n_rays=15000, max_bounces=5, sample_rate=SR,
            ir_length=T, **kw), 10, "K6")
    res = {"ptxas": ptxas(build.build_log())}
    for key, (fn, reps, k) in calls.items():
        res[key] = measure(fn, reps, names[k])
    if role == "change":
        rows_calls = [c for c in calls if c.startswith("K5")]
        chosen = bk.lane_group
        for g in (1, bk.LANE_GROUP):
            bk.lane_group = lambda n, k, g=g: g
            for key in rows_calls:
                fn, reps, k = calls[key]
                res[f"{key} [G={g}]"] = measure(fn, reps, names[k])
        bk.lane_group = chosen
        source_dir = build.SOURCE_DIR
        for name, src in dirs.items():
            build.SOURCE_DIR = Path(src)
            build.load_library.cache_clear()
            res[f"ptxas {name}"] = ptxas(build.build_log())
            for key in rows_calls:
                fn, reps, k = calls[key]
                res[f"{key} [{name}]"] = measure(fn, reps, names[k])
        build.SOURCE_DIR = source_dir
        build.load_library.cache_clear()
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
        for key in [k for k in (runs[role] or [{}])[0]
                    if k.startswith("ptxas")]:
            print(f"{key} ({role}): " + " | ".join(runs[role][0][key]),
                  flush=True)
    ok = True
    for key in [k for k in runs["change"][0] if k != "card"
                and not k.startswith("ptxas")]:
        line = f"{key}:"
        for role in ("parent", "change"):
            rs = [r[key] for r in runs[role] if key in r]
            if rs:
                line += (f" {role} " + " / ".join(
                    f"{r['device_ms']:.4f} [{r['busy_ms']:.4f}, "
                    f"{r['ms']:.4f}]" for r in rs))
        base = key.split(" [")[0]
        found = [r[k] for role in runs for r in runs[role]
                 for k in (key, base) if k in r]
        hashes = {f["hash"] for f in found}
        works = {tuple(f["work"]) for f in found}
        line += (f"; bits equal across runs, checkouts and lane groups: "
                 f"{len(hashes) == 1}; work {sorted(works)}")
        ok &= len(hashes) == 1 and len(works) == 1
        print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, runs=runs), f)
    if not ok:
        raise SystemExit("bits or work counts differ")


if __name__ == "__main__":
    main()
