#!/usr/bin/env python3
"""What the PyTorch port's trace kernels spend their device time on, by
ablation, on one NVIDIA GPU.

Copies ``realisticaudioraytracing2d_tpu_torch/csrc`` into scratch
directories under ``build/ablate/``, edits each copy's text, builds it into
a library of its own and times the same calls through every library. The
program's sources and switches are untouched; an edited copy's results are
wrong by design (that is the point: the time that goes away is the time the
edited part cost). Variants:

* ``base``: the sources as they are;
* ``fastdiv``: the two IEEE divides of the wall test (``... / safe;``)
  become ``__fdividef`` (a reciprocal and a multiply);
* ``noatomic``: the IR deposit's ``atomicAdd`` becomes a plain store;
* ``fastdiv+noatomic``: both;
* ``blocks2``, ``blocks4``: the bounce kernel's ``__launch_bounds__`` asks
  for 2 or 4 resident blocks of 256 per SM (at most 128 or 64 registers);
* ``unroll2``, ``unroll8``: the filter loop's unroll factor (4);
* ``accel3``, ``accel5``: the cluster kernels' ``__launch_bounds__`` asks
  for 3 or 5 resident blocks per SM (at most 85 or 51 registers);
* ``gain1``: the directive kernels' pattern gain (``fourier_gain``)
  returns 1 without evaluating the series: with ``--directive``, what the
  series itself costs beside the rest of the directive instantiation;
* ``cse``: NEE's direction to the listener (``tx / dist_l``, ``ty /
  dist_l``) is divided once and shared by the cosine and the microphone
  gain, instead of being written twice;
* ``gainunroll``: the series loop of ``fourier_gain`` is unrolled by 4
  (its trip count is the harmonics of the pattern, known at run time).

``--directive`` runs every call with a cardioid source (padded to 5
coefficients) and a figure-eight microphone (5), so the kernels' directive
instantiations are timed; without it, the omni ones.

``--layouts 16x32 32x16 ...`` also times K8 (``base``) under other cluster
layouts (walls per cluster x clusters per super box) than the port's
(``ops/accel.py::accel_layout``); the results do not depend on the layout,
the work counts do.

Calls timed (device time of the named kernel from the profiler, per call):

* K9 on the room sweep (``--rooms`` random rooms x 8 frames x 15,000 rays x
  5 bounces, 72,000 bins) and on the 64-source mixdown in SmollRoom;
* K4 on one SmollRoom frame of 15,000 x 5;
* K8 on the ``--boxes`` city (10,000 boxes: 40,008 walls) at 131,072 x 6 x
  4 frames, ``early_out`` on and off, and K7 on the same city with 8 bands;
* ``base`` once more with the work counters on (``work_counts=``).

It also prints the work counts (wall tests, sweeps, slab tests) of each call
from ``base`` and each variant's ptxas line (registers, spills) of the
kernels.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_profile_ablate.py [--rooms 1024] [--boxes 10000]
"""

import argparse
import os
import re
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, T = 48000, 72000
RAYS, BOUNCES, FRAMES = 15000, 5, 8
N_SOURCES = 64
CITY = dict(n_rays=131072, max_bounces=6, sample_rate=16000, ir_length=24000)
CITY_FRAMES, CITY_GAIN = 4, 100.0

FASTDIV = (r"= (.*) / safe;", r"= __fdividef(\1, safe);")
NOATOMIC = (r"if \(q\) atomicAdd\(bin \+ k, q\);", "if (q) bin[k] = q;")
GAIN1 = (r"return fmaxf\(g, 0\.0f\);", "return 1.0f;")
CSE = ((r"const float cos_t = fmaxf\(enx \* \(tx / dist_l\) \+ eny \* "
        r"\(ty / dist_l\),\s*0\.0f\);",
        "const float ux = tx / dist_l, uy = ty / dist_l;\n"
        "      const float cos_t = fmaxf(enx * ux + eny * uy, 0.0f);"),
       (r"fourier_gain\(-\(tx / dist_l\), -\(ty / dist_l\),",
        "fourier_gain(-ux, -uy,"))
GAINUNROLL = (r"\n  for \(int n = 1; n <= m; \+\+n\) \{",
              "\n#pragma unroll 4\n  for (int n = 1; n <= m; ++n) {")
VARIANTS = {"base": (), "fastdiv": (FASTDIV,), "noatomic": (NOATOMIC,),
            "gain1": (GAIN1,), "cse": CSE, "gainunroll": (GAINUNROLL,),
            "fastdiv+noatomic": (FASTDIV, NOATOMIC),
            **{f"blocks{n}": ((r"__launch_bounds__\(kThreads\)",
                               f"__launch_bounds__(kThreads, {n})"),)
               for n in (2, 4)},
            **{f"unroll{n}": ((r"#pragma unroll 4\n  for \(int j = 0; j < "
                               r"count", f"#pragma unroll {n}\n  for (int j "
                               "= 0; j < count"),) for n in (2, 8)},
            **{f"accel{n}": ((r"__launch_bounds__\(kAccelThreads\)",
                              f"__launch_bounds__(kAccelThreads, {n})"),)
               for n in (3, 5)}}


def make_variant(src_dir, name, edits):
    """Copy ``src_dir`` to ``build/ablate/<name>/csrc`` with ``edits``
    (regex, replacement) applied to every file; each edit must match."""
    dst = os.path.join(HERE, "build", "ablate", name.replace("+", "_"),
                       "csrc")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src_dir, dst)
    for pattern, repl in edits:
        hits = 0
        for fname in os.listdir(dst):
            path = os.path.join(dst, fname)
            with open(path) as f:
                text = f.read()
            text, n = re.subn(pattern, repl, text)
            hits += n
            with open(path, "w") as f:
                f.write(text)
        if hits == 0:
            raise SystemExit(f"ablation {name}: {pattern!r} matched nothing")
    return dst


def device_ms(torch, fn, reps, name):
    """Device milliseconds per call of the kernels whose name holds
    ``name``, over ``reps`` calls (profiler), or None."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name]
        if us:
            return sum(us) / reps / 1e3
    return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rooms", type=int, default=1024)
    ap.add_argument("--boxes", type=int, default=10000)
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants to build beside base (default: all)")
    ap.add_argument("--layouts", nargs="*", default=(),
                    help="cluster layouts to time K8 under, as SIZExGROUP")
    ap.add_argument("--directive", action="store_true",
                    help="time the directive kernels (cardioid source, "
                         "figure-eight microphone)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    from pathlib import Path

    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch.models.scene import Scene
    from realisticaudioraytracing2d_tpu_torch.ops import accel
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        accel_kernel as ak
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        bounce_kernel as bk
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_ablate: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    kw = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR, ir_length=T)

    scenes, src, lis = art.rooms.random_rooms(args.rooms, seed=0, device=dev)
    smoll = art.rooms.smoll_room(device=dev)
    smoll_p = art.TraceParams.make(smoll.source, smoll.listener, device=dev)
    g = np.random.default_rng(11)
    sources = np.stack([g.uniform(-15, 15, N_SOURCES),
                        g.uniform(-3, 8, N_SOURCES)], -1).astype(np.float32)
    ears = np.array([[-0.2, -3.68], [0.2, -3.68]], np.float32)
    mix_p = art.TraceParams.make(sources, ears, device=dev)
    shared = Scene(*(x[None] for x in smoll.scene))
    mix_kw = dict(listener_radius=mix_p.listener_radius,
                  speed_of_sound=mix_p.speed_of_sound,
                  input_gain=mix_p.input_gain, **kw)
    city = art.rooms.city_scene(args.boxes, device=dev)
    banded = art.rooms.city_scene(args.boxes, n_bands=8, device=dev)
    city_p = art.TraceParams.make(city.source, city.listener,
                                  city.listener_radius, 343.0, CITY_GAIN,
                                  device=dev)
    pats = {}
    if args.directive:
        from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
        pats = dict(directivity=torch.as_tensor(np.pad(dv.cardioid(0.7),
                                                       (0, 2)), device=dev),
                    mic_directivity=torch.as_tensor(dv.figure_eight(0.3),
                                                    device=dev))
        smoll_p, city_p = (pp._replace(**pats) for pp in (smoll_p, city_p))
    print(f"patterns: {'directive' if pats else 'omni'}", flush=True)

    def calls(counts=None):
        c = {} if counts is None else {"work_counts": counts}
        return {
            "K9 sweep": (lambda: bk.trace_rooms_ir_mega(
                scenes, src, lis, 0, FRAMES, **kw, **pats, **c), 2,
                "frames_ir_kernel"),
            "K9 mixdown": (lambda: bk.trace_rooms_ir_mega(
                shared, mix_p.source, mix_p.listeners.expand(N_SOURCES, -1, 2),
                7, 1, **mix_kw, **pats, **c), 5, "frames_ir_kernel"),
            "K4 15k x 5": (lambda: bk.trace_frames_ir_mega(
                smoll.scene, smoll_p, 5, 1, **kw, **c), 10,
                "frames_ir_kernel"),
            "K4 131k x 8 x 8": (lambda: bk.trace_frames_ir_mega(
                smoll.scene, smoll_p, 5, 8, n_rays=131072, max_bounces=8,
                sample_rate=SR, ir_length=T, **c), 3, "frames_ir_kernel"),
            "K8 early_out": (lambda: ak.trace_frames_ir_accel_sorted(
                city.scene, city_p, 5, CITY_FRAMES, **CITY, **c), 2,
                "accel_bounce_kernel"),
            "K7 8 bands": (lambda: ak.trace_frames_ir_accel(
                banded.scene, city_p, 5, CITY_FRAMES, **CITY, **c), 1,
                "accel_bounce_kernel"),
            "K8 brute": (lambda: ak.trace_frames_ir_accel_sorted(
                city.scene, city_p, 5, CITY_FRAMES, early_out=False, **CITY,
                **c), 1, "accel_bounce_kernel"),
        }

    source_dir = build.SOURCE_DIR
    table = {}
    for name, edits in VARIANTS.items():
        if name != "base" and args.only is not None \
                and name not in args.only:
            continue
        build.SOURCE_DIR = Path(make_variant(str(source_dir), name, edits))
        build.load_library.cache_clear()
        secs = build.build()
        regs, entry = [], ""
        for ln in build.build_log().splitlines():
            if "Compiling entry" in ln:
                entry = re.sub(r".*_cu_[0-9a-f]{8}[0-9]+", "", ln)[:30]
            elif "registers" in ln and "fixed_to_float" not in entry:
                regs.append(f"{entry}: "
                            + re.search(r"Used (\d+ registers)", ln).group(1))
        print(f"[{name}] built in {secs:.1f} s; ptxas: " + " | ".join(regs),
              flush=True)
        table[name] = {k: device_ms(torch, fn, reps, kernel)
                       for k, (fn, reps, kernel) in calls().items()}
        print(f"[{name}] device ms per call: " + ", ".join(
            f"{k} {'not measured' if v is None else f'{v:.4f}'}"
            for k, v in table[name].items()), flush=True)
        if name == "base":
            counted = {}
            for k, (_, reps, kernel) in calls().items():
                n = torch.zeros(3, dtype=torch.int64, device=dev)
                fn = calls(n)[k][0]
                n.zero_()
                fn()
                torch.cuda.synchronize()
                work = [int(x) for x in n.cpu()]
                counted[k] = device_ms(torch, fn, reps, kernel)
                print(f"[base] {k}: {work[0]} wall tests, {work[1]} sweeps, "
                      f"{work[2]} slab tests; with the counters on "
                      f"{counted[k]:.4f} ms", flush=True)
            port_layout = accel.accel_layout
            for text in args.layouts:
                layout = tuple(int(x) for x in text.split("x"))
                accel.accel_layout = lambda n, layout=layout: layout
                n = torch.zeros(3, dtype=torch.int64, device=dev)
                calls(n)["K8 early_out"][0]()
                torch.cuda.synchronize()
                work = [int(x) for x in n.cpu()]
                fn, reps, kernel = calls()["K8 early_out"]
                print(f"[base] K8 early_out under layout {text}: "
                      f"{device_ms(torch, fn, reps, kernel):.4f} ms; "
                      f"{work[0]} wall tests, {work[2]} slab tests",
                      flush=True)
            accel.accel_layout = port_layout
    build.SOURCE_DIR = source_dir
    build.load_library.cache_clear()
    base = table["base"]
    for name, row in table.items():
        if name != "base":
            print(f"{name} / base: " + ", ".join(
                f"{k} {row[k] / base[k]:.3f}" for k in row
                if row[k] and base[k]), flush=True)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
