#!/usr/bin/env python3
"""The redesigned wall sweeps K1 and K2 of the PyTorch port against the
brute-force sweep they replace, on one NVIDIA GPU.

K1 (``nearest_hit``) and K2 (``occlusion_min``) swept every ray against
every wall, one thread a ray (``wall_sweep_kernel``). Now they skip what
no caller reads (``alive``; K2's ``limit``: each shadow ray only up to
its listener) and, past ``BOX_WALK_MIN_WALLS`` walls, take the box walk
(``box_sweep_kernel``: K8's warp walk over the cached sorted tables of
``accel_kernel.prepare``, the rays sorted once per call).

Runs the same calls through two checkouts of the repository: ``--parent
DIR`` (a checkout of the commit before the redesign, e.g. ``git archive``
of it unpacked under ``build/``) and the checkout this script lives in,
each in processes of its own that import that checkout's package and
build its kernels, in the order parent, change, change, parent. The
inputs are the rays of a real trace (Philox seed 20, ``_emit`` and
``_bounce``) at bounce 0 and before bounce 3, and the shadow rays
``_bounce`` makes of them (its NEE mask and listener limits): K1 and K2
at 15,000 rays on SmollRoom (one listener, ``cli trace --scene-out``'s
rays), at 131,072 rays on the 10,008-, 40,008- and 100,016-wall cities
(two listeners); ``diffraction_ir`` at orders 1 and 2 on SmollRoom with a
barrier (three listeners); ``engine.trace_hits`` on the 10,008-wall city
with two listeners (15,000 x 5). The parent's K1/K2 get no mask and no
limit; the change runs as its callers call it. For each call: the device
ms of the sweep kernels per call (profiler, median of three readings),
the call's device-busy ms (the ray sort included) and CUDA-event ms, the
work counts (wall tests, sweeps, slab tests; the parent's follow from the
shapes: every wall for every ray), and hashes of the outputs where the
contracts agree: the unmasked rays, K2 below its limit (``hash``), and
every output of a call with neither argument (``full``).

The change's checkout also times, at 15,000 and 131,072 rays before
bounce 3, both routes of each kernel on SmollRoom, Big Room,
``city_scene(62)``, ``(250)``, ``(1200)``, ``(2500)`` and the two large
cities (the crossover that sets ``BOX_WALK_MIN_WALLS``); the box walk
without its ray sort (the keys replaced by zeros: the caller's order) at
bounce 0 and before bounce 3; and, through edited copies of its sources
under ``build/ablate/`` built into libraries of their own, the brute
sweep at one lane a ray at any grid (the design before its lane groups
of 4) and that sweep with its tiles staged by a double-buffered
``cp.async``. Every process prints the ptxas line of each instantiation
of its build; the script checks that both checkouts, both routes and all
copies give the same bits where the contracts agree.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_redesign_k1_k2.py --parent build/parent \\
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

LATER = 3
CITIES = {"city 10,008": 2500, "city 40,008": 10000, "city 100,016": 25002}
CROSS_SCENES = ("smoll", "big", 62, 250, 1200, 2500, 10000, 25002)
CROSS_RAYS = (15000, 131072)
SWEEP = "sweep_kernel"        # wall_sweep_kernel and box_sweep_kernel

# The brute sweep at one lane a ray with its tiles staged by cp.async into
# two buffers: tile t + 1 is in flight while tile t is scanned (40 KB of
# static shared memory: two tiles of geo float4 + cc).
_CP_ASYNC = r'''__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ WallTable stage_async(const float* rows,
                                                 int stride, int first,
                                                 int count, float* smem) {
  float4* geo = reinterpret_cast<float4*>(smem);
  float* cc = smem + 4 * kTileWalls;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    float* g = reinterpret_cast<float*>(geo + i);
    for (int f = 0; f < 4; ++f)
      cp_async4(g + f, rows + f * stride + first + i);
    cp_async4(cc + i, rows + CC * stride + first + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return {geo, cc, nullptr, count};
}

template <bool kWantIndex, int kLanes>
__global__ void __launch_bounds__(kSweepThreads) wall_sweep_kernel(
    SweepRays rays, const float* __restrict__ walls, int n_walls,
    float* __restrict__ tmin, int* __restrict__ idx,
    unsigned long long* __restrict__ work_out) {
  __shared__ float4 s_walls[2][kGeoFields * kTileWalls / 4];
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = ray < rays.n;
  const bool live = in_range && (rays.alive == nullptr || rays.alive[ray]);
  float ox = 0.0f, oy = 0.0f, dx = 1.0f, dy = 0.0f, limit = kInf;
  if (live) {
    ox = rays.origins[2 * ray];
    oy = rays.origins[2 * ray + 1];
    dx = rays.dirs[2 * ray];
    dy = rays.dirs[2 * ray + 1];
    if (rays.limit != nullptr) limit = rays.limit[ray];
  }
  const Probe q = make_probe(ox, oy, dx, dy);
  float closest = fminf(limit, kInf);
  int hit = 0;
  if (__syncthreads_or(live)) {
    WallTable next = stage_async(walls, n_walls, 0, min(kTileWalls, n_walls),
                                 reinterpret_cast<float*>(s_walls[0]));
    for (int base = 0, t = 0; base < n_walls; base += kTileWalls, ++t) {
      const WallTable tile = next;
      const int after = base + kTileWalls;
      if (after < n_walls) {
        next = stage_async(walls, n_walls, after,
                           min(kTileWalls, n_walls - after),
                           reinterpret_cast<float*>(s_walls[(t + 1) & 1]));
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      if (live) {
        const float before = closest;
        int best = 0x7fffffff;
        scan_nearest(tile, 0, tile.n, q, closest, best);
        if (kWantIndex && closest < before) hit = base + best;
      }
      __syncthreads();   // the buffer is free for the tile after next
    }
  }
  if (in_range) store_sweep<kWantIndex>(tmin, idx, ray, closest, limit, hit);
  if (work_out != nullptr) {
    Work work;
    if (live) {
      work.tests = n_walls;
      work.sweeps = 1;
    }
    add_work(work, work_out);
  }
}
'''
_BRUTE = (r"(?s)template <bool kWantIndex, int kLanes>\n__global__ void "
          r"__launch_bounds__\(kSweepThreads\) wall_sweep_kernel\(.*?\n}\n")
# one lane a ray at any grid: the brute sweep before lane groups
_ONE_LANE = (r"const long long threads = static_cast<long long>\(n_rays\) "
             r"\* lanes;", "lanes = 1;\n  const long long threads = n_rays;")
VARIANTS = {
    "brute_lanes1": (_ONE_LANE,),
    "brute_cp_async": (_ONE_LANE, (_BRUTE, _CP_ASYNC.replace("\\", "\\\\")))}
# scenes and ray counts each copy is timed on (brute route), at bounce 3
VARIANT_SHAPES = {"brute_lanes1": (("smoll", 15000), ("big", 15000),
                                   (250, 15000)),
                  "brute_cp_async": ((250, 15000), (250, 131072),
                                     (1200, 131072))}


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


def _digest(*xs):
    h = hashlib.sha1()
    for x in xs:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(root, role, dirs):
    """Time every call through the package of checkout ``root``; return
    {call: {"ms", "device_ms", "busy_ms", "hash", "full", "work"}}."""
    sys.path.insert(0, root)
    import torch
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch import engine
    from realisticaudioraytracing2d_tpu_torch.ops import diffraction as dfr
    from realisticaudioraytracing2d_tpu_torch.ops import rng
    from realisticaudioraytracing2d_tpu_torch.ops import trace as tt
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        trace_kernel as tk
    from realisticaudioraytracing2d_tpu_torch.ops.geometry import EPS, dot2
    sys.path.insert(0, root)
    from chip_smoke import free_spot
    build.build()
    dev = torch.device("cuda")
    change = role == "change"
    if change:
        from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
            accel_kernel as ak

    def readings(fn, reps, name):
        """(kernel ms, busy ms) per call: the median of three profiles."""
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

    def measure(fn, reps, digest, name=SWEEP, work=None):
        out = fn()
        torch.cuda.synchronize()
        kern, busy = readings(fn, reps, name)
        res = dict(ms=event_ms(fn, reps), device_ms=kern, busy_ms=busy,
                   hash=digest(out))
        if work is not None:
            res["work"] = work()
        return res

    def work_of(fn):
        w = torch.zeros(3, dtype=torch.int64, device=dev)
        fn(work_counts=w)
        torch.cuda.synchronize()
        return [int(x) for x in w.cpu()]

    def scene_of(which):
        if which == "smoll":
            room = art.rooms.smoll_room(device=dev)
        elif which == "big":
            room = art.rooms.big_room(device=dev)
        else:
            room = art.rooms.city_scene(which, device=dev)
        lis = torch.as_tensor(room.listener, device=dev)[None]
        if not isinstance(which, str):   # a second listener in the open
            lis = torch.cat([lis, free_spot(room.scene, torch.as_tensor(
                room.source, device=dev))[None]])
        gain = 100.0 if which != "smoll" else 1.0
        return room.scene, tt.TraceParams.make(
            room.source, lis, getattr(room, "listener_radius", 0.5), 343.0,
            gain, device=dev)

    def states(scene, p, n_rays):
        """The trace's ray states at bounce 0 and before bounce LATER."""
        emit, u = rng.philox_uniforms(20, 1, LATER, n_rays, dev)
        walls = tk.sweep_walls(scene) if change else tk.pack_walls(scene)
        st = tt._emit(p, n_rays, scene.n_bands, emit[0])
        first = st
        for b in range(LATER):
            st, _ = tt._bounce(scene, p, st, u[0, b], walls)
        return {0: first, LATER: st}

    def shadow(scene, p, st, packed):
        """_bounce's shadow rays of state ``st``: origins, directions
        [R, L, 2], the NEE mask and the limits [R, L]."""
        closest, idx = tk.nearest_hit(st.pos, st.dir, packed)
        hit_wall = (idx >= 0) & st.alive
        adv = torch.where(hit_wall, closest, 0.0)
        pos = st.pos + st.dir * adv[:, None]
        widx = torch.where(hit_wall, idx, 0).long()
        w_n = scene.normal[widx]
        src = pos + w_n * EPS
        lis = p.listeners
        to_lis = lis[None] - pos[:, None]
        dist_lis = torch.sqrt(torch.clamp(dot2(to_lis, to_lis), min=1e-20))
        vis_dir = (lis[None] - src[:, None]) / dist_lis[..., None]
        eff = w_n * torch.where(dot2(st.dir, w_n) > 0.0, -1.0, 1.0)[:, None]
        unit = to_lis / dist_lis[..., None]
        cos_t = torch.clamp(dot2(eff[:, None], unit), min=0.0)
        total = (st.dist + adv)[:, None] + dist_lis
        geom = cos_t * 0.5 / (total * total)
        e = st.energy[:, None, :] * (1.0 - scene.absorption[widx])[:, None] \
            * geom[..., None]
        heard = hit_wall[:, None] & (st.depth == 0)[:, None] \
            & (e.amax(dim=-1) > tt.NEE_CONTRIB_CUTOFF)
        return (src[:, None].expand_as(vis_dir).contiguous(),
                vis_dir.contiguous(), heard, dist_lis - tt.OCCLUSION_SLACK)

    res = {"ptxas": ptxas(build.build_log())}
    # K1 and K2 at the main path's shapes: parent unmasked, change as called
    shapes = [("SmollRoom 15k", "smoll", 15000)] + [
        (f"{name} 131k", n, 131072) for name, n in CITIES.items()]
    for label, which, n_rays in shapes:
        scene, p = scene_of(which)
        packed = tk.pack_walls(scene)
        walls = tk.sweep_walls(scene) if change else packed
        reps = 10 if n_rays < 20000 else 3
        for at, st in states(scene, p, n_rays).items():
            o, d, alive = st.pos, st.dir, st.alive
            so, sd, heard, limit = shadow(scene, p, st, packed)
            n_l = p.listeners.shape[0]
            k1_full = tk.nearest_hit(o, d, walls)
            k2_full = tk.occlusion_min(so, sd, walls)
            if change:
                def k1(**kw):
                    return tk.nearest_hit(o, d, walls, alive, **kw)

                def k2(**kw):
                    return tk.occlusion_min(so, sd, walls, heard, limit,
                                            **kw)
                w1, w2 = work_of(k1), work_of(k2)
            else:
                def k1():
                    return tk.nearest_hit(o, d, walls)

                def k2():
                    return tk.occlusion_min(so, sd, walls)
                w1 = [n_rays * scene.n_walls, n_rays, 0]
                w2 = [n_rays * n_l * scene.n_walls, n_rays * n_l, 0]
            key = f"{label} x {scene.n_walls} walls, bounce {at}"
            res[f"K1 {key}"] = measure(
                k1, reps, lambda r: _digest(r[0][alive], r[1][alive]),
                work=lambda: w1)
            res[f"K1 {key}"]["full"] = _digest(*k1_full)
            res[f"K1 {key}"]["live"] = int(alive.sum())
            shown = heard & (k2_full < limit)
            res[f"K2 {key}"] = measure(
                k2, reps, lambda r: _digest(r[heard & (r < limit)]),
                work=lambda: w2)
            res[f"K2 {key}"]["full"] = _digest(k2_full)
            res[f"K2 {key}"]["live"] = int(heard.sum())
            res[f"K2 {key}"]["blocked"] = int(shown.sum())
            del so, sd, heard, limit, k1_full, k2_full
        torch.cuda.empty_cache()
    # diffraction on SmollRoom with a barrier, three listeners
    room = art.rooms.smoll_room(device=dev)
    room.builder.add_segment((-18.0, 6.0), (-15.0, 6.0), (0.0, 1.0),
                             art.AudioMaterial(0.9, 0.5, 0.0, 1.0))
    scene_e = room.builder.build(device=dev)
    p_e = tt.TraceParams.make(room.source, [[-0.1, -3.68], [0.1, -3.68],
                                            [-16.0, 3.0]], device=dev)
    for order in (1, 2):
        res[f"diffraction_ir order {order}"] = measure(
            lambda: dfr.diffraction_ir(scene_e, p_e, order=order,
                                       sample_rate=48000, ir_length=72000),
            10, _digest)
    # the user path: hit records on the city, two listeners, 15,000 x 5
    scene, p = scene_of(2500)
    emit, u = rng.philox_uniforms(22, 1, 5, 15000, dev)
    res["engine.trace_hits city 10,008, 2 listeners, 15k x 5"] = measure(
        lambda: engine.trace_hits(scene, p, emit[0], u[0]), 3,
        lambda h: _digest(h.valid, h.delay[h.valid], h.energy[h.valid]))
    if change:
        cross(res, locals())
    res["card"] = torch.cuda.get_device_name(0)
    return res


def cross(res, c):
    """The change's own readings: both routes by scene and ray count, the
    box walk without its sort, the edited copies of the brute sweep."""
    torch, tk, ak, build = c["torch"], c["tk"], c["ak"], c["build"]
    scene_of, states, shadow = c["scene_of"], c["states"], c["shadow"]
    measure, work_of = c["measure"], c["work_of"]
    from pathlib import Path
    inputs = {}

    def sweeps(which, n_rays, at=LATER):
        if (which, n_rays, at) not in inputs:
            scene, p = scene_of(which)
            st = states(scene, p, n_rays)[at]
            packed = tk.pack_walls(scene)
            inputs[which, n_rays, at] = (
                scene, packed, (st.pos, st.dir, st.alive),
                shadow(scene, p, st, packed))
        return inputs[which, n_rays, at]

    def both(label, walls, rays, shadows, reps):
        o, d, alive = rays
        so, sd, heard, limit = shadows
        k1 = (lambda **kw: tk.nearest_hit(o, d, walls, alive, **kw))
        k2 = (lambda **kw: tk.occlusion_min(so, sd, walls, heard, limit,
                                            **kw))
        res[f"K1 {label}"] = measure(
            k1, reps, lambda r: _digest(r[0][alive], r[1][alive]),
            work=lambda: work_of(k1))
        res[f"K2 {label}"] = measure(
            k2, reps, lambda r: _digest(r[heard & (r < limit)]),
            work=lambda: work_of(k2))

    for which in CROSS_SCENES:
        for n_rays in CROSS_RAYS:
            scene, packed, rays, shadows = sweeps(which, n_rays)
            prep = ak.prepare(scene)
            reps = 10 if n_rays < 20000 else 3
            for route, walls in (("brute", tk.SweepWalls(packed)),
                                 ("box", tk.SweepWalls(packed, prep))):
                both(f"cross {which} {n_rays} x {scene.n_walls} walls "
                     f"bounce {LATER} [{route}]", walls, rays, shadows, reps)
        inputs.clear()
        torch.cuda.empty_cache()
    # the box walk in the caller's order (no sort) against the sorted one
    keys = tk.ray_keys
    for which in (2500, 10000):
        for at in (0, LATER):
            scene, packed, rays, shadows = sweeps(which, 131072, at)
            walls = tk.SweepWalls(packed, ak.prepare(scene))
            for how in ("sorted", "no sort"):
                if how == "no sort":
                    tk.ray_keys = (lambda o2, *a: torch.zeros(
                        o2.shape[0], dtype=torch.int64, device=o2.device))
                both(f"sort {which} 131072 x {scene.n_walls} walls bounce "
                     f"{at} [{how}]", walls, rays, shadows, 3)
                tk.ray_keys = keys
        inputs.clear()
    # the edited copies of the brute sweep, each through its own library
    source_dir = build.SOURCE_DIR
    for name, src in c["dirs"].items():
        build.SOURCE_DIR = Path(src)
        build.load_library.cache_clear()
        res[f"ptxas {name}"] = ptxas(build.build_log())
        for which, n_rays in VARIANT_SHAPES[name]:
            scene, packed, rays, shadows = sweeps(which, n_rays)
            reps = 10 if n_rays < 20000 else 3
            for lib in ("kept", name):
                build.SOURCE_DIR = source_dir if lib == "kept" else Path(src)
                build.load_library.cache_clear()
                both(f"copy {which} {n_rays} x {scene.n_walls} walls bounce "
                     f"{LATER} [{lib}]", tk.SweepWalls(packed), rays,
                     shadows, reps)
    build.SOURCE_DIR = source_dir
    build.load_library.cache_clear()


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
          "sweep kernels per call (median of three profiles) [busy ms, "
          "call ms]; readings of each run; work: wall tests, sweeps, slab "
          "tests", flush=True)
    for role in runs:
        for key in [k for k in (runs[role] or [{}])[0]
                    if k.startswith("ptxas")]:
            print(f"{key} ({role}): " + " | ".join(runs[role][0][key]),
                  flush=True)
    ok = True
    groups = {}
    for key in [k for k in runs["change"][0] if k != "card"
                and not k.startswith("ptxas")]:
        line = f"{key}:"
        for role in ("parent", "change"):
            rs = [r[key] for r in runs[role] if key in r]
            if rs:
                line += (f" {role} " + " / ".join(
                    f"{r['device_ms']:.4f} [{r['busy_ms']:.4f}, "
                    f"{r['ms']:.4f}]" for r in rs))
        found = [r[key] for role in runs for r in runs[role] if key in r]
        hashes = {f["hash"] for f in found}
        fulls = {f["full"] for f in found if "full" in f}
        works = {role: sorted({tuple(r[key]["work"]) for r in runs[role]
                               if key in r and "work" in r[key]})
                 for role in runs}
        extra = "".join(f"; {k} {found[-1][k]}" for k in ("live", "blocked")
                        if k in found[-1])
        line += (f"; bits equal across runs and checkouts: "
                 f"{len(hashes) == 1 and len(fulls) <= 1}; work {works}"
                 + extra)
        ok &= len(hashes) == 1 and len(fulls) <= 1
        base = key.split(" [")[0]
        if base != key:
            groups.setdefault(base, set()).add(found[0]["hash"])
        print(line, flush=True)
    for base, hashes in groups.items():
        print(f"{base}: the same bits on every route and copy: "
              f"{len(hashes) == 1}", flush=True)
        ok &= len(hashes) == 1
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, runs=runs), f)
    if not ok:
        raise SystemExit("bits differ")


if __name__ == "__main__":
    main()
