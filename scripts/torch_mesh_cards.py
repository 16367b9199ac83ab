#!/usr/bin/env python3
"""The device-mesh paths over every card of a host (two or more): each
sharded function of ``parallel/`` on ``make_mesh()`` against its
unsharded run on the first card, and both timed.

    python3 scripts/torch_mesh_cards.py [--out cards.json]

Checks, as ``chip_smoke.py``'s phase 17 does on a virtual mesh of one
card: the sweep at ``cli sweep``'s defaults (1,024 rooms, 15,000 x 5 x 8
frames, 72,000 bins) == ``sweep_rooms`` bit for bit with one K9 launch a
card; the 64-source stereo mixdown within 1e-6 of the peak; 8 frames of
SmollRoom at 131,072 x 8 within the fixed point of
``trace_accumulate``; 8 frames of the 10,008-wall city at 15,000 x 5
(one K8 call of ``max_bounces`` launches a card, ``frame_offset`` the
card's first frame) within the fixed point of the unsharded K8 call;
131,072 rays == the sum of K4's entries traced on the first card, bit
for bit; the time-sharded convolution within 1e-5 of
the peak; ``localize_source(mesh=)`` == ``mesh=None`` start by start;
``cli sweep --sharded`` (which splits the rooms here) == the run without
the flag. Times: wall clock over calls that end with every card
synchronized (the median of 5 after a warm-up). Any failed check raises.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import realisticaudioraytracing2d_tpu_torch as art  # noqa: E402
from realisticaudioraytracing2d_tpu_torch import cli, diff  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.engine import \
    trace_accumulate  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.materials import \
    AudioMaterial  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops.cuda import (  # noqa: E402
    accel_kernel as ak, bounce_kernel as bk, build)
from realisticaudioraytracing2d_tpu_torch.parallel import (  # noqa: E402
    frames, multisource, rays, seq)
from realisticaudioraytracing2d_tpu_torch.parallel.mesh import \
    make_mesh  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.parallel.sweep import (  # noqa: E402
    sweep_rooms, sweep_rooms_sharded)

SR, T, RAYS, BOUNCES = 48000, 72000, 15000, 5
BIG_RAYS, BIG_BOUNCES = 131072, 8


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def wall_ms(fn, reps=5):
    """Median wall milliseconds of ``fn`` with every card synchronized."""
    fn()
    sync_all()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync_all()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        raise SystemExit(f"torch_mesh_cards: needs two or more CUDA "
                         f"devices, found {n}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().replace("\n", " | ")
    print(f"{n} cards: {card}", flush=True)
    build.load_library()
    dev = torch.device("cuda", 0)
    rooms_mesh = make_mesh()
    rays_mesh = make_mesh((1, n))
    one = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR, ir_length=T)
    out = {"cards": card, "n": n}

    # the sweep: one K9 launch a card, the unsharded bits
    scenes, src, lis = art.rooms.random_rooms(1024, seed=0, device=dev)
    kw = dict(n_frames=8, **one)
    bk.trace_rooms_ir_mega.launches = 0
    sharded = sweep_rooms_sharded(scenes, src, lis, 0, rooms_mesh, **kw)
    sync_all()
    launches = bk.trace_rooms_ir_mega.launches
    whole = sweep_rooms(scenes, src, lis, 0, **kw)
    check(launches == n and torch.equal(sharded, whole),
          f"sweep: {launches} launches, equal {torch.equal(sharded, whole)}")
    out["sweep_ms"] = {
        "sharded": wall_ms(lambda: sweep_rooms_sharded(
            scenes, src, lis, 0, rooms_mesh, **kw)),
        "unsharded": wall_ms(lambda: sweep_rooms(scenes, src, lis, 0,
                                                 **kw))}
    print(f"sweep, 1,024 rooms over {n} cards: {launches} K9 launches, == "
          f"sweep_rooms bit for bit; ms {out['sweep_ms']}", flush=True)
    del sharded, whole

    # the mixdown over the "rays" axis
    g = np.random.default_rng(11)
    sources = np.stack([g.uniform(-15, 15, 64), g.uniform(-3, 8, 64)],
                       -1).astype(np.float32)
    ears = np.array([[-0.2, -3.68], [0.2, -3.68]], np.float32)
    smoll = art.rooms.smoll_room(device=dev)
    mix_p = art.TraceParams.make(sources, ears, device=dev)
    mixed = multisource.trace_sources_mixdown_sharded(smoll.scene, mix_p, 7,
                                                      rays_mesh, **one)
    unmixed = multisource.trace_sources_mixdown(smoll.scene, mix_p, 7, **one)
    gap = float((mixed - unmixed).abs().max() / unmixed.abs().max())
    check(gap <= 1e-6, f"mixdown gap {gap}")
    out["mix_ms"] = {
        "sharded": wall_ms(lambda: multisource.trace_sources_mixdown_sharded(
            smoll.scene, mix_p, 7, rays_mesh, **one)),
        "unsharded": wall_ms(lambda: multisource.trace_sources_mixdown(
            smoll.scene, mix_p, 7, **one))}
    print(f"mixdown, 64 sources over {n} cards: gap {gap:.2e} of the peak; "
          f"ms {out['mix_ms']}", flush=True)

    # frames and rays
    p = art.TraceParams.make(smoll.source, smoll.listener, device=dev)
    big = dict(n_rays=BIG_RAYS, max_bounces=BIG_BOUNCES, sample_rate=SR)
    st0 = art.IRState.zeros(T, device=dev)
    n_frames = 8 if 8 % n == 0 else n
    sh = frames.accumulate_frames_sharded(smoll.scene, p, st0, 2024,
                                          rooms_mesh, n_frames=n_frames,
                                          **big)
    un = trace_accumulate(smoll.scene, p, st0, n_frames=n_frames, seed=2024,
                          **big)
    res = 1.0 / float(bk.fixed_point_scale(p, n_frames, BIG_RAYS,
                                           BIG_BOUNCES))
    limit = n_frames * BIG_RAYS * 2 * BIG_BOUNCES * res + 1e-6 * un.sum.abs()
    check(bool(((sh.sum - un.sum).abs() <= limit).all()),
          "frames: within the fixed point")
    ray_kw = dict(n_rays=BIG_RAYS, max_bounces=BIG_BOUNCES, sample_rate=SR,
                  ir_length=T)
    ray_ir = rays.trace_rays_sharded(smoll.scene, p, 77, rays_mesh, **ray_kw)
    parts = [bk.trace_frames_ir_mega(smoll.scene, p, 77, 1,
                                     n_rays=BIG_RAYS // n,
                                     max_bounces=BIG_BOUNCES, sample_rate=SR,
                                     ir_length=T, entry=d) for d in range(n)]
    check(torch.equal(ray_ir, sum(parts[1:], parts[0])),
          "rays: == the entries on the first card")
    out["frames_ms"] = {
        "sharded": wall_ms(lambda: frames.accumulate_frames_sharded(
            smoll.scene, p, st0, 2024, rooms_mesh, n_frames=n_frames, **big)),
        "unsharded": wall_ms(lambda: trace_accumulate(
            smoll.scene, p, st0, n_frames=n_frames, seed=2024, **big))}
    print(f"frames, {n_frames} over {n} cards: within the fixed point; "
          f"rays, {BIG_RAYS} over {n} cards == K4's entries on cuda:0 bit "
          f"for bit; frames ms {out['frames_ms']}", flush=True)

    # frames of the 10,008-wall city: K8 at a frame offset on every card
    city = art.rooms.city_scene(2500, device=dev)
    p9 = art.TraceParams.make(city.source, city.listener,
                              city.listener_radius, 343.0, 100.0,
                              device=dev)
    city_kw = dict(n_rays=RAYS, max_bounces=BOUNCES, sample_rate=SR)
    ak.trace_frames_ir_accel_sorted.launches = 0
    c_sh = frames.accumulate_frames_sharded(city.scene, p9, st0, 2024,
                                            rooms_mesh, n_frames=n_frames,
                                            **city_kw)
    sync_all()
    launches = ak.trace_frames_ir_accel_sorted.launches
    c_un = ak.trace_frames_ir_accel_sorted(city.scene, p9, 2024, n_frames,
                                           ir_length=T, **city_kw)
    res = 1.0 / float(bk.fixed_point_scale(p9, n_frames, RAYS, BOUNCES))
    limit = n_frames * RAYS * 2 * BOUNCES * res + 1e-6 * c_un.abs()
    check(launches == n * BOUNCES and float(c_un.sum()) > 0
          and bool(((c_sh.sum - c_un).abs() <= limit).all()),
          f"city frames: {launches} K8 launches, within the fixed point")
    out["city_frames_ms"] = {
        "sharded": wall_ms(lambda: frames.accumulate_frames_sharded(
            city.scene, p9, st0, 2024, rooms_mesh, n_frames=n_frames,
            **city_kw)),
        "unsharded": wall_ms(lambda: ak.trace_frames_ir_accel_sorted(
            city.scene, p9, 2024, n_frames, ir_length=T, **city_kw))}
    print(f"city frames, {city.scene.n_walls} walls, {n_frames} over {n} "
          f"cards: {launches} K8 launches, within the fixed point of the "
          f"unsharded K8 call; ms {out['city_frames_ms']}", flush=True)
    del c_sh, c_un

    # time, starts, the CLI
    gen = torch.Generator(device=dev).manual_seed(4)
    dry = torch.randn(10 * SR, generator=gen, device=dev)
    ir = torch.randn(T, generator=gen, device=dev)
    conv = seq.convolve_seq_sharded(dry, ir, rays_mesh, 3)
    ref = art.convolve.convolve_fft(dry, ir, 3)
    c_gap = float((conv - ref).abs().max() / ref.abs().max())
    check(c_gap < 1e-5, f"convolution gap {c_gap}")
    box = art.rooms.shoebox_room(4.0, 4.0, wall_material=AudioMaterial(
        absorption=0.3, scattering=0.4), device=dev)
    p_box = art.TraceParams.make((-1.0, 0.4), (1.0, 0.3), device=dev)
    target = diff.simulate_ir(box, p_box, 0, n_rays=64, max_bounces=4,
                              sample_rate=8000, ir_length=512, soft=True,
                              device=dev)
    loc_kw = dict(n_rays=64, max_bounces=4, sample_rate=8000, steps=20,
                  n_starts=8 if 8 % n == 0 else n, device=dev)
    a = diff.localize_source(box, p_box, target, 3, **loc_kw)
    b = diff.localize_source(box, p_box, target, 3, mesh=rooms_mesh,
                             **loc_kw)
    check(torch.equal(a.positions, b.positions)
          and torch.equal(a.losses, b.losses), "localize: per start")
    npz = {}
    with tempfile.TemporaryDirectory() as tmp:
        for flag in ([], ["--sharded"]):
            path = os.path.join(tmp, f"s{len(flag)}.npz")
            bk.trace_rooms_ir_mega.launches = 0
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["sweep", "--rooms", "64", "--out", path, *flag])
            out[f"cli launches {flag}"] = bk.trace_rooms_ir_mega.launches
            with np.load(path) as z:
                npz[len(flag)] = {k: z[k] for k in z.files}
    check(out["cli launches ['--sharded']"] == n
          and all(np.array_equal(npz[0][k], npz[1][k]) for k in npz[0]),
          "cli sweep --sharded")
    print(f"convolution gap {c_gap:.2e} of the peak; localize == per start "
          f"over {n} cards; cli sweep --sharded: {n} K9 launches, the npz "
          "of the run without the flag", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
