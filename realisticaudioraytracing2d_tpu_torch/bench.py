"""Benchmark suite of the port: prints ONE JSON line with the headline
metric, the JAX package's bench (``bench.py`` at the root of the
repository) measured through this package.

Headline: ray-bounce intersection throughput per card, counted as the
JAX bench counts it (``n_rays * max_bounces * n_valid_walls * 2 *
n_frames``: the nearest-hit pass and the NEE occlusion pass, valid walls
only). ``vs_baseline`` is its ratio to the 100 M/s target of
BASELINE.json. The secondary diagnostics (frame times, IR scatter,
streaming x realtime, the stream chunk in four modes, the room sweep,
the large scenes) go to stderr, led by the device and, on the card, its
name and power limit.

The functions are the JAX bench's, under its names, with its size
parameters and defaults, plus ``device=None`` (the card by default,
:func:`.device.resolve`); each calls the library's normal entry point,
so on the card the hand kernels run (K4 in the trace, quad and stream
functions, K9 in the sweep, K8 in the large-scene one) and on the CPU
their plain versions. At these sizes the CPU takes hours: the tests run
them small.

Barriers: a CUDA device is synchronized (``torch.cuda.synchronize``)
where the JAX bench reads a scalar back; the CPU needs none. The call
structure is JAX's: one untimed first call (the kernels' build, cuFFT's
plans and the large scene's ``prepare`` happen there), a warm call
where JAX has one, then the timed calls. Keys become seeds: JAX's
``PRNGKey(0)`` is seed 0 and ``fold_in(key, i)`` is seed ``i``, so each
timed call draws fresh rays as JAX's does (the Philox stream of
:func:`.ops.rng.philox_uniforms`).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from .config import smoll_room_config
from .device import resolve
from .engine import Engine, trace_accumulate
from .models.rooms import city_scene, random_rooms, smoll_room
from .ops import ir as irm
from .ops.convolve import convolve_chunk_crossfade
from .ops.cuda.accel_kernel import trace_frames_ir_accel_sorted
from .ops.rng import philox_uniforms
from .ops.trace import TraceParams, trace_hits_only
from .parallel.sweep import sweep_rooms
from .streaming import Streamer

BASELINE = 100e6   # intersections/s (BASELINE.json's north-star target)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi not read ({e})"
    return out[0] if out else "nvidia-smi printed nothing"


def bench_trace(n_rays=131072, max_bounces=8, n_frames=50,
                sample_rate=48000, ir_length=72000, device=None):
    """SmollRoom padded to 32 walls: all ``n_frames`` frames in one call of
    ``engine.trace_accumulate`` (one K4 launch on the card), best of 3
    after a first and a warm call. Returns (intersection tests/s, ms per
    frame)."""
    dev = resolve(device)
    room = smoll_room(pad_to=32, device=dev)
    n_valid_walls = int(room.scene.n_valid)
    params = TraceParams.make(room.source, room.listener,
                              room.listener_radius, 343.0, 1.0, device=dev)

    def run(st, seed):
        return trace_accumulate(room.scene, params, st, n_rays=n_rays,
                                max_bounces=max_bounces,
                                sample_rate=sample_rate, n_frames=n_frames,
                                seed=seed)

    run(irm.IRState.zeros(ir_length, 1, 1, device=dev), 0)   # build
    _sync(dev)
    run(irm.IRState.zeros(ir_length, 1, 1, device=dev), 9)   # warm
    _sync(dev)
    dt = float("inf")
    for trial in range(3):
        state = irm.IRState.zeros(ir_length, 1, 1, device=dev)
        t0 = time.perf_counter()
        state = run(state, 1 + trial)
        _sync(dev)
        dt = min(dt, time.perf_counter() - t0)

    frame_ms = dt / n_frames * 1e3
    # nearest-hit pass + NEE occlusion pass, valid walls only (the
    # padding walls are swept but not counted)
    tests = n_rays * max_bounces * n_valid_walls * 2 * n_frames
    return tests / dt, frame_ms


def bench_quad(n_frames=50, sample_rate=48000, ir_length=72000,
               device=None):
    """Four listeners sharing every wall sweep, 15,000 x 5, ``n_frames``
    frames in one call (one K4 launch). Returns ms per frame."""
    dev = resolve(device)
    room = smoll_room(pad_to=32, device=dev)
    ears = np.asarray([[0.0, -3.68], [0.5, -3.68], [-6.0, 2.0],
                       [8.0, -1.0]], np.float32)
    params = TraceParams.make(room.source, ears, 0.5, 343.0, 1.0,
                              device=dev)

    def run(seed):
        return trace_accumulate(room.scene, params,
                                irm.IRState.zeros(ir_length, 4, 1,
                                                  device=dev),
                                n_rays=15000, max_bounces=5,
                                sample_rate=sample_rate, n_frames=n_frames,
                                seed=seed)

    run(0)
    _sync(dev)
    t0 = time.perf_counter()
    run(1)
    _sync(dev)
    return (time.perf_counter() - t0) / n_frames * 1e3


def bench_ir_build(n_frames=20, sample_rate=48000, ir_length=72000,
                   device=None):
    """IR scatter cost alone: ``ops/ir.py::scatter_hits`` of one frame's
    hit records (15,000 x 5, traced once by the plain trace on frame 0 of
    seed 0, untimed), ``n_frames`` times. Returns ms per scatter."""
    dev = resolve(device)
    room = smoll_room(pad_to=32, device=dev)
    params = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0,
                              device=dev)
    emit, u = philox_uniforms(0, 1, 5, 15000, dev)
    hits = trace_hits_only(room.scene, params, emit[0], u[0])
    _sync(dev)

    def scatter(h):
        return irm.scatter_hits(h, sample_rate, ir_length)

    scatter(hits)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_frames):
        scatter(hits)
    _sync(dev)
    return (time.perf_counter() - t0) / n_frames * 1e3


def bench_streaming_xrt(sample_rate=44100, reverb=1.5, chunk=0.1,
                        n_chunks=20, device=None):
    """The crossfaded chunk convolution alone (cuFFT on the card; no
    trace): seconds of audio per second. Returns x realtime."""
    dev = resolve(device)
    n = int(sample_rate * chunk)
    t = int(sample_rate * reverb)
    x = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, n),
                        dtype=torch.float32, device=dev)
    ir = torch.as_tensor(np.random.default_rng(1).uniform(0, 1e-3, t),
                         dtype=torch.float32, device=dev)
    convolve_chunk_crossfade(x, ir, ir, 1, 1)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        convolve_chunk_crossfade(x, ir, ir, 1, 1)
    _sync(dev)
    dt = time.perf_counter() - t0
    return (n_chunks * chunk) / dt


def bench_sweep(n_rooms=1024, n_rays=4096, max_bounces=6, ir_length=24000,
                device=None):
    """The room dataset: ``random_rooms(n_rooms, seed=0)`` through
    ``sweep_rooms`` (one K9 launch on the card), timed on its second call
    (seed 1). Returns rooms/s."""
    dev = resolve(device)
    scenes, sources, listeners = random_rooms(n_rooms, seed=0, device=dev)
    kw = dict(n_rays=n_rays, max_bounces=max_bounces, sample_rate=16000,
              ir_length=ir_length, n_frames=1)
    sweep_rooms(scenes, sources, listeners, 0, **kw)
    _sync(dev)
    t0 = time.perf_counter()
    sweep_rooms(scenes, sources, listeners, 1, **kw)
    _sync(dev)
    return n_rooms / (time.perf_counter() - t0)


def bench_stream_chunk(n_chunks=30, device=None):
    """The full streaming step (retrace, crossfaded convolution, ring
    overlap-add and drain) on SmollRoom at ``smoll_room_config()``, one K4
    launch a chunk, after a first and a warm chunk. Returns ms per
    0.1 s chunk (host clock)."""
    dev = resolve(device)
    room = smoll_room(pad_to=32, device=dev)
    cfg = smoll_room_config()
    p = Engine(room.scene, cfg).params(room.source, room.listener)
    streamer = Streamer(room.scene, cfg, 0)
    chunk = torch.zeros(cfg.audio.chunk_samples, dtype=torch.float32,
                        device=dev)
    chunk[0] = 1.0
    streamer.process(chunk, p)          # build
    _sync(dev)
    streamer.process(chunk, p)          # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        streamer.process(chunk, p)
    _sync(dev)
    return (time.perf_counter() - t0) / n_chunks * 1e3


def bench_stream_chunk_modes(n_chunks=30, device=None):
    """The stream chunk of the other modes, as :func:`bench_stream_chunk`:
    per-arrival Doppler (the history window of a 4-chunk looping clip),
    binaural (facing 0.3 rad; K4 at three virtual microphones), and the
    two composed. Returns the three ms per chunk."""
    dev = resolve(device)
    room = smoll_room(pad_to=32, device=dev)
    cfg = smoll_room_config()
    p = Engine(room.scene, cfg).params(room.source, room.listener)
    n = cfg.audio.chunk_samples
    dry = torch.as_tensor(np.random.default_rng(0)
                          .uniform(-1, 1, 4 * n).astype(np.float32),
                          device=dev)
    chunk = dry[:n]

    def run_mode(streamer, per_arrival, facing):
        def window(i):
            return streamer._window(dry, i, True) if per_arrival else None

        streamer.process(chunk, p, facing=facing, window=window(0))
        _sync(dev)
        streamer.process(chunk, p, facing=facing, window=window(1))
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(n_chunks):
            streamer.process(chunk, p, facing=facing, window=window(2 + i))
        _sync(dev)
        return (time.perf_counter() - t0) / n_chunks * 1e3

    pa = run_mode(Streamer(room.scene, cfg, 0), True, 0.0)
    bi = run_mode(Streamer(room.scene, cfg, 0, binaural=True), False, 0.3)
    bpa = run_mode(Streamer(room.scene, cfg, 0, binaural=True), True, 0.3)
    return pa, bi, bpa


def bench_accel(n_boxes=10000, n_rays=131072, max_bounces=6, device=None):
    """The large-scene path on ``city_scene(n_boxes)``: the sorted cluster
    kernel K8 (``trace_frames_ir_accel_sorted``, one launch a bounce) with
    and without its early-out, 4 frames, each timed on its second call
    (the first builds the scene's cluster tables, ``prepare``, cached per
    scene). JAX's ``cluster_size=128`` is a TPU tiling argument: the
    port's cluster layout is its own (``ops/accel.py``), and the count
    below does not depend on it. Returns (ms per call, brute-equivalent
    G tests/s, speedup over ``early_out=False``, walls)."""
    dev = resolve(device)
    room = city_scene(n_boxes=n_boxes, device=dev)
    params = TraceParams.make(room.source, room.listener,
                              room.listener_radius, 343.0, 100.0,
                              device=dev)
    n_frames = 4
    kw = dict(n_rays=n_rays, max_bounces=max_bounces, sample_rate=16000,
              ir_length=24000)

    def timed(**extra):
        trace_frames_ir_accel_sorted(room.scene, params, 0, n_frames, **kw,
                                     **extra)
        _sync(dev)
        t0 = time.perf_counter()
        trace_frames_ir_accel_sorted(room.scene, params, 1, n_frames, **kw,
                                     **extra)
        _sync(dev)
        return time.perf_counter() - t0

    t_brute = timed(early_out=False)
    t_accel = timed(early_out=True)
    tests = n_rays * max_bounces * 2 * room.scene.n_walls * n_frames
    return (t_accel * 1e3, tests / t_accel / 1e9, t_brute / t_accel,
            room.scene.n_walls)


def main(device=None):
    """Run every function at its defaults; the summary to stderr, the
    headline as the last line of stdout. Returns every number measured,
    unrounded, by name."""
    dev = resolve(device)
    said = (f"{torch.cuda.get_device_name(dev)} | {card_line()}"
            if dev.type == "cuda" else "the plain PyTorch versions")
    print(f"device={dev} ({said}) torch {torch.__version__}",
          file=sys.stderr)

    rps, frame_ms = bench_trace(device=dev)
    _, ref_frame_ms = bench_trace(n_rays=15000, max_bounces=5, device=dev)
    quad_ms = bench_quad(device=dev)
    ir_ms = bench_ir_build(device=dev)
    xrt = bench_streaming_xrt(device=dev)
    chunk_ms = bench_stream_chunk(device=dev)
    pa_ms, bi_ms, bpa_ms = bench_stream_chunk_modes(device=dev)
    rooms_s = bench_sweep(device=dev)
    accel_ms, accel_gts, accel_speedup, accel_walls = bench_accel(
        device=dev)
    # the early-out's speedup grows with the wall count: the 100k-wall
    # point too
    mega_ms, mega_gts, mega_speedup, mega_walls = bench_accel(
        n_boxes=25002, device=dev)

    print(f"trace frame @131k rays x 8 bounces: {frame_ms:.2f} ms; "
          f"@reference workload 15k x 5: {ref_frame_ms:.2f} ms "
          f"(60Hz budget: {'OK' if ref_frame_ms < 16.6 else 'OVER'}); "
          f"4-listener fused: {quad_ms:.2f} ms/frame; "
          f"IR scatter: {ir_ms:.2f} ms; "
          f"streaming conv: {xrt:.0f}x realtime @44.1kHz; "
          f"full stream chunk (retrace+conv+ring): {chunk_ms:.1f} ms per "
          f"100 ms chunk; "
          f"per-arrival Doppler chunk: {pa_ms:.1f} ms; "
          f"binaural chunk: {bi_ms:.1f} ms; "
          f"binaural+per-arrival chunk: {bpa_ms:.1f} ms; "
          f"room sweep: {rooms_s:.1f} rooms/s (4096 rays x 6 bounces); "
          f"large scene ({accel_walls} walls): {accel_ms:.0f} ms/4 frames, "
          f"{accel_gts:.0f} G tests/s brute-equivalent, "
          f"{accel_speedup:.1f}x over brute; "
          f"({mega_walls} walls): {mega_ms:.0f} ms/4 frames, "
          f"{mega_gts:.0f} G tests/s brute-equivalent, "
          f"{mega_speedup:.1f}x over brute",
          file=sys.stderr)

    result = {
        "metric": "ray_bounce_intersections_per_sec_per_chip",
        "value": float(f"{rps:.4g}"),
        "unit": "intersections/s",
        "vs_baseline": float(f"{rps / BASELINE:.4g}"),
    }
    print(json.dumps(result))
    return dict(intersections_per_s=rps, frame_ms=frame_ms,
                ref_frame_ms=ref_frame_ms, quad_ms=quad_ms, ir_ms=ir_ms,
                xrt=xrt, chunk_ms=chunk_ms, per_arrival_ms=pa_ms,
                binaural_ms=bi_ms, binaural_per_arrival_ms=bpa_ms,
                rooms_per_s=rooms_s, accel_ms=accel_ms, accel_gts=accel_gts,
                accel_speedup=accel_speedup, accel_walls=accel_walls,
                mega_ms=mega_ms, mega_gts=mega_gts,
                mega_speedup=mega_speedup, mega_walls=mega_walls)


if __name__ == "__main__":
    main()
