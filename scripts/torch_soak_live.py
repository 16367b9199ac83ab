#!/usr/bin/env python
"""Long live-session soak of the PyTorch/CUDA port: one ``LivePlayer``
session of N minutes on the card (a looped clip, the realtime audio
clock, the recording off as an open-ended session runs it) steered the
whole time by a pose feed that a writer thread appends to at
``--feed-hz`` lines a second. It checks that the live pipeline holds
beyond the smoke's 3 s runs:

* no underrun after the prebuffer;
* flat host RSS (no leak in the chunk step, the feed, the native ring or
  the readback): at most 4 KB per chunk, measured as the slope from the
  second minute on (the first holds the allocator's and cuFFT's
  warm-up);
* flat per-chunk producer time (``LiveReport.step_ms``: the chunk's
  trace, convolution and readback, the ring's backpressure wait left
  out): the last tenth's median within 1.5x + 1 ms of the first tenth's.

Modes: ``plain`` (the mono stream, the feed moving the source) and
``composed`` (the binaural head with per-arrival Doppler, the feed moving
the source and turning the head). Run on the card::

    python scripts/torch_soak_live.py --minutes 10 --out chiprun_out/soak.json
    python scripts/torch_soak_live.py --mode composed --minutes 4 \\
        --out chiprun_out/soak_composed.json

Prints the card's name and power limit, a per-minute table (producer ms
p50 / p95 / max, underruns so far, RSS, feed lines written and read),
the report's summary and a PASS/FAIL line; ``--out`` gets the same as
JSON. ``--device cpu`` runs the same loop on the plain versions (a
rehearsal: its times are the CPU's).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("no VmRSS in /proc/self/status")


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--mode", choices=["plain", "composed"], default="plain")
    ap.add_argument("--rays", type=int, default=15000)
    ap.add_argument("--feed-hz", type=float, default=10.0,
                    help="pose-feed lines a second (a chatty UI)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="JSON results")
    args = ap.parse_args()

    import numpy as np
    import torch

    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch.live import LivePlayer
    from realisticaudioraytracing2d_tpu_torch.posefeed import PoseFeed
    from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (
        noise_burst)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_soak_live: no CUDA device (--device cpu "
                         "rehearses on the plain versions)")
    card = card_line(dev)
    composed = args.mode == "composed"
    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config(ray_count=args.rays)
    eng = art.Engine(room.scene, cfg)
    sr, n = cfg.audio.sample_rate, cfg.audio.chunk_samples
    chunk_dt = cfg.audio.chunk_duration
    total_chunks = max(2, int(round(args.minutes * 60.0 / chunk_dt)))
    per_min = int(round(60.0 / chunk_dt))
    dry = torch.as_tensor(noise_burst(2.0, sr, seed=7) * 0.2, device=dev)

    # the feed lives in the repository's ignored build directory
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(build, exist_ok=True)
    feed_path = os.path.join(build, f"soak_feed_{os.getpid()}.jsonl")
    open(feed_path, "w").close()
    feed = PoseFeed.open(feed_path).bind_scene(room.builder)
    stop_writer = threading.Event()
    written = [0]
    src = np.asarray(room.source, np.float64)

    def writer():
        i = 0
        while not stop_writer.is_set():
            line = {"source": [float(src[0] + 2.0 * np.sin(i / 50.0)),
                               float(src[1])]}
            if composed:
                line["facing"] = float(0.5 * np.sin(i / 80.0))
            with open(feed_path, "a") as f:
                f.write(json.dumps(line) + "\n")
            written[0] += 1
            i += 1
            stop_writer.wait(1.0 / args.feed_hz)

    base = eng.params(room.source, room.listener)
    player = LivePlayer(room.scene, cfg, seed=0, binaural=composed,
                        device=dev)
    # per 100 chunks: (chunk, RSS MB, underruns, lines written, lines read)
    samples = []
    t0 = time.perf_counter()

    def on_chunk(i, _ir):
        if i % 100 == 0:
            samples.append((i, rss_mb(), player.report.underruns,
                            written[0], feed._line_no))
            print(f"  chunk {i}/{total_chunks} "
                  f"t+{time.perf_counter() - t0:.0f}s rss "
                  f"{samples[-1][1]:.1f} MB", file=sys.stderr, flush=True)

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    print(f"{card}\nsoaking {args.mode} {args.minutes:g} min = "
          f"{total_chunks} chunks ({chunk_dt * 1e3:.0f} ms, {args.rays} "
          f"rays, feed {args.feed_hz:g} lines/s) on {dev}", flush=True)
    t0 = time.perf_counter()
    rep = player.run(dry, total_chunks=total_chunks, loop=True,
                     realtime=True, prime=1,
                     params_fn=lambda i: feed.params(base, i),
                     facing_fn=(lambda i: feed.facing(0.0, i))
                     if composed else None,
                     doppler="per_arrival" if composed else False,
                     control_fn=feed.control, on_chunk=on_chunk,
                     record=False)
    wall = time.perf_counter() - t0
    stop_writer.set()
    wt.join(timeout=10)
    feed.close()
    os.remove(feed_path)

    step = rep.step_ms
    minutes = []
    for m in range(0, len(step), per_min):
        seg = step[m:m + per_min]
        at = [s for s in samples if m <= s[0] < m + per_min]
        minutes.append(dict(
            minute=m // per_min, p50_ms=float(np.median(seg)),
            p95_ms=float(np.percentile(seg, 95)), max_ms=float(seg.max()),
            underruns=at[-1][2] if at else None,
            rss_mb=at[-1][1] if at else None,
            lines_written=at[-1][3] if at else None,
            lines_read=at[-1][4] if at else None))
    print(f"\n{'minute':>6} {'p50 ms':>8} {'p95 ms':>8} {'max ms':>8} "
          f"{'underruns':>9} {'rss MB':>8} {'written':>8} {'read':>8}")
    for r in minutes:
        print(f"{r['minute']:6d} {r['p50_ms']:8.3f} {r['p95_ms']:8.3f} "
              f"{r['max_ms']:8.3f} {r['underruns']!s:>9} "
              f"{r['rss_mb'] or float('nan'):8.1f} {r['lines_written']!s:>8}"
              f" {r['lines_read']!s:>8}")

    tenth = max(1, len(step) // 10)
    head_p50 = float(np.median(step[1:tenth + 1]))
    tail_p50 = float(np.median(step[-tenth:]))
    steady = [s for s in samples if s[0] >= per_min] or samples
    span = steady[-1][0] - steady[0][0]
    rss_kb_per_chunk = ((steady[-1][1] - steady[0][1]) * 1024.0 / span
                        if span > 0 else 0.0)
    ok = (rep.underruns == 0 and rss_kb_per_chunk < 4.0
          and tail_p50 < 1.5 * head_p50 + 1.0 and len(feed._pending) < 100)
    result = dict(card=card, mode=args.mode, minutes=args.minutes,
                  rays=args.rays, feed_hz=args.feed_hz,
                  chunks=rep.chunks, callbacks=rep.callbacks,
                  underruns=rep.underruns, late_samples=rep.late_samples,
                  max_lead_samples=rep.max_lead_samples,
                  realtime_factor=rep.realtime_factor, wall_s=wall,
                  step_p50_ms=float(np.median(step[1:])),
                  step_p95_ms=float(np.percentile(step[1:], 95)),
                  step_p99_ms=float(np.percentile(step[1:], 99)),
                  step_max_ms=float(step[1:].max()),
                  head_p50_ms=head_p50, tail_p50_ms=tail_p50,
                  rss_first_mb=samples[0][1], rss_last_mb=samples[-1][1],
                  rss_kb_per_chunk=rss_kb_per_chunk,
                  lines_written=written[0], lines_read=feed._line_no,
                  feed_pending=len(feed._pending), per_minute=minutes,
                  passed=bool(ok))
    print(f"\n{rep.summary()}")
    print(f"wall {wall:.1f} s for {rep.chunks * chunk_dt:.1f} s of audio; "
          f"producer step p50 {result['step_p50_ms']:.3f} ms (p95 "
          f"{result['step_p95_ms']:.3f}, p99 {result['step_p99_ms']:.3f}, "
          f"max {result['step_max_ms']:.3f}); first tenth p50 "
          f"{head_p50:.3f} -> last tenth {tail_p50:.3f} ms; RSS "
          f"{samples[0][1]:.1f} -> {samples[-1][1]:.1f} MB "
          f"({rss_kb_per_chunk:+.3f} KB/chunk from minute 1); feed "
          f"{written[0]} lines written, {feed._line_no} read, "
          f"{len(feed._pending)} pending")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print("SOAK " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
