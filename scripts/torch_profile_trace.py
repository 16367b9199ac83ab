#!/usr/bin/env python3
"""Where ``cli trace`` and ``cli bake --legacy`` of the PyTorch port spend
their time, on one NVIDIA GPU.

Runs the hit-record path of ``realisticaudioraytracing2d_tpu_torch`` at the
CLI's defaults (SmollRoom, 15,000 rays x 5 bounces x 8 frames, 48 kHz,
72,000-bin IR, 100 debug rays, legacy IR of 562 time bins x 128 slots) and
prints:

1. the phases of ``cli trace --room smoll --out --scene-out --spectro-out
   --ir-out`` on the host clock, each ended by a device sync: the IR (one
   K4 launch and the read-back), the waveform PNG, the hit records (K5),
   the legacy scatter, the spectrogram PNG, the debug paths (K1/K2), the
   scene PNG, the checkpoint; then the whole CLI once, end to end;
2. the phases of ``cli bake --legacy`` on a 1 s click clip: per frame the
   hit records (K5) and the legacy scatter, then the irfft render, the
   convolution and the WAV write; then the whole CLI once;
3. one frame of hit records each way under ``torch.profiler``: K5
   (``trace_fused``), K1/K2 (``trace(use_kernels=True)``) and the legacy
   scatter: device time by kind of kernel and the idle share.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_profile_trace.py [--out FILE]

``--out`` also writes the profiler's tables of device kernels.
"""

import argparse
import contextlib
import io
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, T = 48000, 72000
FRAMES, DEBUG_RAYS = 8, 100


def kind(name):
    """Group a device event by what launched it."""
    low = name.lower()
    for mine in ("frame_rows_kernel", "wall_sweep_kernel",
                 "frames_ir_kernel", "fixed_to_float"):
        if mine in name:
            return mine
    if "memset" in low:
        return "memsets"
    if "memcpy" in low:
        return "copies"
    if "sort" in low or "radix" in low:
        return "sorts (the deterministic scatter)"
    if "index" in low or "scatter" in low or "gather" in low:
        return "indexing (the deterministic scatter, gathers)"
    if "fft" in low:
        return "cuFFT"
    return "other elementwise / reductions"


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
        print(f"    {k:46s} {ms:.4f} ms", flush=True)
    if out:
        out.write(f"{label}\n")
        out.write(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=30) + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the profiler's tables here")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch import cli
    from realisticaudioraytracing2d_tpu_torch.ops import legacy
    from realisticaudioraytracing2d_tpu_torch.ops import trace as tt
    from realisticaudioraytracing2d_tpu_torch.ops.convolve import (
        apply_ir, load_samples, peak_normalize)
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        bounce_kernel as bk
    from realisticaudioraytracing2d_tpu_torch.utils import viz
    from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (
        click_clip, read_wav, write_wav)
    from realisticaudioraytracing2d_tpu_torch.utils.checkpoint import \
        save_ir_state

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_trace: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    out = open(args.out, "w") if args.out else None
    if out:
        out.write(f"card: {card}\n")

    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config()
    eng = art.Engine(room.scene, cfg)
    p = eng.params(room.source, room.listener)
    w = legacy.DEFAULT_WINDOW_SIZE

    def timed(phases, name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
        return result

    def report(label, phases, whole_s):
        total = sum(phases.values())
        print(f"{label}, phases on the host clock: "
              + "; ".join(f"{k} {v * 1e3:.3f} ms ({100 * v / total:.1f}%)"
                          for k, v in phases.items())
              + f"; sum {total * 1e3:.3f} ms; the whole CLI call "
              f"{whole_s * 1e3:.3f} ms", flush=True)

    def whole(argv):
        """One CLI call end to end, its own lines kept off this report."""
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # warm-up: builds and loads the kernels, cuFFT plans, the sort's scratch
    legacy.accumulate_legacy(legacy.LegacyIRState.zeros(T // w, device=dev),
                             eng.trace_hits(p, 1), SR)
    eng.trace_debug(p, 1, n_debug=DEBUG_RAYS)
    warm = eng.trace_frames(p, seed=1, n_frames=FRAMES)
    eng.bake(torch.zeros(SR, device=dev), warm)   # the 1 s clip's FFT plan
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        def f(name):
            return os.path.join(tmp, name)

        # --- 1. cli trace ------------------------------------------------
        ph = {}

        def trace_ir():
            traced = eng.trace_frames(p, seed=0, n_frames=FRAMES)
            traced.normalized()[0, :, 0].cpu().numpy()
            return traced

        state = timed(ph, "IR: K4, 8 frames, read-back", trace_ir)
        timed(ph, "waveform PNG", lambda: viz.save_image(
            f("ir.png"), viz.ir_waveform_image(state.sum[0], state.frames)))
        hits = timed(ph, "hit records: K5", lambda: eng.trace_hits(p, 0))
        lst = timed(ph, "legacy scatter", lambda: legacy.accumulate_legacy(
            legacy.LegacyIRState.zeros(T // w, device=dev), hits, SR))
        timed(ph, "spectrogram PNG", lambda: viz.save_image(
            f("spectro.png"), viz.ir_spectrogram_image(lst.sum[0],
                                                       lst.frames)))
        dbg = timed(ph, "debug paths: K1/K2", lambda: eng.trace_debug(
            p, 0, n_debug=DEBUG_RAYS)[1])
        timed(ph, "scene PNG", lambda: viz.save_image(
            f("scene.png"), viz.render_scene(
                room.scene, room.source, np.asarray(room.listener),
                room.listener_radius, dbg)))
        timed(ph, "checkpoint", lambda: save_ir_state(f("ir.npz"), state))
        report("[1] cli trace --room smoll with its four outputs", ph,
               whole(["trace", "--room", "smoll", "--out", f("a.png"),
                      "--scene-out", f("b.png"), "--spectro-out", f("c.png"),
                      "--ir-out", f("d.npz")]))

        # --- 2. cli bake --legacy ------------------------------------------
        write_wav(f("dry.wav"), click_clip(1.0, 44100, click_times=(0.1, 0.6)),
                  44100)
        ph = {}
        x, rate = timed(ph, "read WAV, resample", lambda: read_wav(
            f("dry.wav")))
        dry = timed(ph, "read WAV, resample", lambda: load_samples(
            torch.as_tensor(x, device=dev), rate, SR))
        lst = legacy.LegacyIRState.zeros(T // w, device=dev)
        for i in range(FRAMES):
            hits = timed(ph, f"hit records: K5, {FRAMES} frames",
                         lambda: eng.trace_hits(p, 0, frame=i))
            lst = timed(ph, f"legacy scatter, {FRAMES} frames",
                        lambda: legacy.accumulate_legacy(lst, hits, SR))
        ir_td = timed(ph, "irfft render", lambda:
                      legacy.legacy_ir_to_time_domain(lst.normalized(), SR, T,
                                                      w))
        wet = timed(ph, "convolution, normalize, read-back", lambda:
                    peak_normalize(apply_ir(dry, ir_td[..., None]))[0]
                    .cpu().numpy())
        timed(ph, "write WAV", lambda: write_wav(f("wet.wav"), wet, SR))
        report("[2] cli bake --room smoll --legacy, 1 s clip", ph,
               whole(["bake", "--room", "smoll", "--in", f("dry.wav"),
                      "--out", f("w.wav"), "--legacy"]))
        normal = whole(["bake", "--room", "smoll", "--in", f("dry.wav"),
                        "--out", f("n.wav")])
        print(f"    cli bake without --legacy, the same clip: "
              f"{normal * 1e3:.3f} ms", flush=True)

    # --- 3. one frame of hit records under the profiler ----------------------
    emit, u = eng.frame_uniforms(0)
    profiled(torch, lambda: bk.trace_fused(room.scene, p, emit, u),
             "[3] hit records through K5 (trace_fused), 15,000 x 5", out)
    profiled(torch, lambda: tt.trace_hits_only(room.scene, p, emit, u,
                                               use_kernels=True),
             "[3] hit records through K1/K2 (trace(use_kernels=True)), "
             "15,000 x 5", out)
    hits = eng.trace_hits(p, 0)
    profiled(torch, lambda: legacy.scatter_hits_legacy(hits, SR, T // w),
             "[3] legacy scatter of 150,000 hit records into 562 x 128", out)
    if out:
        out.close()
    print(f"card: {card}")


if __name__ == "__main__":
    main()
