"""Command-line entry point of the port: ``trace``, ``bake``, ``sweep``.

Port of three subcommands of ``realisticaudioraytracing2d_tpu/cli.py``.
Each runs on the card unless ``--device cpu`` asks for the plain version::

    python -m realisticaudioraytracing2d_tpu_torch.cli trace --room smoll \\
        --out ir.png --scene-out scene.png
    python -m realisticaudioraytracing2d_tpu_torch.cli bake --room smoll \\
        --in dry.wav --out wet.wav [--legacy]
    python -m realisticaudioraytracing2d_tpu_torch.cli sweep --rooms 1024 \\
        --out irs.npz

* ``trace`` accumulates ``--frames`` Monte-Carlo frames into an IR (the
  whole-frame kernel K4 on the card), prints the JAX CLI's ``traced ...``
  line and writes the IR waveform PNG (``--out``), the ray-path PNG of the
  first ``--debug-rays`` rays (``--scene-out``: ``Engine.trace_debug``,
  kernels K1/K2), the legacy muffled spectrogram (``--spectro-out``: hit
  records through ``engine.trace_hits``, kernel K5 or K1/K2) and an IR
  checkpoint (``--ir-out``) that ``--ir-in`` resumes, also one written by
  the JAX package.
* ``bake`` convolves a dry WAV with the traced IR, or with ``--legacy``
  with the time x frequency legacy IR accumulated from hit records and
  rendered back to the time domain.
* ``trace`` and ``bake`` take a directive source and microphones
  (``--directivity``, ``--mic-directivity``: ``omni``, ``cardioid[:DEG]``,
  ``figure8[:DEG]``; ``--stereo-aim DEG`` records ``--stereo`` through an
  XY cardioid pair at +-DEG), traced by the same kernels, and edge
  diffraction (``--diffraction``, ``--diffraction-order 1|2``; its paths
  drawn on ``--scene-out``) and ISO 9613-1 air absorption (``--air``,
  ``--air-temp``, ``--air-humidity``) added to the printed and written
  IR (not to the ``--ir-out`` checkpoint, which keeps the raw
  accumulation; ``bake --legacy`` ignores both), as the JAX CLI does.
* ``sweep`` writes an IR dataset over procedurally generated rooms through
  the rooms-batched kernel K9 (one launch for the whole dataset): the same
  ``npz`` (``irs`` ``[rooms, 1, T, K]`` frame-normalized, ``sources``,
  ``listeners``) and ``swept ... rooms/s`` line as the JAX ``sweep``.

Draws: frame ``f`` of ``--seed`` is the Philox stream of
``ops/rng.py::philox_uniforms``, which K4 draws in the kernel, so the
``--spectro-out`` and ``--scene-out`` rays are those of frame 0 of the IR.
A resumed run (``--ir-in``) draws under ``mix_seed(seed, frames so far)``.

The flags and defaults are those the JAX subcommands read, plus
``--device`` (default ``cuda``). ``sweep`` accepts the pattern flags and
ignores them, as the JAX ``sweep`` does. Not ported yet, and therefore
not accepted (ROADMAP queue 1 names what each waits for):
``--scene-json`` (item 11), ``--spatial-out``, ``--binaural`` and
``--head-radius`` (item 4), the bundled default clip of ``bake --in`` and
mp3 files (item 8), ``sweep --sharded`` (item 10) and ``--metrics-out``
(item 7), and the other subcommands.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from .device import DEFAULT_DEVICE


def _build_room(args, dev):
    from .models import rooms
    maker = {"smoll": rooms.smoll_room, "big": rooms.big_room,
             "sample": rooms.sample_scene}[args.room]
    return maker(n_bands=args.bands, device=dev)


def _config(args):
    from .config import (big_room_config, sample_scene_config,
                         smoll_room_config)
    maker = {"big": big_room_config,
             "sample": sample_scene_config}.get(args.room,
                                                smoll_room_config)
    cfg = maker(n_bands=args.bands, ray_count=args.rays)
    sim = dataclasses.replace(cfg.sim, max_bounces=args.bounces)
    audio = dataclasses.replace(cfg.audio, sample_rate=args.sample_rate,
                                reverb_duration=args.reverb)
    return dataclasses.replace(cfg, sim=sim, audio=audio)


def _listeners(args, room):
    """Listener array + count: honors --stereo (ear pair +-sep/2 on x)."""
    base = np.asarray(room.listener, np.float32)
    if args.stereo is not None:
        sep = float(args.stereo)
        ears = np.stack([base - [sep / 2, 0.0],
                         base + [sep / 2, 0.0]]).astype(np.float32)
        return ears, 2
    return base, 1


def _parse_pattern(spec):
    """A pattern flag (``omni``, ``cardioid[:AIM_DEG]``,
    ``figure8[:AIM_DEG]``) as coefficients, or None for omni."""
    if spec is None or spec == "omni":
        return None
    from .ops import directivity as dv
    name, _, aim = spec.partition(":")
    aim_rad = float(aim) * np.pi / 180.0 if aim else 0.0
    try:
        return {"cardioid": dv.cardioid,
                "figure8": dv.figure_eight}[name](aim_rad)
    except KeyError:
        raise SystemExit(f"unknown directivity {name!r}; pick "
                         "omni/cardioid/figure8")


def _directivity_arr(args):
    """--directivity coefficients, or None."""
    return _parse_pattern(args.directivity)


def _mic_directivity_arr(args):
    """--stereo-aim's XY cardioid pair (left ear +aim, right ear -aim),
    else --mic-directivity's coefficients, or None."""
    if args.stereo_aim is not None:
        if args.stereo is None:
            raise SystemExit("--stereo-aim needs --stereo")
        from .ops import directivity as dv
        a = float(args.stereo_aim) * np.pi / 180.0
        return np.stack([dv.cardioid(a), dv.cardioid(-a)])
    return _parse_pattern(args.mic_directivity)


def _setup(args):
    """Room, config, engine and trace params of a trace/bake command."""
    from .engine import Engine
    dev = torch.device(args.device)
    room = _build_room(args, dev)
    cfg = _config(args)
    listeners, n_l = _listeners(args, room)
    eng = Engine(room.scene, cfg, n_listeners=n_l)
    return room, cfg, listeners, n_l, eng, eng.params(
        room.source, listeners, directivity=_directivity_arr(args),
        mic_directivity=_mic_directivity_arr(args))


def _apply_air(state, sample_rate, speed_of_sound, args):
    """Fold --air's ISO 9613-1 absorption into an IRState's sum (linear,
    so the same as attenuating the normalized IR). The JAX CLI calls the
    curve eagerly, which divides; so does this."""
    if not args.air:
        return state
    from .ops import air
    freqs = air.band_frequencies(state.sum.shape[-1])
    alpha = air.iso9613_alpha(freqs, args.air_temp, args.air_humidity)
    print("air absorption: " + ", ".join(
        f"{f:.0f} Hz {a * 1000:.1f} dB/km" for f, a in zip(freqs, alpha)))
    return state._replace(sum=air.apply_air_absorption(
        state.sum, sample_rate, alpha, speed_of_sound))


def _apply_diffraction(state, scene, params, sample_rate, args):
    """Add the deterministic edge-diffraction IR to an IRState: it has no
    Monte-Carlo variance, so it scales by the frame count in the sum."""
    if not args.diffraction:
        return state
    from .ops.diffraction import diffraction_ir
    d_ir = diffraction_ir(scene, params, sample_rate=sample_rate,
                          ir_length=state.ir_length,
                          order=args.diffraction_order)
    lit = int((d_ir > 0).any(dim=2).any(dim=1).sum())
    print(f"diffraction: added {float(d_ir.sum()):.3g} shadow-zone "
          f"energy/frame over {lit}/{d_ir.shape[0]} listeners")
    return state._replace(sum=state.sum + float(max(1, state.frames)) * d_ir)


def cmd_trace(args) -> None:
    from .ops import legacy
    from .ops.rng import mix_seed
    from .utils import viz
    from .utils.checkpoint import load_ir_state, save_ir_state

    room, cfg, listeners, n_l, eng, p = _setup(args)
    seed = args.seed
    state = None
    if args.ir_in:
        # resume Monte-Carlo accumulation from a checkpoint (preemption
        # recovery for long runs); the frame draws continue under a seed
        # derived from the saved count
        state = load_ir_state(args.ir_in, device=room.scene.device)
        seed = mix_seed(seed, state.frames)
        print(f"resuming from {args.ir_in} at frame {state.frames}")
    t0 = time.perf_counter()
    raw_state = eng.trace_frames(p, seed=seed, n_frames=args.frames,
                                 state=state)
    # Diffraction and air are linear views on the IR: the printed and
    # drawn outputs get them, --ir-out keeps the raw accumulation so that
    # a resume cannot apply them twice. Diffraction first: the air also
    # attenuates the diffracted paths.
    state = _apply_diffraction(raw_state, room.scene, p,
                               cfg.audio.sample_rate, args)
    state = _apply_air(state, cfg.audio.sample_rate, cfg.sim.speed_of_sound,
                       args)
    ir = state.normalized()[0, :, 0].cpu().numpy()  # readback = sync barrier
    dt = time.perf_counter() - t0
    print(f"traced {args.frames} frames x {args.rays} rays in {dt:.3f}s; "
          f"IR energy {ir.sum():.5f}, peak bin {ir.argmax()} "
          f"({ir.argmax() / cfg.audio.sample_rate * 1e3:.2f} ms)")
    wf_gain = 1000.0 if args.gain is None else args.gain
    if args.out:
        img = viz.ir_waveform_image(state.sum[0], state.frames, gain=wf_gain)
        viz.save_image(args.out, img)
        print(f"wrote {args.out}")
    if args.spectro_out:
        if room.scene.n_bands > 1:
            img = viz.ir_spectrogram_image(state.sum[0], state.frames,
                                           gain=args.gain)
        else:
            # scalar IR: derive the legacy muffled spectrogram from the hit
            # records of frame 0
            lst = legacy.LegacyIRState.zeros(
                cfg.audio.ir_length // legacy.DEFAULT_WINDOW_SIZE, n_l,
                device=room.scene.device)
            lst = legacy.accumulate_legacy(lst, eng.trace_hits(p, seed),
                                           cfg.audio.sample_rate)
            img = viz.ir_spectrogram_image(lst.sum[0], lst.frames,
                                           gain=args.gain)
        viz.save_image(args.spectro_out, img)
        print(f"wrote {args.spectro_out}")
    if args.scene_out:
        _, dbg = eng.trace_debug(p, seed, n_debug=args.debug_rays)
        lis0 = np.asarray(listeners, np.float32).reshape(-1, 2)[0]
        extra = viz.diffraction_polylines(
            room.scene, p, order=args.diffraction_order) \
            if args.diffraction else None
        img = viz.render_scene(room.scene, room.source, lis0,
                               room.listener_radius, dbg, extra_paths=extra)
        viz.save_image(args.scene_out, img)
        print(f"wrote {args.scene_out}")
    if args.ir_out:
        save_ir_state(args.ir_out, raw_state)
        print(f"wrote {args.ir_out}")


def cmd_bake(args) -> None:
    from .ops import legacy
    from .ops.convolve import apply_ir, load_samples, peak_normalize
    from .utils.audio_io import read_wav, write_wav

    room, cfg, _, n_l, eng, p = _setup(args)
    dev = room.scene.device
    x, rate = read_wav(args.infile)
    dry = load_samples(torch.as_tensor(x, device=dev), rate,
                       cfg.audio.sample_rate)
    if args.legacy:
        # legacy frequency-binned pipeline (RayTraceManagerComplex +
        # RaytraceOcclusion2D parity): muffled time x freq IR accumulated
        # from hit records, rendered back to the time domain, convolved
        w = legacy.DEFAULT_WINDOW_SIZE
        lst = legacy.LegacyIRState.zeros(cfg.audio.ir_length // w, n_l, w,
                                         device=dev)
        for i in range(args.frames):
            lst = legacy.accumulate_legacy(
                lst, eng.trace_hits(p, args.seed, frame=i),
                cfg.audio.sample_rate)
        ir_td = legacy.legacy_ir_to_time_domain(
            lst.normalized(), cfg.audio.sample_rate, cfg.audio.ir_length,
            w)                                     # [L, T]
        t0 = time.perf_counter()
        wet = apply_ir(dry, ir_td[..., None])
        if not args.no_normalize:
            wet = peak_normalize(wet)
        wet = (wet if n_l > 1 else wet[0]).cpu().numpy()
        dt = time.perf_counter() - t0
    else:
        state = eng.trace_frames(p, seed=args.seed, n_frames=args.frames)
        state = _apply_diffraction(state, room.scene, p,
                                   cfg.audio.sample_rate, args)
        state = _apply_air(state, cfg.audio.sample_rate,
                           cfg.sim.speed_of_sound, args)
        t0 = time.perf_counter()
        wet = eng.bake(dry, state,
                       normalize=not args.no_normalize).cpu().numpy()
        dt = time.perf_counter() - t0
    write_wav(args.out, wet.T if wet.ndim > 1 else wet,
              cfg.audio.sample_rate)
    xrt = (len(dry) / cfg.audio.sample_rate) / dt
    print(f"baked {len(dry)} samples in {dt:.3f}s ({xrt:.1f}x realtime) "
          f"-> {args.out}")


def cmd_sweep(args) -> None:
    from .models.rooms import random_rooms
    from .parallel.sweep import sweep_rooms

    if args.stereo is not None:
        print("note: --stereo is ignored by sweep (mono listeners per room)")
    dev = torch.device(args.device)
    scenes, sources, listeners = random_rooms(args.rooms, seed=args.seed,
                                              n_bands=args.bands, device=dev)
    ir_len = int(args.sample_rate * args.reverb)
    t0 = time.perf_counter()
    irs = sweep_rooms(scenes, sources, listeners, args.seed,
                      n_rays=args.rays, max_bounces=args.bounces,
                      sample_rate=args.sample_rate, ir_length=ir_len,
                      n_frames=args.frames)
    irs = irs.cpu().numpy()      # waits for the device
    dt = time.perf_counter() - t0
    np.savez_compressed(args.out, irs=irs, sources=sources,
                        listeners=listeners)
    print(f"swept {args.rooms} rooms in {dt:.2f}s "
          f"({args.rooms / dt:.1f} rooms/s) -> {args.out} "
          f"irs shape {irs.shape}")


def _common(p, room: bool = True) -> None:
    """The flags every subcommand of the JAX CLI shares (those ported),
    plus ``--device``."""
    if room:
        p.add_argument("--room", default="smoll",
                       choices=["smoll", "big", "sample"])
    p.add_argument("--rays", type=int, default=15000)
    p.add_argument("--bounces", type=int, default=5)
    p.add_argument("--bands", type=int, default=1)
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--reverb", type=float, default=1.5)
    p.add_argument("--frames", type=int, default=8,
                   help="Monte-Carlo trace frames to accumulate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stereo", default=None, metavar="SEP",
                   help="stereo output with two ear listeners SEP apart "
                        "(ignored by sweep: mono listeners per room)")
    p.add_argument("--directivity", default=None, metavar="PATTERN",
                   help="source directivity: omni (default), "
                        "cardioid[:AIM_DEG], figure8[:AIM_DEG], weighted at "
                        "emission (ignored by sweep)")
    p.add_argument("--mic-directivity", default=None, metavar="PATTERN",
                   help="listener pickup pattern (same syntax), weighted "
                        "by arrival angle at each capture")
    p.add_argument("--stereo-aim", type=float, default=None, metavar="DEG",
                   help="with --stereo: record through an XY cardioid "
                        "pair aimed at +-DEG (overrides --mic-directivity)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default %(default)s; cpu runs the "
                        "plain version)")


def _air_args(p) -> None:
    """The JAX CLI's diffraction and air flags."""
    p.add_argument("--diffraction", action="store_true",
                   help="add edge diffraction (Maekawa knife-edge "
                        "shadow-zone fill)")
    p.add_argument("--diffraction-order", type=int, default=1,
                   choices=[1, 2],
                   help="2 adds edge-to-edge double diffraction (rounds "
                        "thick obstacles; O(W^3), room-scale scenes)")
    p.add_argument("--air", action="store_true",
                   help="apply ISO 9613-1 atmospheric absorption to the "
                        "IR (per band, at log-spaced band centres)")
    p.add_argument("--air-temp", type=float, default=20.0, metavar="C")
    p.add_argument("--air-humidity", type=float, default=50.0,
                   metavar="PCT")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m realisticaudioraytracing2d_tpu_torch.cli",
        description="2D audio ray tracing, PyTorch/CUDA port")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("trace", help="trace IR + debug images")
    _common(p)
    p.add_argument("--out", default=None, help="IR waveform PNG")
    p.add_argument("--spectro-out", default=None,
                   help="time x frequency spectrogram PNG (banded IR, or "
                        "legacy muffle model for scalar IRs)")
    p.add_argument("--scene-out", default=None, help="scene/ray-path PNG")
    p.add_argument("--ir-out", default=None, help="IR state checkpoint npz")
    p.add_argument("--ir-in", default=None,
                   help="resume accumulation from an IR checkpoint npz")
    p.add_argument("--gain", type=float, default=None,
                   help="display gain (waveform default 1000; spectrogram "
                        "default auto-scale)")
    p.add_argument("--debug-rays", type=int, default=100)
    _air_args(p)
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("bake", help="offline convolution bake")
    _common(p)
    p.add_argument("--in", dest="infile", required=True, help="dry WAV")
    p.add_argument("--out", required=True)
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--legacy", action="store_true",
                   help="use the legacy frequency-binned (muffle) pipeline")
    _air_args(p)  # applied on the modern path (ignored with --legacy)
    p.set_defaults(fn=cmd_bake)

    p = sub.add_parser("sweep", help="IR dataset over procedural rooms")
    p.add_argument("--rooms", type=int, default=64)
    p.add_argument("--out", required=True)
    _common(p, room=False)
    p.set_defaults(fn=cmd_sweep)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
