"""Command-line entry point of the port: ``trace``, ``bake``, ``stream``,
``live``, ``sweep``, ``analyze``, ``fit``, ``locate``, ``bench``.

Port of the nine subcommands of ``realisticaudioraytracing2d_tpu/cli.py``.
Each runs on the card unless ``--device cpu`` asks for the plain version::

    python -m realisticaudioraytracing2d_tpu_torch.cli trace --room smoll \\
        --out ir.png --scene-out scene.png [--spatial-out sp.npz]
    python -m realisticaudioraytracing2d_tpu_torch.cli bake --room smoll \\
        --in dry.wav --out wet.wav [--legacy | --binaural FACING_DEG]
    python -m realisticaudioraytracing2d_tpu_torch.cli stream --room smoll \\
        --in dry.wav --out wet.wav [--binaural 0 --head-turn 90] \\
        [--move-source 2,0 --doppler | --doppler-per-arrival] \\
        [--pose-feed poses.jsonl]
    python -m realisticaudioraytracing2d_tpu_torch.cli live --room smoll \\
        --duration 5 --out heard.wav [--realtime | --play] \\
        [--pose-feed poses.jsonl]
    python -m realisticaudioraytracing2d_tpu_torch.cli sweep --rooms 1024 \\
        --out irs.npz [--metrics-out metrics.npz] [--sharded]
    python -m realisticaudioraytracing2d_tpu_torch.cli analyze --room smoll \\
        [--ir-in ir.npz] [--out report.json] [--edc-out edc.png]
    python -m realisticaudioraytracing2d_tpu_torch.cli fit --room smoll \\
        --target ir.npz --out materials.json [--fields absorption,ior]
    python -m realisticaudioraytracing2d_tpu_torch.cli locate --room smoll \\
        --target ir.npz --out located.json [--starts 8 --steps 200]
    python -m realisticaudioraytracing2d_tpu_torch.cli bench

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
* ``trace --spatial-out`` also traces the three-microphone spatial
  capture (``spatial.trace_spatial``, the directive K4) and writes W, X,
  Y, the arrival angle and the diffuseness per bin, and prints the
  dominant arrivals, as the JAX CLI does; ``bake --binaural FACING_DEG``
  (``--head-radius M``) bakes through the two-ear decode of that capture.
* ``stream`` runs ``Streamer.stream_clip`` over a dry WAV (K4 once a
  chunk; K8 or K7 past 5,280 walls), with the poses drifting at
  ``--move-listener`` / ``--move-source`` m/s, ``--duration`` seconds
  (the clip loops) or the clip once with its tail, ``--viz-every`` IR
  PNGs, ``--binaural FACING_DEG`` (``--head-turn DEG_S``,
  ``--head-radius M``) for the binaural stream, ``--doppler`` (the dry
  feed read at the direct path's rate) or ``--doppler-per-arrival`` (each
  dominant early arrival gliding at its own rate, tuned by
  ``--arrival-taps``, ``--arrival-window`` and ``--arrival-match-bins``;
  with ``--binaural`` and ``--bands`` too), ``--pose-feed FILE`` (a
  JSON-lines feed, tailed while the stream runs, that moves the source,
  the listeners, the head or a named wall and carries the stop/reset_ir
  verbs: :mod:`.posefeed`), ``--band-split linear|octave`` (the bands of
  a banded scene's convolution: K equal bands, as JAX, or bands about the
  banded physics' centre frequencies), and prints the JAX CLI's
  ``streamed ... x realtime`` line.
* ``live`` runs the same chunk step in :class:`.live.LivePlayer`: a
  producer thread pushes each wet chunk into the native ring while an
  audio thread drains it ``--dsp-buffer`` samples at a time, on the
  wall clock with ``--realtime`` or through the ALSA device with
  ``--play`` (which exits with the ALSA message where there is no sound
  system), records what the audio thread heard (``--out``) and prints
  the JAX CLI's ``live: ...`` line with its underruns. It takes
  ``stream``'s pose, head, Doppler, band-split and ``--pose-feed``
  flags.
* Every command but ``sweep`` takes ``--scene-json FILE`` in place of
  ``--room``: the JAX CLI's exported-collider schema
  (:func:`load_scene_json`). A collider's ``name`` names it for the pose
  feed's ``obstacle`` lines.
* ``--in`` defaults to the bundled clip (``assets/dry_clip.wav``); an
  ``.mp3`` input or output goes through the system codecs
  (:mod:`.native`).
* ``sweep`` writes an IR dataset over procedurally generated rooms through
  the rooms-batched kernel K9 (one launch for the whole dataset): the same
  ``npz`` (``irs`` ``[rooms, 1, T, K]`` frame-normalized, ``sources``,
  ``listeners``) and ``swept ... rooms/s`` line as the JAX ``sweep``;
  ``--metrics-out`` adds the rooms' ISO 3382 metrics (``analysis.
  analyze_dataset``, on the device of the IRs). ``--sharded`` is the JAX
  CLI's rule: with more than one CUDA device the rooms split over a mesh
  of all of them (``parallel.sweep.sweep_rooms_sharded``, one K9 launch
  per card), the same npz bit for bit; on one card, or with ``--device
  cpu``, the unsharded sweep, as JAX runs it on one chip.
* ``analyze`` reports the metrics of a saved IR (``--ir-in``) or of a
  fresh trace as the JAX CLI's JSON (``--out``, else stdout) and plots
  the Schroeder decay (``--edc-out``).
* ``fit`` fits the scene's per-group wall materials (``--fields``) to a
  target IR checkpoint (``--target``, e.g. from ``trace --ir-out``) and
  ``locate`` recovers the source position from one, by Adam through the
  plain trace under autograd (:mod:`.diff`: the hand kernels have no
  backward, as in the JAX package); both write the JAX CLI's JSON
  report and print its line.

Draws: frame ``f`` of ``--seed`` is the Philox stream of
``ops/rng.py::philox_uniforms``, which K4 draws in the kernel, so the
``--spectro-out`` and ``--scene-out`` rays are those of frame 0 of the IR.
A resumed run (``--ir-in``) draws under ``mix_seed(seed, frames so far)``.

The flags and defaults are those the JAX subcommands read, plus
``--device`` (default ``cuda``). ``sweep`` accepts the pattern flags and
ignores them, as the JAX ``sweep`` does. ``bench`` takes only
``--device``, as the JAX ``bench`` takes no flag: it runs the port's copy
of the JAX bench suite (:mod:`.bench`: its eight measurements, through
the port, at the JAX sizes) and prints the JAX bench's last line for the
port, ``{"metric": "ray_bounce_intersections_per_sec_per_chip", "value":
..., "unit": "intersections/s", "vs_baseline": ...}``, with its summary
on stderr. ``fit`` and ``locate`` draw step ``i``'s rays from
``mix_seed(seed, i)`` (fit) or ``--seed`` every step (locate), as
:mod:`.diff` says.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .device import DEFAULT_DEVICE


def load_scene_json(spec, default_bands: int = 1, device=None):
    """Build a ``RoomSetup`` from the JAX CLI's exported-collider JSON
    schema (``realisticaudioraytracing2d_tpu/cli.py::load_scene_json``).

    The schema mirrors the reference's collider flattening inputs
    (SceneHelper.cs:29-76): a list of colliders, each with a transform
    (position/angle/scale), a type-specific shape (box: size+offset;
    polygon: paths; circle: radius+offset+resolution) and a material
    (absorption/scattering/transmission/ior, optionally band_absorption).
    Top-level: source, listener (or listeners), listener_radius, n_bands,
    and optional ``directivity`` / ``mic_directivity`` patterns (a spec
    string like "cardioid:30", explicit Fourier coefficients, or, for
    mics, a per-listener list of spec strings). ``boxes: [...]`` is
    accepted as shorthand for box colliders. A collider's optional
    ``name`` names it, and the builder rides in the result, so a pose
    feed's ``obstacle`` lines can move it (the JAX loader keeps
    neither)."""
    from .models.materials import AudioMaterial
    from .models.rooms import RoomSetup
    from .models.scene import SceneBuilder, Transform2D

    n_bands = int(spec.get("n_bands", default_bands))
    b = SceneBuilder(n_bands=n_bands)

    def tf_of(c):
        return Transform2D(position=tuple(c.get("position", (0, 0))),
                           angle=float(c.get("angle", 0.0)),
                           scale=tuple(c.get("scale", (1, 1))))

    def mat_of(c):
        m = dict(c.get("material", {}))
        if m.get("band_absorption") is not None:
            m["band_absorption"] = tuple(m["band_absorption"])
        return AudioMaterial(**m)

    colliders = list(spec.get("colliders", []))
    colliders += [dict(c, type="box") for c in spec.get("boxes", [])]
    if not colliders:
        raise SystemExit("scene json has no colliders/boxes")
    for c in colliders:
        kind = c.get("type", "box")
        name = c.get("name")
        if kind == "box":
            b.add_box(mat_of(c), tf_of(c), size=tuple(c.get("size", (1, 1))),
                      offset=tuple(c.get("offset", (0, 0))), name=name)
        elif kind == "polygon":
            b.add_polygon([np.asarray(p, np.float64) for p in c["paths"]],
                          mat_of(c), tf_of(c), name=name)
        elif kind == "circle":
            b.add_circle(mat_of(c), tf_of(c),
                         radius=float(c.get("radius", 0.5)),
                         offset=tuple(c.get("offset", (0, 0))),
                         resolution=int(c.get("resolution", 32)), name=name)
        else:
            raise SystemExit(f"unknown collider type {kind!r}")
    listener = spec.get("listeners", spec.get("listener"))

    def pattern_of(key):
        # "cardioid:30" / "figure8" / explicit coefficient list; mic
        # patterns also accept a list of per-listener specs
        v = spec.get(key)
        if v is None:
            return None
        if isinstance(v, str):
            return _parse_pattern(v)
        v = list(v)
        if v and isinstance(v[0], str):
            pats = [_parse_pattern(x) for x in v]
            width = max(len(p) for p in pats)
            return np.stack([np.pad(p, (0, width - len(p)))
                             for p in pats])
        return np.asarray(v, np.float32)

    return RoomSetup(
        scene=b.build(device=device),
        source=np.asarray(spec["source"], np.float32),
        listener=np.asarray(listener, np.float32),
        listener_radius=float(spec.get("listener_radius", 0.5)),
        directivity=pattern_of("directivity"),
        mic_directivity=pattern_of("mic_directivity"), builder=b)


def _build_room(args, dev):
    if getattr(args, "scene_json", None):
        with open(args.scene_json) as f:
            spec = json.load(f)
        return load_scene_json(spec, default_bands=args.bands, device=dev)
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
    """Listener array + count: honors --stereo (ear pair +-sep/2 on x)
    and a multi-listener scene JSON (``listeners: [[..], [..]]``)."""
    base = np.asarray(room.listener, np.float32)
    if args.stereo is not None:
        if base.ndim > 1:
            base = base.reshape(-1, 2)[0]
        sep = float(args.stereo)
        ears = np.stack([base - [sep / 2, 0.0],
                         base + [sep / 2, 0.0]]).astype(np.float32)
        return ears, 2
    if base.ndim > 1:
        return base.reshape(-1, 2), base.reshape(-1, 2).shape[0]
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


def _directivity_arr(args, room=None):
    """--directivity coefficients, else the scene JSON's pattern, or
    None."""
    flag = _parse_pattern(args.directivity)
    if flag is not None:
        return flag
    return getattr(room, "directivity", None)


def _mic_directivity_arr(args, room=None):
    """--stereo-aim's XY cardioid pair (left ear +aim, right ear -aim),
    else --mic-directivity's coefficients, else the scene JSON's pattern,
    or None."""
    if args.stereo_aim is not None:
        if args.stereo is None:
            raise SystemExit("--stereo-aim needs --stereo")
        from .ops import directivity as dv
        a = float(args.stereo_aim) * np.pi / 180.0
        return np.stack([dv.cardioid(a), dv.cardioid(-a)])
    flag = _parse_pattern(args.mic_directivity)
    if flag is not None:
        return flag
    return getattr(room, "mic_directivity", None)


def _setup(args):
    """Room, config, engine and trace params of a trace/bake command."""
    from .engine import Engine
    dev = torch.device(args.device)
    room = _build_room(args, dev)
    cfg = _config(args)
    listeners, n_l = _listeners(args, room)
    eng = Engine(room.scene, cfg, n_listeners=n_l)
    return room, cfg, listeners, n_l, eng, eng.params(
        room.source, listeners, directivity=_directivity_arr(args, room),
        mic_directivity=_mic_directivity_arr(args, room))


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
    if args.spatial_out:
        _write_spatial(args, room, cfg, p, seed)


def _write_spatial(args, room, cfg, p, seed) -> None:
    """Trace the three-microphone spatial capture and write W/X/Y and the
    per-bin direction of arrival and diffuseness (npz, the JAX CLI's
    keys); print the arrival table."""
    from . import spatial as spm
    if p.mic_directivity is not None:
        raise SystemExit("--spatial-out replaces --mic-directivity "
                         "(steer the spatial IR afterwards instead)")
    sp_ir, _ = spm.trace_spatial(
        room.scene, p, seed, n_rays=cfg.sim.ray_count,
        max_bounces=cfg.sim.max_bounces, sample_rate=cfg.audio.sample_rate,
        ir_length=cfg.audio.ir_length, n_frames=args.frames)

    def host(x):
        return x.cpu().numpy()

    np.savez(args.spatial_out, w=host(sp_ir.w), x=host(sp_ir.x),
             y=host(sp_ir.y), arrival_angle=host(sp_ir.arrival_angle()),
             diffuseness=host(sp_ir.diffuseness()),
             sample_rate=cfg.audio.sample_rate)
    print(f"wrote {args.spatial_out}")
    arrivals = spm.dominant_arrivals(sp_ir, cfg.audio.sample_rate)
    for i, a in enumerate(arrivals):
        print(f"  arrival {i}: t={a['time_s'] * 1e3:7.2f} ms  "
              f"from {np.degrees(a['bearing_rad']):7.1f} deg  "
              f"diffuseness {a['diffuseness']:.3f}  "
              f"energy {a['energy']:.4g}")


def _bake_binaural(args, room, cfg, p, n_l, dry) -> None:
    """``bake --binaural``: the spatial capture of ``--frames`` frames
    (K4), diffraction and air on it, the two-ear decode at the facing
    (``max_shift`` from the config's speed of sound in Python floats, as
    the JAX CLI computes it eagerly), one convolution per ear."""
    from . import spatial as spm
    from .engine import trace_accumulate
    from .ops import ir as irm
    from .ops.convolve import apply_ir, peak_normalize
    from .utils.audio_io import write_audio
    if args.legacy:
        raise SystemExit("--binaural is not available with --legacy")
    if args.stereo is not None or p.mic_directivity is not None:
        raise SystemExit("--binaural replaces --stereo and "
                         "--mic-directivity (it assigns the ear "
                         "patterns itself)")
    if n_l != 1:
        raise SystemExit("--binaural needs exactly one listener "
                         "(one head)")
    spp = spm.spatial_params(p)
    state = irm.IRState.zeros(cfg.audio.ir_length, spp.listeners.shape[0],
                              room.scene.n_bands, device=room.scene.device)
    state = trace_accumulate(room.scene, spp, state,
                             n_rays=cfg.sim.ray_count,
                             max_bounces=cfg.sim.max_bounces,
                             sample_rate=cfg.audio.sample_rate,
                             n_frames=args.frames, seed=args.seed)
    state = _apply_diffraction(state, room.scene, spp,
                               cfg.audio.sample_rate, args)
    state = _apply_air(state, cfg.audio.sample_rate, cfg.sim.speed_of_sound,
                       args)
    lft, rgt = spm.spatial_from_ir(state.normalized()).binaural(
        cfg.audio.sample_rate, facing=float(np.radians(args.binaural)),
        head_radius=args.head_radius,
        speed_of_sound=cfg.sim.speed_of_sound)
    ears = torch.cat([lft, rgt], dim=0)                    # [2, T, K]
    t0 = time.perf_counter()
    wet = apply_ir(dry, ears)
    if not args.no_normalize:
        wet = peak_normalize(wet)
    wet = wet.cpu().numpy()
    dt = time.perf_counter() - t0
    write_audio(args.out, wet.T, cfg.audio.sample_rate)
    xrt = (len(dry) / cfg.audio.sample_rate) / dt
    print(f"binaural bake (facing {args.binaural:.0f} deg, head "
          f"{args.head_radius * 100:.1f} cm): {len(dry)} samples in "
          f"{dt:.3f}s ({xrt:.1f}x realtime) -> {args.out}")


def cmd_bake(args) -> None:
    from .ops import legacy
    from .ops.convolve import apply_ir, load_samples, peak_normalize
    from .utils.audio_io import builtin_clip_path, read_audio, write_audio

    room, cfg, _, n_l, eng, p = _setup(args)
    dev = room.scene.device
    x, rate = read_audio(args.infile or builtin_clip_path())
    dry = load_samples(torch.as_tensor(x, device=dev), rate,
                       cfg.audio.sample_rate)
    if args.binaural is not None:
        _bake_binaural(args, room, cfg, p, n_l, dry)
        return
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
    write_audio(args.out, wet.T if wet.ndim > 1 else wet,
                cfg.audio.sample_rate)
    xrt = (len(dry) / cfg.audio.sample_rate) / dt
    print(f"baked {len(dry)} samples in {dt:.3f}s ({xrt:.1f}x realtime) "
          f"-> {args.out}")


def _sweep_mesh(dev):
    """The mesh ``sweep --sharded`` splits the rooms over: every card of a
    host with more than one, else None (the unsharded sweep)."""
    if dev.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    from .parallel.mesh import make_mesh
    return make_mesh((torch.cuda.device_count(), 1))


def cmd_sweep(args) -> None:
    from .models.rooms import random_rooms
    from .parallel.sweep import sweep_rooms, sweep_rooms_sharded

    if args.stereo is not None:
        print("note: --stereo is ignored by sweep (mono listeners per room)")
    dev = torch.device(args.device)
    scenes, sources, listeners = random_rooms(args.rooms, seed=args.seed,
                                              n_bands=args.bands, device=dev)
    ir_len = int(args.sample_rate * args.reverb)
    kw = dict(n_rays=args.rays, max_bounces=args.bounces,
              sample_rate=args.sample_rate, ir_length=ir_len,
              n_frames=args.frames)
    mesh = _sweep_mesh(dev) if args.sharded else None
    t0 = time.perf_counter()
    if mesh is not None:
        irs = sweep_rooms_sharded(scenes, sources, listeners, args.seed,
                                  mesh, **kw)
    else:
        irs = sweep_rooms(scenes, sources, listeners, args.seed, **kw)
    irs_dev, irs = irs, irs.cpu().numpy()      # waits for the device
    dt = time.perf_counter() - t0
    np.savez_compressed(args.out, irs=irs, sources=sources,
                        listeners=listeners)
    print(f"swept {args.rooms} rooms in {dt:.2f}s "
          f"({args.rooms / dt:.1f} rooms/s) -> {args.out} "
          f"irs shape {irs.shape}")
    if args.metrics_out:
        from .analysis import analyze_dataset
        # the IRs are frame-normalized by sweep_rooms already
        metrics = analyze_dataset(irs_dev, args.sample_rate)
        del irs_dev
        np.savez_compressed(args.metrics_out, **metrics)
        rt = metrics["rt60_t20_s"]
        print(f"metrics -> {args.metrics_out}; RT60(T20) median "
              f"{np.nanmedian(rt):.3f}s over {np.isfinite(rt).sum()}"
              f"/{rt.size} decays spanning the fit window")


def _air_alpha_arr(args, n_bands: int, dev):
    """Per-band ISO 9613-1 alpha ``[K]`` (dB/m) for ``--air`` on ``dev``,
    else None (the stream applies it to every chunk's IR)."""
    if not args.air:
        return None
    from .ops import air
    freqs = air.band_frequencies(n_bands)
    alpha = air.iso9613_alpha(freqs, args.air_temp, args.air_humidity)
    print("air absorption: " + ", ".join(
        f"{f:.0f} Hz {a * 1000:.1f} dB/km" for f, a in zip(freqs, alpha)))
    return torch.as_tensor(np.asarray(alpha, np.float32), device=dev)


def _trajectory_poses(args, eng, room, listeners, chunk_dt):
    """``--move-listener`` / ``--move-source`` as a ``params_fn(chunk) ->
    TraceParams`` of poses drifting linearly at those velocities (m/s)."""
    vel = np.asarray([float(v) for v in args.move_listener.split(",")]) \
        if args.move_listener else np.zeros(2)
    svel = np.asarray([float(v) for v in args.move_source.split(",")]) \
        if args.move_source else np.zeros(2)
    directivity = _directivity_arr(args, room)
    mic_directivity = _mic_directivity_arr(args, room)

    def poses(i):
        drift = (vel * i * chunk_dt).astype(np.float32)
        sdrift = (svel * i * chunk_dt).astype(np.float32)
        return eng.params(np.asarray(room.source, np.float32) + sdrift,
                          listeners + drift, directivity=directivity,
                          mic_directivity=mic_directivity)

    return poses


def _binaural_setup(args, room, n_l: int, chunk_dt: float):
    """``--binaural``'s refusals and the per-chunk head facing: ``(enabled,
    facing_fn)``, ``facing_fn(i)`` in radians at chunk ``i``, turning
    ``--head-turn`` degrees a second."""
    if args.binaural is None:
        return False, None
    if args.stereo is not None \
            or _mic_directivity_arr(args, room) is not None:
        raise SystemExit("--binaural replaces --stereo and "
                         "--mic-directivity (it assigns the ear "
                         "patterns itself)")
    if n_l != 1:
        raise SystemExit("--binaural needs exactly one listener "
                         "(one head)")
    base = float(np.radians(args.binaural))
    turn = float(np.radians(args.head_turn)) * chunk_dt
    return True, (lambda i: base + turn * i)


def _stream_setup(args):
    """What ``stream`` and ``live`` build alike from their flags: ``(room,
    cfg, dry, run_kw, stream_kw)``, ``dry`` the input clip on the device,
    ``run_kw`` the keyword arguments ``stream_clip`` and ``LivePlayer.run``
    share (the per-chunk hooks through the pose feed, Doppler, the chunk
    count), ``stream_kw`` those ``Streamer`` and ``LivePlayer`` share."""
    from .engine import Engine
    from .ops.convolve import load_samples
    from .utils.audio_io import builtin_clip_path, read_audio

    dev = torch.device(args.device)
    room = _build_room(args, dev)
    cfg = _config(args)
    listeners, n_l = _listeners(args, room)
    eng = Engine(room.scene, cfg, n_listeners=n_l)
    x, rate = read_audio(args.infile or builtin_clip_path())
    dry = load_samples(torch.as_tensor(x, device=dev), rate,
                       cfg.audio.sample_rate)
    chunk_dt = cfg.audio.chunk_duration
    binaural, facing_fn = _binaural_setup(args, room, n_l, chunk_dt)
    poses = _trajectory_poses(args, eng, room, listeners, chunk_dt)
    run_kw = dict(zip(("params_fn", "facing_fn", "scene_fn", "control_fn"),
                      _pose_feed_wrap(args, poses, facing_fn, room,
                                      binaural)), doppler=_doppler_arg(args))
    # a timed stream wraps the clip at its end while config.audio.loop is
    # set (RayTraceManager.cs:74-77), else pads with silence; an untimed
    # one plays the clip once and flushes the reverb tail
    run_kw["total_chunks"] = None if args.duration is None \
        else max(1, int(round(args.duration / chunk_dt)))
    stream_kw = dict(
        seed=args.seed, n_listeners=n_l,
        frames_per_chunk=args.frames_per_chunk,
        diffraction=args.diffraction and args.diffraction_order,
        air_alpha=_air_alpha_arr(args, room.scene.n_bands, dev),
        binaural=binaural, head_radius=args.head_radius,
        arrival_taps=args.arrival_taps, arrival_window_s=args.arrival_window,
        arrival_match_bins=args.arrival_match_bins,
        band_split=args.band_split)
    return room, cfg, dry, run_kw, stream_kw


def _arrival_args(p):
    from .streaming import (_ARRIVAL_MATCH_BINS, _ARRIVAL_TAPS,
                            _ARRIVAL_WINDOW_S)
    p.add_argument("--arrival-taps", type=int, default=_ARRIVAL_TAPS,
                   metavar="N",
                   help="per-arrival Doppler: tracked early arrivals per "
                        f"listener (default {_ARRIVAL_TAPS}; raise for "
                        "scenes with many comparable early reflections)")
    p.add_argument("--arrival-window", type=float,
                   default=_ARRIVAL_WINDOW_S, metavar="S",
                   help="per-arrival Doppler: early IR window the taps "
                        f"may live in, seconds (default "
                        f"{_ARRIVAL_WINDOW_S})")
    p.add_argument("--arrival-match-bins", type=float,
                   default=_ARRIVAL_MATCH_BINS, metavar="B",
                   help="per-arrival Doppler: max IR-bin drift matched "
                        f"chunk-to-chunk (default "
                        f"{_ARRIVAL_MATCH_BINS:.0f} = ~0.5 m at 48 kHz)")


def _band_split_arg(p):
    from .ops.convolve import BAND_SPLITS
    p.add_argument("--band-split", choices=BAND_SPLITS, default="linear",
                   help="with --bands > 1: the bands of the convolution. "
                        "'linear' (default): K equal bands of [0, Nyquist], "
                        "as the JAX package splits; 'octave': bands about "
                        "the centres the air, the diffraction and banded "
                        "materials are computed at (octaves 125 Hz - 16 "
                        "kHz at --bands 8)")


def _doppler_arg(args):
    """``--doppler`` / ``--doppler-per-arrival`` as ``stream_clip``'s
    ``doppler=`` (the flags exclude each other at parse time)."""
    return "per_arrival" if args.doppler_per_arrival else args.doppler


def _viz_callback(out_path, every: int):
    """Every ``every`` chunks, write the chunk's normalized IR waveform as
    ``<out stem>_ir_NNNN.png`` (the reference's ``DrawIR`` blit while
    audio streams, ``RayTraceManager.cs:252-258``) on a worker thread;
    ``cb.flush()`` waits for the writes."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from .utils import viz

    stem = os.path.splitext(out_path)[0]
    pool = ThreadPoolExecutor(max_workers=1)

    def write(i, ir_host):
        path = f"{stem}_ir_{i:04d}.png"
        viz.save_image(path, viz.ir_waveform_image(ir_host, 1))
        print(f"wrote {path}")

    def cb(i, cur_ir):
        if i % every:
            return
        # a host copy now: the stream updates its IR in place
        pool.submit(write, i, cur_ir[0].detach().to("cpu", copy=True))

    cb.flush = lambda: pool.shutdown(wait=True)
    return cb


def _pose_feed_wrap(args, poses, facing_fn, room, binaural=False):
    """Wrap the trajectory's ``poses`` / ``facing_fn`` with the
    ``--pose-feed`` JSON-lines channel (a file being appended to, or
    ``-`` for stdin): live steering of a running stream or live session,
    the reference's edit-the-scene-while-it-plays loop
    (RayTraceManager.cs:50-61,67). Returns ``(poses, facing_fn, scene_fn,
    control_fn)``: the feed also moves named colliders (``obstacle``
    lines re-flatten through the room's SceneBuilder into the same padded
    wall count, RayTraceManager.cs:67,246-250) and carries the runtime
    verbs (``stop`` / ``reset_ir`` = Space / R, RayTraceManager.cs:55-61).
    A ``facing`` override on a stream that is not binaural has nowhere to
    go: it warns once instead of vanishing."""
    path = getattr(args, "pose_feed", None)
    if not path:
        return poses, facing_fn, None, None
    from .posefeed import PoseFeed

    feed = PoseFeed.open(path)
    if room.builder is not None:
        feed.bind_scene(room.builder)
    base_facing = facing_fn if facing_fn is not None else (lambda i: 0.0)
    warned = []

    def fed_poses(i):
        p = feed.params(poses(i), i)
        if not binaural and not warned \
                and feed.facing(None, i) is not None:
            import warnings
            warnings.warn(
                "pose feed 'facing' override ignored: this stream is not "
                "binaural (add --binaural to steer the head)",
                stacklevel=2)
            warned.append(True)
        return p

    fed_facing = (lambda i: feed.facing(base_facing(i), i)) \
        if binaural else None
    return (fed_poses, fed_facing, lambda i: feed.scene(room.scene, i),
            feed.control)


def cmd_stream(args) -> None:
    from .streaming import Streamer
    from .utils.audio_io import write_audio

    room, cfg, dry, run_kw, stream_kw = _stream_setup(args)
    streamer = Streamer(room.scene, cfg, **stream_kw)
    on_chunk = None
    if args.viz_every:
        viz_cb = _viz_callback(args.out, args.viz_every)
        on_chunk = lambda i, st: viz_cb(i, st.prev_ir)  # noqa: E731
    t0 = time.perf_counter()
    wet = streamer.stream_clip(dry, on_chunk=on_chunk, **run_kw)
    wet = wet.cpu().numpy()      # waits for the device
    dt = time.perf_counter() - t0
    if args.viz_every:
        viz_cb.flush()
    write_audio(args.out, wet.T if streamer.n_listeners > 1 else wet[0],
                cfg.audio.sample_rate)
    xrt = (wet.shape[-1] / cfg.audio.sample_rate) / dt
    print(f"streamed {wet.shape[-1]} samples in {dt:.2f}s "
          f"({xrt:.2f}x realtime) -> {args.out}")


def cmd_live(args) -> None:
    """The producer/consumer live pipeline: the stream's chunk step on the
    device feeding the native ring, an audio thread draining it at DSP
    cadence (the ``AudioManager.OnAudioFilterRead`` contract,
    AudioManager.cs:56-69), underruns reported instead of hidden."""
    from .live import LivePlayer
    from .utils.audio_io import write_audio

    room, cfg, dry, run_kw, stream_kw = _stream_setup(args)
    player = LivePlayer(room.scene, cfg, dsp_buffer=args.dsp_buffer,
                        device=torch.device(args.device), **stream_kw)
    on_chunk = _viz_callback(args.out or "live.wav", args.viz_every) \
        if args.viz_every else None
    sink = None
    if args.play:
        from .native import AudioSink
        try:
            sink = AudioSink(cfg.audio.sample_rate, player.n_listeners,
                             device=args.play_device)
        except RuntimeError as e:
            raise SystemExit(
                f"--play: {e} (run without --play to record to a WAV)")
    try:
        rep = player.run(dry, realtime=args.realtime or sink is not None,
                         on_chunk=on_chunk, sink=sink, **run_kw)
    finally:
        if sink is not None:
            sink.close()
    if on_chunk is not None:
        on_chunk.flush()
    if args.out:
        write_audio(args.out,
                    rep.audio.T if player.n_listeners > 1 else rep.audio[0],
                    cfg.audio.sample_rate)
    print(f"live: {rep.summary()}" + (f" -> {args.out}" if args.out else ""))


def _fit_target(args):
    """Room, config, engine params and the normalized target IR of a
    ``fit`` / ``locate`` command; exits as the JAX CLI does when the
    target's listeners or bands do not match the setup."""
    from .utils.checkpoint import load_ir_state
    room, cfg, _, n_l, _, p = _setup(args)
    target = load_ir_state(args.target, device=torch.device(
        args.device)).normalized()
    if target.shape[0] != n_l:
        raise SystemExit(
            f"target IR has {target.shape[0]} listeners; this setup has "
            f"{n_l} (use --stereo / scene JSON listeners to match)")
    if target.shape[-1] != room.scene.n_bands:
        raise SystemExit(
            f"target IR has {target.shape[-1]} bands; scene has "
            f"{room.scene.n_bands} (set --bands to match)")
    return room, cfg, p, target


def cmd_fit(args) -> None:
    """Inverse material estimation: fit the scene's per-group materials to
    a target IR (an ``--ir-out`` checkpoint of ``trace``, or any IRState
    npz) by gradient descent through the plain trace
    (``diff.fit_materials``); writes the JAX CLI's JSON report."""
    from . import diff

    room, cfg, p, target = _fit_target(args)
    groups, n_groups = diff.infer_material_groups(room.scene)
    fields = tuple(f for f in args.fields.split(",") if f)
    unknown = set(fields) - set(diff.FIELDS)
    if unknown:
        raise SystemExit(f"unknown --fields {sorted(unknown)}; pick from "
                         "absorption/scattering/transmission/ior")

    t0 = time.perf_counter()
    result = diff.fit_materials(
        room.scene, p, target, args.seed,
        n_rays=args.rays if args.fit_rays is None else args.fit_rays,
        max_bounces=args.bounces, sample_rate=cfg.audio.sample_rate,
        frames=args.fit_frames, groups=groups, fields=fields,
        loss=args.loss, steps=args.steps, lr=args.lr,
        soft=args.soft or "ior" in fields, device=args.device)
    losses = result.losses.cpu().numpy().astype(np.float64)
    dt = time.perf_counter() - t0

    absorption, scattering, transmission, ior = (
        x.cpu().numpy() for x in result.params.constrained())
    mask = room.scene.mask.cpu().numpy()
    report = {
        "loss": args.loss, "steps": args.steps,
        "loss_start": float(losses[:5].mean()),
        "loss_end": float(losses[-5:].mean()),
        "fields": list(fields),
        "groups": [],
    }
    for g in range(n_groups):
        walls = np.flatnonzero((groups == g) & mask)
        if walls.size == 0:
            continue  # padding-only group
        report["groups"].append({
            "group": g, "n_walls": int(walls.size),
            "first_wall": int(walls[0]),
            "absorption": [round(float(a), 4) for a in absorption[g]],
            "scattering": round(float(scattering[g]), 4),
            "transmission": round(float(transmission[g]), 4),
            "ior": round(float(ior[g]), 4),
        })
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"fit {len(report['groups'])} material groups in {dt:.1f}s "
          f"({args.steps} steps); loss {report['loss_start']:.4f} -> "
          f"{report['loss_end']:.4f} -> {args.out}")


def cmd_locate(args) -> None:
    """Source localization: recover the source position from a target IR
    by multi-start gradient descent through the plain trace with the soft
    splat (``diff.localize_source``). The configured source is not used
    by the fit; the report gives it for comparison."""
    from . import diff

    room, cfg, p, target = _fit_target(args)
    bounds = None
    if args.bounds:
        vals = [float(v) for v in args.bounds.split(",")]
        if len(vals) != 4:
            raise SystemExit("--bounds wants xmin,ymin,xmax,ymax")
        bounds = np.asarray([[vals[0], vals[1]], [vals[2], vals[3]]],
                            np.float32)

    t0 = time.perf_counter()
    result = diff.localize_source(
        room.scene, p, target, args.seed,
        n_rays=args.rays if args.fit_rays is None else args.fit_rays,
        max_bounces=args.bounces, sample_rate=cfg.audio.sample_rate,
        n_starts=args.starts, steps=args.steps, lr=args.lr,
        n_sources=args.sources, bounds=bounds, device=args.device)
    positions = result.positions.cpu().numpy()
    losses = result.losses.cpu().numpy()
    dt = time.perf_counter() - t0

    pos = np.atleast_2d(result.position.cpu().numpy())
    best = [[round(float(v), 4) for v in row] for row in pos]
    if args.sources == 1:
        best = best[0]
    report = {
        "position": best,
        "loss": round(float(result.loss), 6),
        "configured_source": [round(float(v), 4)
                              for v in np.asarray(room.source)],
        "starts": [
            {"position": np.round(np.asarray(sp, np.float64), 4).tolist(),
             "loss": round(float(loss), 6)}
            for sp, loss in zip(positions, losses)],
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    where = (f"({best[0]}, {best[1]})" if args.sources == 1 else
             " + ".join(f"({x}, {y})" for x, y in best))
    print(f"located source at {where} in {dt:.1f}s "
          f"({args.starts} starts x {args.steps} steps, "
          f"loss {report['loss']:.4f}) -> {args.out}")


def cmd_analyze(args) -> None:
    """The ISO 3382 report (RT60, EDT, C50/C80, D50, centre time, first
    arrival) of a saved IRState (``--ir-in``) or of a fresh trace of the
    configured room, and the Schroeder decay plot (``--edc-out``)."""
    from . import analysis
    from .utils.checkpoint import load_ir_state

    dev = torch.device(args.device)
    if args.ir_in:
        state = load_ir_state(args.ir_in, device=dev)
        sample_rate = args.sample_rate
        src = args.ir_in
        state = _apply_air(state, sample_rate, args.speed_of_sound, args)
    else:
        room, cfg, _, _, eng, p = _setup(args)
        state = eng.trace_frames(p, seed=args.seed, n_frames=args.frames)
        state = _apply_diffraction(state, room.scene, p,
                                   cfg.audio.sample_rate, args)
        state = _apply_air(state, cfg.audio.sample_rate,
                           cfg.sim.speed_of_sound, args)
        sample_rate = cfg.audio.sample_rate
        src = (f"traced {args.room} ({args.frames} frames x {args.rays} "
               "rays)")
    ir = state.normalized()
    metrics = analysis.analyze_ir(ir, sample_rate,
                                  speed_of_sound=args.speed_of_sound)
    n_listeners, _, n_bands = ir.shape
    report = {"source": src, "sample_rate": sample_rate,
              "ir_length": int(state.ir_length), "listeners": []}
    for li in range(n_listeners):
        bands = []
        for k in range(n_bands):
            bands.append({m: (None if np.isnan(v[li, k]) else
                              round(float(v[li, k]), 6))
                          for m, v in metrics.items()})
        report["listeners"].append({"listener": li, "bands": bands})
    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}")
    else:
        print(text)
    b0 = report["listeners"][0]["bands"][0]
    rt = b0["rt60_t20_s"]
    print(f"listener 0 band 0: RT60(T20) "
          f"{'n/a (decay exceeds IR length)' if rt is None else f'{rt:.3f} s'}"
          f", C50 {b0['c50_db']:.1f} dB, D50 {b0['d50']:.3f}, "
          f"direct {b0['direct_time_s'] * 1e3:.2f} ms "
          f"({b0['direct_distance_m']:.2f} m)")
    if args.edc_out:
        from .utils import viz
        viz.save_image(args.edc_out, viz.decay_curve_image(ir[0]))
        print(f"wrote {args.edc_out}")


def cmd_bench(args) -> None:
    from . import bench
    bench.main(device=args.device)


def _common(p, room: bool = True) -> None:
    """The flags every subcommand of the JAX CLI shares (those ported),
    plus ``--device``."""
    if room:
        p.add_argument("--room", default="smoll",
                       choices=["smoll", "big", "sample"])
        p.add_argument("--scene-json", default=None,
                       help="JSON scene file overriding --room")
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
    _device_arg(p)


def _device_arg(p) -> None:
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default %(default)s; cpu runs the "
                        "plain version)")


def _pose_feed_arg(p) -> None:
    """``stream`` / ``live``: the ``--pose-feed`` channel."""
    p.add_argument("--pose-feed", default=None, metavar="FILE",
                   help="steer the running stream: JSON-lines overrides "
                        "tailed from FILE ('-' = stdin), per line "
                        "{\"chunk\": i, \"source\": [x,y], "
                        "\"listener\": [x,y], \"facing\": rad} or "
                        "{\"obstacle\": name, \"position\": [x,y], "
                        "\"angle\": rad} (drag a wall mid-stream) or "
                        "{\"command\": \"stop\"|\"reset_ir\"} "
                        "(Space/R keys)")


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
    p.add_argument("--spatial-out", default=None, metavar="NPZ",
                   help="also trace a spatial (W/X/Y intensity) IR and "
                        "write its channels + per-bin direction-of-"
                        "arrival/diffuseness; prints the arrival table")
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
    p.add_argument("--in", dest="infile", default=None,
                   help="dry WAV or mp3 (default: the bundled "
                        "assets/dry_clip.wav)")
    p.add_argument("--out", required=True)
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--legacy", action="store_true",
                   help="use the legacy frequency-binned (muffle) pipeline")
    p.add_argument("--binaural", type=float, default=None,
                   metavar="FACING_DEG",
                   help="stereo bake through a two-ear head model facing "
                        "FACING_DEG: spatial (W/X/Y) trace, then a "
                        "DirAC-style ITD+ILD decode (replaces --stereo/"
                        "--mic-directivity)")
    p.add_argument("--head-radius", type=float, default=0.0875,
                   metavar="M", help="binaural head radius (meters)")
    _air_args(p)  # applied on the modern path (ignored with --legacy)
    p.set_defaults(fn=cmd_bake)

    p = sub.add_parser("stream", help="chunked streaming convolution")
    _common(p)
    p.add_argument("--in", dest="infile", default=None,
                   help="dry WAV or mp3 (default: the bundled "
                        "assets/dry_clip.wav)")
    p.add_argument("--out", required=True)
    p.add_argument("--move-listener", default=None,
                   help="listener velocity 'vx,vy' (m/s)")
    p.add_argument("--move-source", default=None,
                   help="source velocity 'vx,vy' (m/s); the IR retraces "
                        "each chunk, so a moving source reverberates "
                        "correctly; add --doppler for the pitch shift")
    dop = p.add_mutually_exclusive_group()
    dop.add_argument("--doppler", action="store_true",
                     help="fractional-rate dry feed: pitch shifts by "
                          "1 - v/c from the poses' radial velocity")
    dop.add_argument("--doppler-per-arrival", action="store_true",
                     help="per-path Doppler: the direct sound and each "
                          "dominant early reflection glide at their own "
                          "rates, derived from the traced IRs (composes "
                          "with --binaural and banded scenes)")
    _pose_feed_arg(p)
    p.add_argument("--frames-per-chunk", type=int, default=1)
    p.add_argument("--duration", type=float, default=None,
                   help="stream for this many seconds; the clip loops at "
                        "its end while audio.loop is set "
                        "(RayTraceManager.cs:74-77)")
    p.add_argument("--viz-every", type=int, default=0, metavar="N",
                   help="write the live IR waveform PNG every N chunks "
                        "(<out stem>_ir_NNNN.png)")
    p.add_argument("--binaural", type=float, default=None,
                   metavar="FACING_DEG",
                   help="binaural stereo stream: per-chunk spatial trace "
                        "+ ITD/ILD ear decode, head facing FACING_DEG "
                        "(replaces --stereo/--mic-directivity)")
    p.add_argument("--head-turn", type=float, default=0.0, metavar="DEG_S",
                   help="with --binaural: rotate the head DEG_S deg/s")
    p.add_argument("--head-radius", type=float, default=0.0875,
                   metavar="M")
    _arrival_args(p)
    _band_split_arg(p)
    _air_args(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("live", help="producer/consumer live audio pipeline "
                                    "(audio thread drains the native ring)")
    _common(p)
    p.add_argument("--in", dest="infile", default=None,
                   help="dry WAV or mp3 (default: the bundled "
                        "assets/dry_clip.wav)")
    p.add_argument("--out", default=None,
                   help="record what the audio thread heard")
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--frames-per-chunk", type=int, default=1)
    p.add_argument("--dsp-buffer", type=int, default=1024,
                   help="audio callback granularity (reference "
                        "m_DSPBufferSize = 1024)")
    p.add_argument("--realtime", action="store_true",
                   help="pace the audio thread on the wall clock "
                        "(underruns counted when the producer lags)")
    p.add_argument("--move-listener", default=None,
                   help="listener velocity 'vx,vy' (m/s)")
    p.add_argument("--move-source", default=None,
                   help="source velocity 'vx,vy' (m/s)")
    dop = p.add_mutually_exclusive_group()
    dop.add_argument("--doppler", action="store_true",
                     help="fractional-rate dry feed (same physics as "
                          "stream --doppler)")
    dop.add_argument("--doppler-per-arrival", action="store_true",
                     help="per-path Doppler (same physics as stream "
                          "--doppler-per-arrival)")
    _pose_feed_arg(p)
    p.add_argument("--play", action="store_true",
                   help="play through the OS audio device (ALSA through "
                        "the native sink; implies realtime pacing by the "
                        "device clock); exits with the reason where no "
                        "sound system exists")
    p.add_argument("--play-device", default="default", metavar="PCM",
                   help="ALSA PCM device name for --play")
    p.add_argument("--viz-every", type=int, default=0, metavar="N",
                   help="write the live IR waveform PNG every N chunks "
                        "(<out stem>_ir_NNNN.png)")
    p.add_argument("--binaural", type=float, default=None,
                   metavar="FACING_DEG",
                   help="binaural live: per-chunk spatial trace + ITD/ILD "
                        "ear decode, head facing FACING_DEG")
    p.add_argument("--head-turn", type=float, default=0.0, metavar="DEG_S",
                   help="with --binaural: rotate the head DEG_S deg/s")
    p.add_argument("--head-radius", type=float, default=0.0875,
                   metavar="M")
    _arrival_args(p)
    _band_split_arg(p)
    _air_args(p)
    p.set_defaults(fn=cmd_live)

    p = sub.add_parser("sweep", help="IR dataset over procedural rooms")
    p.add_argument("--rooms", type=int, default=64)
    p.add_argument("--out", required=True)
    p.add_argument("--sharded", action="store_true",
                   help="split the rooms over every CUDA device (one card: "
                        "the unsharded sweep)")
    p.add_argument("--metrics-out", default=None,
                   help="also write per-room acoustics metrics "
                        "(RT60/EDT/C50/C80/D50/... as [rooms, L, K] "
                        "arrays) in one batched pass")
    _common(p, room=False)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("fit", help="inverse material estimation: fit "
                       "per-group wall materials to a target IR by "
                       "autograd through the trace")
    _common(p)
    p.add_argument("--target", required=True,
                   help="target IRState npz (e.g. from trace --ir-out)")
    p.add_argument("--out", required=True, help="fitted materials JSON")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.08)
    p.add_argument("--loss", default="edc+mse",
                   choices=["mse", "edc", "edc+mse", "blur"])
    p.add_argument("--fields", default="absorption,scattering",
                   help="comma list of material fields to fit; 'ior' "
                        "needs delay gradients and implies --soft "
                        "(transmission has no pathwise gradient)")
    p.add_argument("--soft", action="store_true",
                   help="soft two-bin IR splat forward (delay gradients; "
                        "pair with --loss blur)")
    p.add_argument("--fit-rays", type=int, default=None,
                   help="rays per fitting step (default: --rays)")
    p.add_argument("--fit-frames", type=int, default=1,
                   help="MC frames per fitting step")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("locate", help="acoustic source localization: "
                       "recover the source position from a target IR by "
                       "autograd through the trace")
    _common(p)
    p.add_argument("--target", required=True,
                   help="target IRState npz (e.g. from trace --ir-out)")
    p.add_argument("--out", required=True, help="localization report JSON")
    p.add_argument("--starts", type=int, default=8,
                   help="random restarts (one parameter under one Adam)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.08)
    p.add_argument("--fit-rays", type=int, default=None,
                   help="rays per fitting step (default: --rays)")
    p.add_argument("--sources", type=int, default=1,
                   help="fit N simultaneous sources jointly")
    p.add_argument("--bounds", default=None,
                   help="search box xmin,ymin,xmax,ymax (default: scene "
                        "AABB; pass the room INTERIOR for --sources > 1)")
    p.set_defaults(fn=cmd_locate)

    p = sub.add_parser("analyze", help="room-acoustics metrics (RT60, "
                       "EDT, C50/C80, D50, centre time, first arrival) "
                       "from a traced or saved IR")
    _common(p)
    p.add_argument("--ir-in", default=None,
                   help="IRState npz to analyze (e.g. from trace "
                        "--ir-out; --sample-rate must match it); default: "
                        "trace the configured room")
    p.add_argument("--out", default=None,
                   help="report JSON (default: stdout)")
    p.add_argument("--edc-out", default=None,
                   help="Schroeder decay-curve plot PNG")
    p.add_argument("--speed-of-sound", type=float, default=343.0)
    _air_args(p)
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("bench", help="run the benchmark suite")
    _device_arg(p)
    p.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
