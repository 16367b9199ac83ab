"""End-to-end demo on the PyTorch port: trace the SmollRoom, render debug
views, bake and stream a synthetic clip, and write all artifacts to
./demo_out/.

Run:  python examples/torch/demo.py  [--device cpu]
(the trace runs in the hand-written kernels on the card by default;
``--device cpu`` runs the plain PyTorch versions anywhere)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import realisticaudioraytracing2d_tpu_torch as art  # noqa: E402
from realisticaudioraytracing2d_tpu_torch import analysis, diff  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.materials import \
    AudioMaterial  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.rooms import \
    shoebox_room  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops import air, \
    directivity  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops.trace import \
    TraceParams  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.utils import audio_io, \
    viz  # noqa: E402


def setup(dev):
    """What the demo traces: SmollRoom at 4,096 rays, its poses, the
    moving listener's trajectory, the dry clips, the shoebox of the
    localization section, the 8-band SmollRoom and the cardioid source."""
    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config(ray_count=4096)
    eng = art.Engine(room.scene, cfg)

    def moving(i):
        # listener walks +x at 2 m/s
        pos = room.listener + np.array(
            [2.0 * i * cfg.audio.chunk_duration, 0.0], np.float32)
        return eng.params(room.source, pos)

    # Localization needs a line-of-sight first arrival (SmollRoom's source
    # hides behind the transmissive slant wall: see diff.localize_source),
    # so that section runs in a shoebox, the validated regime.
    box = shoebox_room(4.0, 4.0, wall_material=AudioMaterial(
        absorption=0.3, scattering=0.4), device=dev)
    p_box = TraceParams.make(source=(-1.0, 0.4), listeners=(1.0, 0.3),
                             listener_radius=0.5, device=dev)
    room_b = art.rooms.smoll_room(n_bands=8, device=dev)
    cfg_b = art.smoll_room_config(ray_count=2048, n_bands=8)
    eng_b = art.Engine(room_b.scene, cfg_b)
    return dict(
        room=room, cfg=cfg, eng=eng,
        params=eng.params(room.source, room.listener), moving=moving,
        dry=audio_io.click_clip(1.0, cfg.audio.sample_rate,
                                click_times=(0.1, 0.5)),
        dry2=audio_io.noise_burst(0.8, cfg.audio.sample_rate, seed=2),
        box=box, p_box=p_box, room_b=room_b, cfg_b=cfg_b, eng_b=eng_b,
        params_b=eng_b.params(room_b.source, room_b.listener),
        params_card=eng_b.params(room_b.source, room_b.listener,
                                 directivity=directivity.cardioid(0.0)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    parser.add_argument("--out", default="demo_out")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    # --- scene + engine -----------------------------------------------------
    su = setup(dev)
    room, cfg, eng, params = (su[k] for k in ("room", "cfg", "eng",
                                              "params"))

    # --- trace + debug views ------------------------------------------------
    t0 = time.perf_counter()
    state = eng.trace_frames(params, seed=0, n_frames=8)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"traced 8 frames x 4096 rays in {time.perf_counter() - t0:.2f}s "
          f"(incl. the first call's set-up)")

    _, dbg = eng.trace_debug(params, seed=0, n_debug=64)
    viz.save_image(os.path.join(args.out, "scene.png"),
                   viz.render_scene(room.scene, room.source, room.listener,
                                    room.listener_radius, dbg,
                                    draw_normals=True))
    viz.save_image(os.path.join(args.out, "ir.png"),
                   viz.ir_waveform_image(state.sum[0], state.frames))
    print("wrote scene.png, ir.png")

    # --- offline bake -------------------------------------------------------
    dry = su["dry"]
    wet = eng.bake(torch.as_tensor(dry, device=dev), state).cpu().numpy()
    audio_io.write_wav(os.path.join(args.out, "bake.wav"), wet,
                       cfg.audio.sample_rate)
    print("wrote bake.wav (two clicks through the room reverb)")

    # --- streaming with a moving listener -----------------------------------
    streamer = art.Streamer(room.scene, cfg, seed=0)
    t0 = time.perf_counter()
    wet2 = streamer.stream_clip(torch.as_tensor(su["dry2"], device=dev),
                                su["moving"]).cpu().numpy()
    dt = time.perf_counter() - t0
    audio_io.write_wav(os.path.join(args.out, "stream.wav"), wet2[0],
                       cfg.audio.sample_rate)
    xrt = (wet2.shape[-1] / cfg.audio.sample_rate) / dt
    print(f"wrote stream.wav ({xrt:.2f}x realtime)")

    # --- inverse problems (differentiable acoustics) ------------------------
    # in the shoebox; autograd runs through the plain trace (the hand
    # kernels have no backward)
    box, p_box = su["box"], su["p_box"]
    tiny = diff.simulate_ir(box, p_box, 0, n_rays=256, max_bounces=4,
                            sample_rate=8000, ir_length=512, soft=True,
                            device=dev)
    t0 = time.perf_counter()
    loc = diff.localize_source(box, p_box, tiny, 0, n_rays=256,
                               max_bounces=4, sample_rate=8000, n_starts=4,
                               steps=120, device=dev)
    pos = loc.position.cpu().numpy()
    print(f"localized a shoebox source at ({pos[0]:+.2f}, {pos[1]:+.2f}) "
          f"from one listener's IR in {time.perf_counter() - t0:.1f}s (true "
          f"(-1.00, +0.40))")

    # --- banded (frequency-dependent) variant -------------------------------
    cfg_b, eng_b = su["cfg_b"], su["eng_b"]
    state_b = eng_b.trace_frames(su["params_b"], seed=0, n_frames=4)
    viz.save_image(os.path.join(args.out, "spectrogram.png"),
                   viz.ir_spectrogram_image(state_b.sum[0], state_b.frames))
    wet_b = eng_b.bake(torch.as_tensor(dry, device=dev),
                       state_b).cpu().numpy()
    audio_io.write_wav(os.path.join(args.out, "bake_banded.wav"), wet_b,
                       cfg_b.audio.sample_rate)
    print("wrote spectrogram.png, bake_banded.wav (8-band HF-rolloff "
          "materials)")

    # --- room-acoustics analysis + physics addenda --------------------------
    sr_b = cfg_b.audio.sample_rate
    ir_b = state_b.normalized()
    wet_ir = air.apply_air_absorption(
        ir_b, sr_b, air.iso9613_alpha(air.band_frequencies(8)))
    m_dry = analysis.analyze_ir(ir_b, sr_b)
    m_wet = analysis.analyze_ir(wet_ir, sr_b)
    print(f"SmollRoom band 0/7 RT60(T20): "
          f"{m_dry['rt60_t20_s'][0, 0]:.3f}/{m_dry['rt60_t20_s'][0, 7]:.3f} s"
          f" (with air absorption: {m_wet['rt60_t20_s'][0, 0]:.3f}/"
          f"{m_wet['rt60_t20_s'][0, 7]:.3f} s); "
          f"D50 {m_dry['d50'][0, 0]:.2f}, direct "
          f"{m_dry['direct_distance_m'][0, 0]:.1f} m")
    viz.save_image(os.path.join(args.out, "edc.png"),
                   viz.decay_curve_image(ir_b[0].cpu().numpy()))

    state_card = eng_b.trace_frames(su["params_card"], seed=0, n_frames=4)
    e_omni = float(state_b.sum.sum())
    e_card = float(state_card.sum.sum())
    print(f"cardioid source aimed +x vs omni: {e_card / e_omni:.2f}x "
          f"captured energy (same total radiated power); wrote edc.png")

    print(f"done -> {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
