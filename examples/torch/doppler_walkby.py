"""Per-arrival Doppler walk-by on the PyTorch port: a tonal source drives
toward the listener while receding from a reflecting wall behind it, the
classic siren-pass physics. The direct path shortens (pitch UP by
``1 + v/c``) while the wall-echo path lengthens (pitch DOWN by
``1 - v/c``): two different pitches from ONE moving source, which a
shared-rate Doppler feed cannot produce (it warps everything at the
direct rate) and the reference cannot produce at all (its chunk
convolution is time-invariant: ``RayTraceManager.cs:91-123``).

Streams the same trajectory three ways, plain, shared-rate
(``doppler=True``) and per-arrival (``doppler="per_arrival"``), each
chunk's IR from the bounce kernel K4 on the card; writes the WAVs, and
measures the up/down spectral lines of the per-arrival output against
the predicted Doppler frequencies.

Success criterion (self-asserted): the per-arrival spectrum carries
BOTH lines within the FFT grid of ``f0 (1 +- v/c)``, each well above the
local spectral floor.

Run:  python examples/torch/doppler_walkby.py  [--device cpu]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import realisticaudioraytracing2d_tpu_torch as art  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.engine import Engine  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.materials import (  # noqa: E402
    AudioMaterial)
from realisticaudioraytracing2d_tpu_torch.models.scene import (  # noqa: E402
    SceneBuilder, Transform2D)
from realisticaudioraytracing2d_tpu_torch.streaming import \
    Streamer  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.utils import audio_io  # noqa: E402

SR = 8000
V, C, F0 = 2.0, 343.0, 1000.0
LISTENER = np.asarray([0.0, 0.0], np.float32)


def setup(dev, rays: int, chunks: int):
    """Open field with one short mirror wall behind the source (short
    keeps the echo compact: a long wall smears it into a stationary-phase
    plateau); the config, the poses (the source drives from 3 m toward
    the listener at V) and the dry 1 kHz sine."""
    mirror = AudioMaterial(absorption=0.0, scattering=0.0, transmission=0.0,
                           ior=1.0)
    builder = SceneBuilder()
    builder.add_box(mirror, Transform2D(position=(6.5, 0.0)),
                    size=(1.0, 2.0))
    scene = builder.build(device=dev)
    cfg = art.smoll_room_config(ray_count=rays)
    cfg = dataclasses.replace(
        cfg,
        sim=dataclasses.replace(cfg.sim, listener_radius=0.05),
        audio=dataclasses.replace(cfg.audio, sample_rate=SR,
                                  reverb_duration=0.15, chunk_duration=0.1))
    eng = Engine(scene, cfg)
    n = cfg.audio.chunk_samples

    def poses(i):
        x = 3.0 - V * (i * n / SR)
        return eng.params(np.asarray([x, 0.0], np.float32), LISTENER)

    t_all = np.arange((chunks + 4) * n) / SR
    return dict(scene=scene, cfg=cfg, poses=poses,
                dry=np.sin(2 * np.pi * F0 * t_all).astype(np.float32))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    parser.add_argument("--out", default="doppler_out")
    parser.add_argument("--rays", type=int, default=2048)
    parser.add_argument("--chunks", type=int, default=10)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    total = args.chunks
    su = setup(dev, args.rays, total)
    scene, cfg, poses = su["scene"], su["cfg"], su["poses"]
    n = cfg.audio.chunk_samples
    dry = torch.as_tensor(su["dry"], device=dev)

    outputs = {}
    for label, mode in (("plain", False), ("shared", True),
                        ("per_arrival", "per_arrival")):
        wet = (Streamer(scene, cfg, seed=0, frames_per_chunk=4)
               .stream_clip(dry, poses, loop=False, total_chunks=total,
                            doppler=mode)).cpu().numpy()[0]
        outputs[label] = wet
        path = os.path.join(args.out, f"walkby_{label}.wav")
        audio_io.write_wav(path, wet / max(1e-9, np.abs(wet).max()) * 0.8,
                           SR)
        print(f"wrote {path}")

    # spectral analysis of the steady middle
    seg = outputs["per_arrival"][2 * n:total * n]
    win = np.hanning(seg.size)
    spec = np.abs(np.fft.rfft(seg * win))
    freqs = np.fft.rfftfreq(seg.size, 1.0 / SR)

    def band(f_lo, f_hi):
        m = (freqs >= f_lo) & (freqs <= f_hi)
        return spec[m], freqs[m]

    f_up, f_dn = F0 * (1 + V / C), F0 * (1 - V / C)
    up_s, up_f = band(F0 + 1, F0 + 15)
    dn_s, dn_f = band(F0 - 15, F0 - 1)
    floor = max(band(F0 - 40, F0 - 25)[0].max(),
                band(F0 + 25, F0 + 40)[0].max())
    up_hz = up_f[np.argmax(up_s)]
    dn_hz = dn_f[np.argmax(dn_s)]
    print(f"predicted lines: direct {f_up:.2f} Hz (up), "
          f"echo {f_dn:.2f} Hz (down)")
    print(f"measured lines:  direct {up_hz:.2f} Hz "
          f"({up_s.max() / floor:.1f}x floor), echo {dn_hz:.2f} Hz "
          f"({dn_s.max() / floor:.1f}x floor)")

    assert abs(up_hz - f_up) < 2.2, "direct line off the predicted Doppler"
    assert abs(dn_hz - f_dn) < 2.2, "echo line off the predicted Doppler"
    assert up_s.max() > 10 * floor and dn_s.max() > 4 * floor
    print("per-arrival Doppler: direct shifts up, echo shifts down: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
