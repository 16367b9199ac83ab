#!/usr/bin/env python
"""The two flagship streaming modes COMPOSED, on the PyTorch port: a
source walks past a two-eared head while each acoustic path carries its
own Doppler glide.

A 1 kHz source approaches the listener head-on while receding from a
mirror wall behind it; the head faces +y, so everything arrives at the
right ear first (ITD) and louder (ILD). The stream runs binaural
per-arrival Doppler (``doppler="per_arrival"`` + ``binaural=True``): taps
come from the spatial capture's W channel (the directive bounce kernel K4
on the card), their bearings from X/Y, and each becomes per-ear gliding
fractional-delay taps.

Asserts, per ear, from one stream's spectrum:
* the DIRECT line is shifted UP by ``f0 v/c`` and the ECHO line DOWN by
  the same amount (per-path Doppler: a shared-rate warp cannot produce
  the down-shifted line);
* the right ear is louder at the source band (ILD ~ (1+s)/(1-s)) and
  hears it earlier (ITD ~ 2 r sin(phi) / c, measured by band-limited
  cross-correlation within one unambiguous period).

Run: python examples/torch/binaural_walkby.py [--device cpu]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import realisticaudioraytracing2d_tpu_torch as art  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.materials import (  # noqa: E402
    AudioMaterial)
from realisticaudioraytracing2d_tpu_torch.models.scene import (  # noqa: E402
    SceneBuilder, Transform2D)
from realisticaudioraytracing2d_tpu_torch.streaming import \
    Streamer  # noqa: E402

SR, F0, V, C = 8000, 1000.0, 2.0, 343.0
HEAD_RADIUS, SHADOW = 0.0875, 0.6


def setup(dev, rays: int, chunks: int):
    """The mirror wall behind the source, the config, the poses (the
    source walks 3.0 m -> 1.0 m toward the head) and the dry 1 kHz
    sine."""
    cfg = art.smoll_room_config(ray_count=rays)
    cfg = dataclasses.replace(
        cfg,
        sim=dataclasses.replace(cfg.sim, listener_radius=0.05),
        audio=dataclasses.replace(cfg.audio, sample_rate=SR,
                                  reverb_duration=0.15,
                                  chunk_duration=0.1))
    n = cfg.audio.chunk_samples
    mirror = AudioMaterial(absorption=0.0, scattering=0.0,
                           transmission=0.0, ior=1.0)
    b = SceneBuilder()
    b.add_box(mirror, Transform2D(position=(6.5, 0.0)), size=(1.0, 2.0),
              name="mirror")
    scene = b.build(device=dev)
    eng = art.Engine(scene, cfg)
    lis = np.asarray([0.0, 0.0], np.float32)

    def poses(i):
        x = 3.0 - V * (i * n / SR)          # walks 3.0 m -> 1.0 m
        return eng.params(np.asarray([x, 0.0], np.float32), lis)

    t_all = np.arange((chunks + 4) * n) / SR
    return dict(scene=scene, cfg=cfg, poses=poses,
                dry=np.sin(2 * np.pi * F0 * t_all).astype(np.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain versions)")
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--chunks", type=int, default=10)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    sr, f0, v, c = SR, F0, V, C
    head_radius, shadow = HEAD_RADIUS, SHADOW
    su = setup(dev, args.rays, args.chunks)
    n = su["cfg"].audio.chunk_samples
    dry = torch.as_tensor(su["dry"], device=dev)
    wet = (Streamer(su["scene"], su["cfg"], seed=0, frames_per_chunk=4,
                    binaural=True, head_radius=head_radius, shadow=shadow)
           .stream_clip(dry, su["poses"], loop=False,
                        total_chunks=args.chunks,
                        doppler="per_arrival",
                        facing_fn=lambda i: np.pi / 2)).cpu().numpy()
    seg = wet[:, 2 * n:args.chunks * n]
    win = np.hanning(seg.shape[-1])
    freqs = np.fft.rfftfreq(seg.shape[-1], 1.0 / sr)
    f_up, f_dn = f0 * (1.0 + v / c), f0 * (1.0 - v / c)
    print(f"source at {v} m/s: direct line predicted {f_up:.1f} Hz, "
          f"wall echo {f_dn:.1f} Hz (from {f0:.0f} Hz)")
    names = ("left", "right")
    for ear in (0, 1):
        spec = np.abs(np.fft.rfft(seg[ear] * win))
        floor = max(spec[(freqs >= f0 - 40) & (freqs <= f0 - 25)].max(),
                    spec[(freqs >= f0 + 25) & (freqs <= f0 + 40)].max())
        iu = np.argmax(np.where((freqs >= f0 + 1) & (freqs <= f0 + 15),
                                spec, 0))
        idn = np.argmax(np.where((freqs >= f0 - 15) & (freqs <= f0 - 1),
                                 spec, 0))
        print(f"  {names[ear]:5s} ear: direct {freqs[iu]:.1f} Hz "
              f"({spec[iu] / floor:.0f}x floor), echo {freqs[idn]:.1f} Hz "
              f"({spec[idn] / floor:.0f}x floor)")
        assert spec[iu] > 8.0 * floor and spec[idn] > 3.0 * floor
        assert abs(freqs[iu] - f_up) < 2.5 and abs(freqs[idn] - f_dn) < 2.5

    def band(x):
        s = np.fft.rfft(x)
        s[(freqs < f0 - 20) | (freqs > f0 + 20)] = 0.0
        return np.fft.irfft(s, x.size)

    bl, br = band(seg[0]), band(seg[1])
    ild = np.sqrt(np.mean(br ** 2) / np.mean(bl ** 2))
    pad, lags = 12, np.arange(-3, 8)
    xc = [np.dot(br[pad:-pad], bl[pad + k:bl.size - pad + k])
          for k in lags]
    itd = lags[int(np.argmax(xc))] / sr * 1e3
    want_itd = 2.0 * head_radius / c * 1e3
    print(f"  ILD right/left = {ild:.2f}x "
          f"(head-shadow model (1+s)/(1-s) = "
          f"{(1 + shadow) / (1 - shadow):.1f}); "
          f"ITD right leads by {itd:.2f} ms "
          f"(2r/c = {want_itd:.2f} ms)")
    assert 2.0 < ild < 7.0
    assert want_itd * 0.5 <= itd <= want_itd * 1.6
    print("binaural per-arrival walkby OK: direct shifts up, echo "
          "shifts down, lateralized right in both time and level")
    return 0


if __name__ == "__main__":
    sys.exit(main())
