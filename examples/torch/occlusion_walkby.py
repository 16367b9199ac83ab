"""Occlusion walk-by on the PyTorch port: stream audio while the listener
walks through the acoustic shadow of an opaque pillar, with and without
the edge-diffraction shadow fill (ops/diffraction.py) and atmospheric
absorption (ops/air.py).

Without diffraction the trace has the reference's hard shadows: the wet
signal collapses to the few wall-bounce paths while the pillar blocks
the line of sight. With ``diffraction=True`` the Maekawa knife-edge paths
around the pillar tips fill the shadow (their visibility sweeps run in
the wall-sweep kernel K2 on the card): the level dips smoothly instead
of cratering, which is what a real walk-by sounds like.

Success criterion: in the shadowed middle chunks the plain stream is
EXACTLY silent while the diffraction stream is not; both agree while the
line of sight is clear; air absorption only removes energy.

Run:  python examples/torch/occlusion_walkby.py  [--device cpu]
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
    SceneBuilder)
from realisticaudioraytracing2d_tpu_torch.ops import air  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.utils import audio_io  # noqa: E402

SR = 16000
N_CHUNKS = 24
SOURCE = np.asarray([-6.0, 0.0], np.float32)


def setup(dev):
    """The classic barrier demo: an opaque free-standing pillar, no room
    shell (in the shadow the plain trace is EXACTLY silent; in a live
    room the diffracted path is still there but sits under the reverb);
    the config, the walk's poses, the dry noise and the air's alpha."""
    opaque = AudioMaterial(absorption=0.8, scattering=0.6, transmission=0.0,
                           ior=1.0)
    b = SceneBuilder(n_bands=1)
    b.add_segment((0.0, -3.0), (0.0, 3.0), (1.0, 0.0), opaque)  # thin pillar
    cfg = art.smoll_room_config(ray_count=4000)
    cfg = dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, max_bounces=4),
        audio=dataclasses.replace(cfg.audio, sample_rate=SR,
                                  reverb_duration=0.25))

    # The listener walks a straight line on the far side of the pillar:
    # x = +4, y from -8 (clear) through 0 (deep shadow) to +8 (clear).
    def poses(i):
        y = -8.0 + 16.0 * i / (N_CHUNKS - 1)
        return art.TraceParams.make(SOURCE, np.asarray([4.0, y], np.float32),
                                    listener_radius=0.5, device=dev)

    return dict(scene=b.build(device=dev), cfg=cfg, poses=poses,
                dry=audio_io.noise_burst(N_CHUNKS * cfg.audio.chunk_duration,
                                         SR, seed=7),
                air_alpha=torch.as_tensor(
                    air.iso9613_alpha(air.band_frequencies(1)),
                    dtype=torch.float32, device=dev))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    parser.add_argument("--out", default="occlusion_out")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    su = setup(dev)
    scene, cfg = su["scene"], su["cfg"]
    dry = torch.as_tensor(su["dry"], device=dev)
    runs = {}
    for name, kw in [
            ("plain", {}),
            ("diffraction", dict(diffraction=True)),
            ("diffraction+air", dict(diffraction=True,
                                     air_alpha=su["air_alpha"]))]:
        streamer = art.Streamer(scene, cfg, seed=0, **kw)
        wet = streamer.stream_clip(dry, su["poses"],
                                   total_chunks=N_CHUNKS).cpu().numpy()[0]
        audio_io.write_wav(os.path.join(args.out, f"walkby_{name}.wav"),
                           wet, SR)
        n = cfg.audio.chunk_samples
        levels = np.asarray([np.sqrt(np.mean(wet[i * n:(i + 1) * n] ** 2))
                             for i in range(N_CHUNKS)])
        runs[name] = levels
        print(f"{name:16s} chunk RMS: " +
              " ".join(f"{lv:7.1e}" for lv in levels[::4]))

    mid = slice(N_CHUNKS // 2 - 2, N_CHUNKS // 2 + 2)   # deep shadow
    clear = slice(0, 3)                                  # clear line of sight
    assert np.all(runs["plain"][mid] == 0.0), \
        "free-field shadow must be exactly silent without diffraction"
    assert np.all(runs["diffraction"][mid] > 0.0), \
        "diffraction must add energy in the shadow"
    ratio = runs["diffraction"][clear].sum() / max(
        runs["plain"][clear].sum(), 1e-12)
    assert 0.8 < ratio < 1.2, f"clear-LOS levels should agree, ratio={ratio}"
    assert np.all(runs["diffraction+air"][mid] <= runs["diffraction"][mid]
                  + 1e-12), "air absorption must not add energy"
    print("OK: shadow filled by diffraction; clear-LOS unchanged; air "
          f"attenuates. WAVs in {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
