"""Steered speaker-array demo on the PyTorch port: per-source aims in one
mixdown launch.

An 8-element vertical line array of cardioid sources is aimed at a focal
listener; a second listener sits behind the array. Per-source
directivity rides ``TraceParams.directivity`` as an [S, C] row table: on
the card the whole array traces in ONE launch of the rooms-batched
bounce kernel K9 (``parallel/multisource.py``), each source weighting its
own emission in the kernel. The same array re-run omni shows what the
steering buys: front/back energy contrast at the two listeners.

Run:  python examples/torch/speaker_array.py [--device cpu] [--elements 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import realisticaudioraytracing2d_tpu_torch as art  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.materials import (  # noqa: E402
    AudioMaterial)
from realisticaudioraytracing2d_tpu_torch.models.scene import (  # noqa: E402
    SceneBuilder)
from realisticaudioraytracing2d_tpu_torch.ops import \
    directivity as dv  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.parallel.multisource import (  # noqa: E402
    trace_sources_mixdown)
from realisticaudioraytracing2d_tpu_torch.utils import viz  # noqa: E402

LISTENERS = np.asarray([[5.0, 0.0],      # focal listener (front)
                        [-7.0, 0.0]],    # behind the array
                       np.float32)


def setup(dev, n: int):
    """A 16 x 12 hall, mildly absorbing; the ``n`` element positions
    ``[S, 2]`` (a vertical line at x = -5) and their cardioid rows ``[S,
    C]``, each aimed at the focal listener; the omni trace parameters."""
    m = AudioMaterial(absorption=0.35, scattering=0.4, transmission=0.0,
                      ior=1.0)
    b = SceneBuilder(n_bands=1)
    b.add_box(m, size=(16.0, 12.0))
    # half-wavelengthish spacing
    ys = np.linspace(-1.4, 1.4, n)
    sources = np.stack([np.full(n, -5.0), ys], axis=1).astype(np.float32)
    aims = np.stack([dv.cardioid(float(np.arctan2(0.0 - y, 5.0 - (-5.0))))
                     for y in ys]).astype(np.float32)
    return dict(scene=b.build(device=dev), sources=sources,
                aims=torch.as_tensor(aims, device=dev),
                params=art.TraceParams.make(sources, LISTENERS, 0.5, 343.0,
                                            1.0, device=dev))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    parser.add_argument("--out", default="speaker_array_out")
    parser.add_argument("--elements", type=int, default=8)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    S = args.elements
    su = setup(dev, S)
    scene, sources, p = su["scene"], su["sources"], su["params"]
    kw = dict(n_rays=30000, max_bounces=6, sample_rate=16000,
              ir_length=16000)

    t0 = time.time()
    irs = {"steered": trace_sources_mixdown(
        scene, p._replace(directivity=su["aims"]), 0, **kw), "omni": trace_sources_mixdown(scene, p, 0, **kw)}
    steered, omni = (irs[k].cpu().numpy() for k in ("steered", "omni"))
    dt = time.time() - t0

    def db(x):
        return 10.0 * np.log10(max(x, 1e-30))

    # early (direct-dominated) energy window per listener
    def early(ir, l):
        d = float(np.linalg.norm(sources.mean(0) - LISTENERS[l]))
        b0 = int(d / 343.0 * 16000)
        return float(ir[l, b0 - 40:b0 + 200, 0].sum())

    contrast_steered = db(early(steered, 0)) - db(early(steered, 1))
    contrast_omni = db(early(omni, 0)) - db(early(omni, 1))
    route = ("one K9 launch each" if dev.type == "cuda"
             else "plain version on the CPU")
    print(f"{S}-element array traced twice in {dt:.2f}s ({route})")
    print(f"front/back early-energy contrast: steered "
          f"{contrast_steered:+.1f} dB vs omni {contrast_omni:+.1f} dB "
          f"(steering gain {contrast_steered - contrast_omni:+.1f} dB)")

    for name, ir in irs.items():
        png = os.path.join(args.out, f"ir_{name}.png")
        viz.save_image(png, viz.ir_waveform_image(ir[0, :, 0], frames=1))
        print("wrote", png)

    assert contrast_steered > contrast_omni + 3.0, \
        "steering should buy >3 dB of front/back contrast"
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
