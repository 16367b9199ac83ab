"""Acoustic source TRACKING on the PyTorch port: follow a moving source
chunk by chunk.

Extends ``examples/torch/locate_source.py`` in time: the source moves
through the room, each streaming chunk yields an impulse response at ONE
fixed microphone, and each chunk's position estimate warm-starts from the
previous one (``diff.localize_source(starts=prev)``), so per-chunk fits
are short (few steps, fine blur) after the first full multi-start solve.

This is the inverse counterpart of the engine's own streaming pipeline
(``streaming.py`` retraces the IR per chunk as poses move: the
reference's ``RayTraceManager.FixedUpdate`` loop): the forward path
renders audio from motion, this script recovers motion from audio.

Run:  python examples/torch/track_source.py [--device cpu] [--chunks 12]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from realisticaudioraytracing2d_tpu_torch import diff  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.materials import \
    AudioMaterial  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.rooms import \
    shoebox_room  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops.trace import \
    TraceParams  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.utils import viz  # noqa: E402

SR, IR_LEN, BOUNCES = 8000, 512, 4
LISTENER = np.asarray([1.2, 0.8])


def setup(dev):
    scene = shoebox_room(4.0, 4.0,
                         wall_material=AudioMaterial(absorption=0.3,
                                                     scattering=0.4),
                         device=dev)
    params = TraceParams.make(source=(0.0, 0.0), listeners=(1.2, 0.8),
                              listener_radius=0.5, device=dev)
    return scene, params


def trajectory(chunks: int) -> np.ndarray:
    """The true trajectory ``[chunks, 2]``: an arc through the room."""
    t = np.linspace(0.0, 1.0, chunks)
    return np.stack([-1.3 + 2.2 * t, 1.1 * np.sin(np.pi * t) - 0.8], axis=1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda or cpu (the plain trace under autograd "
                        "either way)")
    parser.add_argument("--chunks", type=int, default=12)
    parser.add_argument("--rays", type=int, default=256)
    parser.add_argument("--track-steps", type=int, default=60,
                        help="warm-started Adam steps per chunk")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)

    scene, params = setup(dev)
    path = trajectory(args.chunks)

    def measure(src):
        p = params._replace(source=torch.as_tensor(src, dtype=torch.float32,
                                                   device=dev))
        return diff.simulate_ir(scene, p, 0, n_rays=args.rays,
                                max_bounces=BOUNCES, sample_rate=SR,
                                ir_length=IR_LEN, soft=True, device=dev)

    t0 = time.time()
    estimates = []
    prev = None
    for i, true_src in enumerate(path):
        target = measure(true_src)
        if prev is None:
            # cold solve: full multi-start, coarse-to-fine
            result = diff.localize_source(
                scene, params, target, 0, n_rays=args.rays,
                max_bounces=BOUNCES, sample_rate=SR, n_starts=8, steps=150,
                device=dev)
        else:
            # tracking solve: the previous estimate plus a ring of jittered
            # hypotheses (multi-hypothesis tracking: a lone warm start can
            # lose lock in a local minimum and the drift compounds), short
            # schedule, moderate blur.
            ring = prev + 0.25 * np.array(
                [[0, 0], [1, 0], [-1, 0], [0, 1], [0, -1]], np.float32)
            result = diff.localize_source(
                scene, params, target, 0, n_rays=args.rays,
                max_bounces=BOUNCES, sample_rate=SR, starts=ring,
                steps=args.track_steps, sigma0=10.0, sigma_min=1.0,
                anneal_steps=15.0, device=dev)
        est = result.position.cpu().numpy()
        prev = est[None, :]
        estimates.append(est)
        err = float(np.linalg.norm(est - true_src))
        print(f"chunk {i:2d}: true ({true_src[0]:+.2f}, {true_src[1]:+.2f})"
              f"  est ({est[0]:+.2f}, {est[1]:+.2f})  |err| {err:.3f} m")

    estimates = np.stack(estimates)
    errs = np.linalg.norm(estimates - path, axis=1)
    dt = time.time() - t0
    print(f"\ntracked {args.chunks} chunks in {dt:.1f}s "
          f"({dt / args.chunks * 1e3:.0f} ms/chunk amortized)")
    print(f"mean |err| {errs.mean():.3f} m, max {errs.max():.3f} m")

    viz.save_image("track.png",
                   viz.render_trajectory(scene, path, estimates,
                                         listener=LISTENER,
                                         listener_radius=0.5))
    print("wrote track.png (green = true path, yellow = estimates)")
    if errs.mean() > 0.2:
        raise SystemExit("tracking failed (mean err > 0.2 m)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
