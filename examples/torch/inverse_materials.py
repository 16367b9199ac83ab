"""Inverse material estimation on the PyTorch port: recover wall
absorption from a target IR.

A capability the reference pipeline (Unity/HLSL compute, no autodiff)
cannot express: the forward trace is plain PyTorch, so we synthesize a
"measured" impulse response with ground-truth materials, then recover
them by gradient descent through the ray tracer under autograd
(``diff.fit_materials``; the hand kernels have no backward, so the plain
trace runs on the chosen device, the card too).

Fits two groups at once, the left/right vs top/bottom shoebox walls,
starting from deliberately wrong absorptions. (Every wall sees plenty of
ray traffic, so both groups are strongly identifiable from one
listener's energy-decay curve; a small interior obstacle, by contrast,
moves the EDC less than the Monte-Carlo noise floor at this ray budget.)

Run:  python examples/torch/inverse_materials.py [--device cpu] [--steps 80]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch  # noqa: E402

from realisticaudioraytracing2d_tpu_torch import diff  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.materials import \
    AudioMaterial  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.scene import (  # noqa: E402
    SceneBuilder, Transform2D)
from realisticaudioraytracing2d_tpu_torch.ops.trace import \
    TraceParams  # noqa: E402

SR, IR_LEN, BOUNCES = 16000, 2048, 8
TRUE = {"sides": 0.507, "topbot": 0.148}   # the shipped material values
START = {"sides": 0.10, "topbot": 0.60}    # deliberately wrong
# Three listeners: one EDC has a sides<->topbot trade-off plateau;
# spatially spread microphones (plus the edc+mse loss) make both groups
# identifiable.
LISTENERS = [(1.6, 1.2), (0.0, -1.6), (2.2, -0.4)]


def setup(dev):
    """The trace parameters (one source, three listeners), the true room
    and the room the fit starts from."""
    params = TraceParams.make(source=(-1.8, 0.6), listeners=LISTENERS,
                              listener_radius=0.5, device=dev)
    return dict(params=params,
                true_scene=room(TRUE["sides"], TRUE["topbot"], dev),
                start_scene=room(START["sides"], START["topbot"], dev))


def room(sides_abs, topbot_abs, dev):
    """6x5 m shoebox; left/right walls one material, top/bottom another."""
    sides = AudioMaterial(absorption=sides_abs, scattering=0.5)
    topbot = AudioMaterial(absorption=topbot_abs, scattering=1.0)
    w, h, t = 6.0, 5.0, 1.0
    b = SceneBuilder()
    b.add_box(topbot, Transform2D((0, h / 2 + t / 2), 0, (w + 2 * t, t)))
    b.add_box(topbot, Transform2D((0, -h / 2 - t / 2), 0, (w + 2 * t, t)))
    b.add_box(sides, Transform2D((-w / 2 - t / 2, 0), 0, (t, h)))
    b.add_box(sides, Transform2D((w / 2 + t / 2, 0), 0, (t, h)))
    return b.build(device=dev)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda or cpu (the plain trace under autograd "
                        "either way)")
    parser.add_argument("--steps", type=int, default=150)
    parser.add_argument("--rays", type=int, default=256)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)

    su = setup(dev)
    params, start_scene = su["params"], su["start_scene"]
    target = diff.simulate_ir(su["true_scene"], params, 7, n_rays=args.rays,
                              max_bounces=BOUNCES, sample_rate=SR,
                              ir_length=IR_LEN, frames=8, device=dev)

    groups, n_groups = diff.infer_material_groups(start_scene)

    t0 = time.perf_counter()
    result = diff.fit_materials(
        start_scene, params, target, 0,
        n_rays=args.rays, max_bounces=BOUNCES, sample_rate=SR,
        frames=4, fields=("absorption",), loss="edc+mse",
        steps=args.steps, lr=0.08, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    fitted = torch.sigmoid(result.params.absorption)[:, 0].cpu().numpy()
    losses = result.losses.cpu().numpy()
    print(f"{args.steps} Adam steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.0f} ms/step)")
    print(f"loss: {losses[:5].mean():.4f} -> {losses[-5:].mean():.4f}")

    # map fitted groups back to named walls via any wall index of each kind
    topbot_g = int(groups[0])   # first segment of the top wall box
    sides_g = int(groups[8])    # first segment of the left wall box
    for name, g in [("sides", sides_g), ("topbot", topbot_g)]:
        print(f"{name:9s} true={TRUE[name]:.3f} start={START[name]:.3f} "
              f"fitted={fitted[g]:.3f}  "
              f"(|err|={abs(fitted[g] - TRUE[name]):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
