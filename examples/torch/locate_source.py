"""Acoustic source localization with ONE microphone, via differentiable
echoes, on the PyTorch port.

A single listener's first arrival only fixes a range circle around it:
classical trilateration needs three microphones. But the impulse
response also carries every wall reflection, and those echo delays
depend on where the source sits on that circle. Because the plain ray
tracer is differentiable under autograd (soft two-bin IR splat,
``ops/ir.py::scatter_hits_soft``), ``diff.localize_source`` recovers the
source position by multi-start Adam through the simulation: all starts
one parameter under one Adam, each start's loss its own.

The reference (Unity/HLSL graphics pipeline) cannot express this: there
is no gradient through a compute-shader dispatch.

Run:  python examples/torch/locate_source.py [--device cpu] [--starts 8]
      [--steps 200]
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

SR, IR_LEN, BOUNCES = 8000, 512, 4
TRUE_SOURCE = np.asarray([-1.0, 0.4], np.float32)


def setup(dev):
    """The shoebox and the one-microphone trace parameters."""
    scene = shoebox_room(4.0, 4.0,
                         wall_material=AudioMaterial(absorption=0.3,
                                                     scattering=0.4),
                         device=dev)
    params = TraceParams.make(source=TRUE_SOURCE, listeners=(1.0, 0.3),
                              listener_radius=0.5, device=dev)
    return scene, params


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda or cpu (the plain trace under autograd "
                        "either way)")
    parser.add_argument("--starts", type=int, default=8)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--rays", type=int, default=256)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)

    scene, params = setup(dev)
    # "Measure" an IR at the single microphone (soft-binned: the same
    # forward model the optimizer uses; a real measurement would be
    # hard-binned, which adds at most one bin of bias).
    target = diff.simulate_ir(scene, params, 0, n_rays=args.rays,
                              max_bounces=BOUNCES, sample_rate=SR,
                              ir_length=IR_LEN, soft=True, device=dev)

    t0 = time.time()
    result = diff.localize_source(scene, params, target, 0,
                                  n_rays=args.rays, max_bounces=BOUNCES,
                                  sample_rate=SR, n_starts=args.starts,
                                  steps=args.steps, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0

    best = result.position.cpu().numpy()
    err = float(np.linalg.norm(best - TRUE_SOURCE))
    print(f"{args.starts} starts x {args.steps} steps in {dt:.1f}s "
          f"(one Adam over every start)")
    for pos, loss in zip(result.positions.cpu().numpy(),
                         result.losses.cpu().numpy()):
        tag = " <- best" if np.allclose(pos, best) else ""
        print(f"  start -> ({pos[0]:+.3f}, {pos[1]:+.3f})  "
              f"loss {loss:9.4f}{tag}")
    print(f"true   ({TRUE_SOURCE[0]:+.3f}, {TRUE_SOURCE[1]:+.3f})")
    print(f"fitted ({best[0]:+.3f}, {best[1]:+.3f})   |err| = {err:.3f} m")
    if err > 0.15:
        raise SystemExit("localization failed (err > 0.15 m)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
