"""NEGATIVE RESULT (kept as reproduction), on the PyTorch port: obstacle
POSE is not reliably fittable by pathwise gradients.

Source position and ior fit well (examples/torch/locate_source.py)
because their dominant signal is smooth: hit delays move continuously
with the parameter. Moving an OCCLUDER is different: its dominant effect
on the IR is *visibility* (which rays get blocked), a boundary term that
pathwise autodiff misses entirely without edge sampling (the standard
differentiable-path-tracing bias noted in diff.py's module docstring).

The setup: a 4x4 shoebox, a 0.8x0.4 slab, 3 microphones, 1024 rays, a
grid of starts under Adam, an annealed blurred loss. The true pose's
loss is exactly 0 by common random numbers (the target and every fit
trace the same seed), yet the starts settle elsewhere. Fixing this needs
reparametrized/edge-sampled visibility gradients, not more starts.

The grid's starts are one ``[G*G, 2]`` parameter under one Adam, each
start's loss its own summand (Adam is elementwise, so each moves as
under its own optimizer). Autograd runs through the plain trace.

Run:  python examples/torch/obstacle_pose_negative.py [--device cpu]
      [--steps 200] [--grid 4]
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
from realisticaudioraytracing2d_tpu_torch.models.scene import \
    Transform2D  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops.trace import \
    TraceParams  # noqa: E402

SR, IR_LEN, N_RAYS, B = 16000, 1024, 1024, 4
TRUE_C = (0.2, 0.3)


def setup(center, dev):
    wall = AudioMaterial(absorption=0.3, scattering=0.3)
    obst = AudioMaterial(absorption=0.6, scattering=0.1)
    return shoebox_room(4.0, 4.0, wall_material=wall,
                        obstacles=[(Transform2D(center, 0.0, (0.8, 0.4)),
                                    obst)], device=dev)


def trace_params(dev):
    return TraceParams.make(source=(-1.4, 0.2),
                            listeners=[(1.4, -0.3), (1.2, 1.2), (-0.3, -1.4)],
                            listener_radius=0.4, device=dev)


def sigmas(steps: int) -> torch.Tensor:
    """The annealed blur widths, float32 (computed in float64, as JAX's)."""
    return torch.as_tensor(32.0 * 0.5 ** (np.arange(steps) / 30) + 1.0,
                           dtype=torch.float32)


def grid_starts(g: int) -> np.ndarray:
    """``g x g`` starts ``[g*g, 2]`` over [-0.9, 0.9]^2, x fastest."""
    gx, gy = np.meshgrid(np.linspace(-0.9, 0.9, g, dtype=np.float32),
                         np.linspace(-0.9, 0.9, g, dtype=np.float32))
    return np.stack([gx.ravel(), gy.ravel()], -1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda or cpu (the plain trace under autograd "
                        "either way)")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--grid", type=int, default=4,
                        help="grid x grid starts")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)

    params = trace_params(dev)
    kw = dict(n_rays=N_RAYS, max_bounces=B, sample_rate=SR,
              ir_length=IR_LEN, soft=True, device=dev)
    target = diff.simulate_ir(setup(TRUE_C, dev), params, 0, **kw)
    scene0 = setup((0.0, 0.0), dev)
    groups, _ = diff.infer_material_groups(scene0)
    g_obst = int(groups[16])
    is_g = torch.as_tensor(groups == g_obst, device=dev) & scene0.mask

    def loss_fn(delta, sigma):
        d = torch.where(is_g[:, None], delta[None, :],
                        delta.new_zeros(()))
        sc = scene0._replace(a=scene0.a + d, b=scene0.b + d)
        pred = diff.simulate_ir(sc, params, 0, **kw)
        return diff._blur_rel_l2(pred, target, sigma)

    sig = sigmas(args.steps).to(dev)
    ds = torch.as_tensor(grid_starts(args.grid), device=dev)
    ds.requires_grad_(True)
    adam = torch.optim.Adam([ds], lr=0.04)
    t0 = time.time()
    for sigma in sig:
        adam.zero_grad(set_to_none=True)
        sum(loss_fn(ds[s], sigma) for s in range(ds.shape[0])).backward()
        adam.step()
    with torch.no_grad():
        ls = torch.stack([loss_fn(ds[s], sig[-1])
                          for s in range(ds.shape[0])])
    ds, ls = ds.detach().cpu().numpy(), ls.cpu().numpy()
    best = int(np.argmin(ls))
    print("best", ds[best], "loss", ls[best], "true", TRUE_C,
          f"err {np.linalg.norm(ds[best] - np.asarray(TRUE_C)):.3f} m, "
          f"{time.time() - t0:.0f}s")
    print("top3:", sorted(zip(ls, map(tuple, np.round(ds, 2))))[:3])
    return 0


if __name__ == "__main__":
    sys.exit(main())
