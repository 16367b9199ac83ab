"""IR dataset generation over procedural rooms, sharded across a device
mesh (BASELINE.json config #5 at demo scale), on the PyTorch port.

Run:  python examples/torch/dataset_sweep.py [--rooms 64] [--device cpu]

On the card it splits the rooms over ``make_mesh()``, every CUDA device
(one K9 launch per card); with ``--device cpu`` over a virtual mesh of 8
CPU devices, so the sharded path runs anywhere. Writes dataset.npz, prints
per-room IR stats, and checks that the sharded dataset equals the
unsharded sweep of the same rooms bit for bit.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from realisticaudioraytracing2d_tpu_torch.models.rooms import \
    random_rooms  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.parallel.mesh import \
    make_mesh  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.parallel.sweep import (  # noqa: E402
    sweep_rooms, sweep_rooms_sharded)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rooms", type=int, default=64)
    parser.add_argument("--rays", type=int, default=4096)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="dataset.npz")
    args = parser.parse_args(argv)

    dev = torch.device(args.device)
    mesh = make_mesh((8,), ("rooms",), devices=[dev] * 8) \
        if dev.type == "cpu" else make_mesh(axis_names=("rooms",))
    n_dev = mesh.shape["rooms"]
    rooms = (args.rooms // n_dev) * n_dev or n_dev
    scenes, sources, listeners = random_rooms(rooms, seed=0, n_obstacles=3,
                                              device=dev)
    print(f"{rooms} rooms, {scenes.a.shape[1]} padded walls each, "
          f"{n_dev} devices ({mesh.first})")

    kw = dict(n_rays=args.rays, max_bounces=6, sample_rate=16000,
              ir_length=16000, n_frames=2)
    t0 = time.perf_counter()
    irs = sweep_rooms_sharded(scenes, sources, listeners, 0, mesh, **kw)
    irs = irs.cpu().numpy()                   # waits for the devices
    dt = time.perf_counter() - t0
    print(f"swept in {dt:.2f}s ({rooms / dt:.1f} rooms/s incl. the kernels' "
          "first build)")

    np.savez_compressed(args.out, irs=irs, sources=sources,
                        listeners=listeners)
    energies = irs.sum(axis=(1, 2, 3))
    print(f"wrote {args.out}: irs {irs.shape}; "
          f"per-room energy min/med/max = {energies.min():.4f}/"
          f"{np.median(energies):.4f}/{energies.max():.4f}")
    whole = sweep_rooms(scenes, sources, listeners, 0, **kw).cpu().numpy()
    if not np.array_equal(irs, whole):
        raise SystemExit("the sharded dataset differs from the unsharded "
                         "sweep")
    if (energies > 0).mean() < 0.5:
        raise SystemExit(f"only {(energies > 0).sum()} of {rooms} rooms "
                         "carry energy")
    print(f"dataset sweep ok: {rooms} rooms over {n_dev} shards == the "
          "unsharded sweep, bit for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
