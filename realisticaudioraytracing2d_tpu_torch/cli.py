"""Command-line entry point of the port (the ``sweep`` subcommand).

Port of ``realisticaudioraytracing2d_tpu/cli.py``'s ``sweep``: an IR dataset
over procedurally generated rooms, traced on the card through the
rooms-batched kernel K9 (one launch for the whole dataset)::

    python -m realisticaudioraytracing2d_tpu_torch.cli sweep --rooms 1024 \\
        --out irs.npz

The flags and defaults are those the JAX ``sweep`` reads, plus
``--device`` (default ``cuda``; the CPU runs the plain version). It
writes the same ``npz`` (``irs`` ``[rooms, 1, T, K]`` frame-normalized,
``sources``, ``listeners``) and prints the same ``swept ... rooms/s``
line. The JAX CLI's other subcommands, ``--sharded`` and
``--metrics-out`` (``analysis.py``) are not ported yet (ROADMAP).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .device import DEFAULT_DEVICE


def cmd_sweep(args) -> None:
    from .models.rooms import random_rooms
    from .parallel.sweep import sweep_rooms

    if args.stereo is not None:
        print("note: --stereo is ignored by sweep (mono listeners per room)")
    dev = torch.device(args.device)
    scenes, sources, listeners = random_rooms(args.rooms, seed=args.seed,
                                              n_bands=args.bands, device=dev)
    ir_len = int(args.sample_rate * args.reverb)
    t0 = time.perf_counter()
    irs = sweep_rooms(scenes, sources, listeners, args.seed,
                      n_rays=args.rays, max_bounces=args.bounces,
                      sample_rate=args.sample_rate, ir_length=ir_len,
                      n_frames=args.frames)
    irs = irs.cpu().numpy()      # waits for the device
    dt = time.perf_counter() - t0
    np.savez_compressed(args.out, irs=irs, sources=sources,
                        listeners=listeners)
    print(f"swept {args.rooms} rooms in {dt:.2f}s "
          f"({args.rooms / dt:.1f} rooms/s) -> {args.out} "
          f"irs shape {irs.shape}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m realisticaudioraytracing2d_tpu_torch.cli",
        description="2D audio ray tracing, PyTorch/CUDA port")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("sweep", help="IR dataset over procedural rooms")
    p.add_argument("--rooms", type=int, default=64)
    p.add_argument("--out", required=True)
    p.add_argument("--rays", type=int, default=15000)
    p.add_argument("--bounces", type=int, default=5)
    p.add_argument("--bands", type=int, default=1)
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--reverb", type=float, default=1.5)
    p.add_argument("--frames", type=int, default=8,
                   help="Monte-Carlo trace frames to accumulate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stereo", default=None, metavar="SEP",
                   help="ignored by sweep (mono listeners per room)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default %(default)s; cpu runs the "
                        "plain version)")
    p.set_defaults(fn=cmd_sweep)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
