#!/usr/bin/env python3
"""How far the plain trace on the CPU parts from the card's, on one NVIDIA
GPU.

One SmollRoom frame at the shipped width (15,000 rays x 5 bounces, 48 kHz,
72,000 bins) for each of ``--frames`` seeds, traced three ways from the
same seed (the same Philox numbers): K4 on the card, the plain trace on
the card and the plain trace on the CPU; mono and as the binaural stream's
three-microphone capture. Prints per seed the largest gap of each pair
and the number of bins that differ by more than 1e-6 of the IR's peak
(rounding differs by less).

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 scripts/torch_trace_cpu_vs_card.py [--frames 4]
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_cpu_vs_card: no CUDA device")
    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch import spatial as sp
    from realisticaudioraytracing2d_tpu_torch.ops import ir as irm
    from realisticaudioraytracing2d_tpu_torch.ops import rng
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"device: {card} | torch {torch.__version__}", flush=True)
    build.build()
    build.load_library()
    runs = (("K4", "cuda", "auto"), ("card plain", "cuda", "plain"),
            ("CPU plain", "cpu", "auto"))
    kw = dict(n_rays=15000, max_bounces=5, sample_rate=48000)
    for f in range(args.frames):
        seed = rng.mix_seed(9, f)
        irs = {}
        for name, dev, backend in runs:
            room = art.rooms.smoll_room(device=dev)
            p = art.TraceParams.make(room.source, room.listener, device=dev)
            for what, pp in (("mono", p), ("capture", sp.spatial_params(p))):
                st = art.trace_accumulate(
                    room.scene, pp, irm.IRState.zeros(
                        72000, pp.listeners.shape[0], 1, device=dev),
                    seed=seed, backend=backend, **kw)
                irs[name, what] = st.sum.cpu()
        for what in ("mono", "capture"):
            ref = irs["K4", what]
            peak = float(ref.abs().max())
            said = []
            for name in ("card plain", "CPU plain"):
                d = (irs[name, what] - ref).abs()
                said.append(f"K4 vs {name}: max {float(d.max()):.3e}, "
                            f"{int((d > 1e-6 * peak).sum())} bins over "
                            f"1e-6 of the peak")
            print(f"seed {seed} {what} (peak {peak:.3e}): "
                  + "; ".join(said), flush=True)


if __name__ == "__main__":
    main()
