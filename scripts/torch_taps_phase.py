#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 13f (per-arrival Doppler's tap kernels
beside their plain chain) alone on one NVIDIA GPU, in about a minute with
the kernels' build.

    python3 scripts/torch_taps_phase.py [--out taps.json]

It builds the kernels and calls ``chip_smoke.taps_phase``; any failed
check raises. ``--out`` writes the readings as JSON.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import realisticaudioraytracing2d_tpu_torch as art  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.bench import card_line  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops.cuda import build  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the readings here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_taps_phase: no CUDA device")
    t0 = time.perf_counter()
    print(f"build {build.build():.1f} s; {card_line()}", flush=True)
    readings = cs.taps_phase(dict(torch=torch, art=art, build=build,
                                    dev=torch.device(cs.DEVICE)))
    print(f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), "readings": readings}, f,
                      indent=1)


if __name__ == "__main__":
    main()
