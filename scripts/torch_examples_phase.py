#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 18 (the example twins of
``examples/torch/``) alone on one NVIDIA GPU.

    python3 scripts/torch_examples_phase.py [--full] [--out FILE]

It builds the kernels, gives the phase the launch counters of the
smoke's ``main()`` (``chip_smoke.launch_counters``) and calls
``chip_smoke.examples_phase``: every twin by its ``main(argv)`` at the
phase's depth cuts, or with ``--full`` at its defaults (the JAX
examples' arguments), ``track_source.py`` included. Any failed claim or
check raises. ``--out`` writes the card, each twin's seconds and the
launch counts as JSON.
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
from realisticaudioraytracing2d_tpu_torch.bench import card_line  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops.cuda import build  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="every twin at its defaults (no depth cut)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_examples_phase: no CUDA device")
    t0 = time.perf_counter()
    print(f"build {build.build():.1f} s", flush=True)
    build.load_library()
    _, only, counted = cs.launch_counters()
    card = card_line()
    ctx = dict(torch=torch, dev=torch.device("cuda"), counted=counted,
               only=only, card=card)
    launches, seconds = cs.examples_phase(ctx, full=args.full)
    total = time.perf_counter() - t0
    print(f"launches {launches}; {total:.1f} s with the build", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "full": args.full, "seconds": seconds,
                       "launches": launches, "total_s": total}, f, indent=1)


if __name__ == "__main__":
    main()
