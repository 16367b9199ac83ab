#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        [--control 3] [--seconds 1]

For each seed, in one process: the cell's set-up and a short window at its
own load (``--seconds``), then the comparison of its sampled answers with
the plain reference, as a run makes it (the lower reading); for the first
``--control`` seeds also the control: the same reference computed in
bfloat16, the precision below the configurations' float32, put in the
program's place (the upper reading). Prints one JSON line a seed: the
largest of each compared number, ``lower`` and ``control``. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, root: Path = ROOT, card: bool = True) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(root))
    import torch
    from benchmark import capture, run

    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        one = argparse.Namespace(workload=args.workload, seed=seed)
        ready = run.prepare(one, root, card, time.perf_counter())
        if ready is None:
            return 2
        cell, env, drv, devices, setup_s = ready
        capture.timed(drv, args.seconds, setup_s, env.sample)
        dtype = torch.bfloat16 if n < args.control else None
        keys, gaps, _, secs, ctl = run.compare(drv, env, card, dtype)
        line = {"seed": seed, "keys": keys, "reference_s": secs,
                "lower": {k: max(v) for k, v in gaps.items()}}
        if ctl is not None:
            line["control"] = {k: max(v) for k, v in ctl.items()}
        print(json.dumps(line), flush=True)
        del drv, env
    return 0


if __name__ == "__main__":
    sys.exit(main())
