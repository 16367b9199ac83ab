#!/usr/bin/env python3
"""The digests of the cluster kernels' unsharded calls that
``chip_smoke.py``'s [17l] holds (K8 on the 10,008- and 40,008-wall
cities, the 8-band K7 on the 40,008-wall one: ``chip_smoke.LARGE_FRAMES``),
and the ptxas lines of the one-band ``accel_bounce_kernel`` instantiations,
built from the package of one checkout:

    python3 scripts/torch_accel_frame_bits.py [--root DIR] [--out FILE]

``--root`` (default: this checkout) names the checkout whose package is
imported, built into ``DIR/build/torch_kernels/`` and run. With the
parent commit unpacked under ``build/`` (``git archive <parent> | tar -x
-C build/parent``) it gives the digests ``chip_smoke.PARENT_BITS`` keeps
for frame offset 0; run it on both checkouts in one call and compare.
The scenes, seeds and shapes are ``chip_smoke.py``'s (``LARGE_FRAMES``,
``city_setup``, ``large_frames_run``), so [17l] digests exactly
these calls. Needs an NVIDIA GPU and nvcc.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_accel_frame_bits: no CUDA device")
    import realisticaudioraytracing2d_tpu_torch as art
    from realisticaudioraytracing2d_tpu_torch.bench import card_line
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        accel_kernel as ak
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    package = os.path.dirname(os.path.abspath(art.__file__))
    if os.path.dirname(package) != root:
        raise SystemExit(f"imported the package from {package}, not {root}")
    secs = build.build()
    build.load_library()
    lines = {k: v for k, v in cs.ptxas_table(build.build_log()).items()
             if k.startswith("accel_bounce_kernel<1,")}
    dev = torch.device("cuda")
    out = {"root": root, "card": card_line(), "build_s": secs,
           "ptxas": lines, "bits": {}}
    cities = {}
    for name, (boxes, bands, *_rest) in cs.LARGE_FRAMES.items():
        if (boxes, bands) not in cities:
            cities[boxes, bands] = cs.city_setup(art, dev, boxes, bands)
        scene, p = cities[boxes, bands]
        t0 = time.perf_counter()
        ir = cs.large_frames_run(ak, name, scene, p)
        out["bits"][name] = cs.ir_sha(torch, ir)
        print(f"{name}: {out['bits'][name]} (energy {float(ir.sum()):.6e}, "
              f"{time.perf_counter() - t0:.2f} s)", flush=True)
    print(f"ptxas of accel_bounce_kernel<1, ...>: {lines}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
