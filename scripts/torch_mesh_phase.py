#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 17 (the device-mesh paths) alone on one
NVIDIA GPU, in about a minute with the kernels' build.

    python3 scripts/torch_mesh_phase.py

It builds the kernels, makes the 10,008-wall city the phase shards
(``city_scene(2500)``, as the smoke's phase 9 does), gives the phase the
launch counters of the smoke's ``main()``
(``chip_smoke.launch_counters``) and calls
``chip_smoke.mesh_phase``; any failed check raises.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.bench import card_line  # noqa: E402
import realisticaudioraytracing2d_tpu_torch as art  # noqa: E402
from realisticaudioraytracing2d_tpu_torch import cli  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.scene import \
    Scene  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops import rng  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops.cuda import (  # noqa: E402
    accel_kernel as ak, bounce_kernel as bk, build)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_phase: no CUDA device")
    t0 = time.perf_counter()
    print(f"build {build.build():.1f} s", flush=True)
    build.load_library()
    dev = torch.device(cs.DEVICE)
    _, only, counted = cs.launch_counters()

    def same_numbers(tag, kernel, got, want):
        torch.cuda.synchronize()
        g, w = got.cpu().numpy().ravel(), want.cpu().numpy().ravel()
        e_rel = abs(g.sum() - w.sum()) / w.sum()
        print(f"{tag}: energy {e_rel:.2e}, L1 {cs.l1(g, w):.2e}", flush=True)
        cs.check(e_rel < cs.SAME_ENERGY and cs.l1(g, w) < cs.SAME_L1, tag)

    city = art.rooms.city_scene(2500, device=dev)
    p9 = art.TraceParams.make(city.source, city.listener,
                              city.listener_radius, 343.0, cs.CITY_GAIN,
                              device=dev)
    ctx = dict(torch=torch, art=art, bk=bk, ak=ak, rng=rng, cli=cli,
               dev=dev, counted=counted, only=only,
               same_numbers=same_numbers, Scene=Scene, card=card_line(),
               scene_9=city.scene, p_9=p9)
    launches, readings = cs.mesh_phase(ctx)
    print(f"launches {launches}; readings {readings}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
