#!/usr/bin/env python
"""Steer a RUNNING stream from outside, on the PyTorch port: poses,
geometry, and the Space/R verbs through the JSON-lines feed
(posefeed.py).

The reference is steered live: drag the source or a wall in the Unity
editor while audio plays and the next FixedUpdate re-reads transforms
and re-flattens colliders (``RayTraceManager.cs:50-61,67,246-250``);
Space stops the stream, R resets the impulse (``:55-61``). This demo
drives the port's equivalent channel end to end (each chunk's IR from
the bounce kernel K4 on the card) and ASSERTS the steering is real:

1. writes a feed that (a) moves the source at chunk 1, (b) drags the
   slant wall ("Wall (4)") at chunk 2, (c) resets the IR at chunk 4,
   (d) stops at chunk 6;
2. streams with the feed, and again with the equivalent explicit
   ``params_fn``/``scene_fn``/``control_fn``: byte-identical;
3. checks the stop ended the run after exactly the reverb-tail flush,
   and that each steering event audibly changed the stream vs. the
   unfed baseline.

Run: python examples/torch/live_steering.py [--device cpu]
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import realisticaudioraytracing2d_tpu_torch as art  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.posefeed import \
    PoseFeed  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.streaming import \
    Streamer  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.utils.audio_io import \
    noise_burst  # noqa: E402


def setup(dev, rays: int, sr: int):
    """SmollRoom at ``rays`` and ``sr`` with a 0.2 s reverb, the base
    poses, the dry noise, the steering feed (a source move, a wall drag,
    R and Space) and its explicit trajectory: ``params_fn`` and
    ``scene_fn`` (``control_fn`` is :func:`explicit_control`)."""
    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config(ray_count=rays)
    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, sample_rate=sr,
                                       reverb_duration=0.2))
    eng = art.Engine(room.scene, cfg)
    src = np.asarray(room.source, np.float32)
    base = eng.params(src, room.listener)
    lines = [
        {"chunk": 1, "source": [float(src[0] + 1.5), float(src[1])]},
        {"chunk": 2, "obstacle": "Wall (4)",
         "position": [-9.0, 5.0], "angle": 0.4},
        {"chunk": 4, "command": "reset_ir"},
        {"chunk": 6, "command": "stop"},
    ]
    # the explicit equivalent of the feed
    moved_scene = room.builder.move_collider(room.scene, "Wall (4)",
                                             position=(-9.0, 5.0),
                                             angle=0.4)
    moved_params = base._replace(source=torch.as_tensor(
        src + np.float32([1.5, 0.0]), device=dev))
    return dict(room=room, cfg=cfg, base=base, lines=lines,
                dry=noise_burst(1.0, sr, seed=1),
                params_fn=lambda i: moved_params if i >= 1 else base,
                scene_fn=lambda i: moved_scene if i >= 2 else room.scene)


def explicit_control(i):
    """The feed's verbs as an explicit ``control_fn``."""
    if i == 4:
        return {"reset_ir": True}
    if i == 6:
        return {"stop": True}
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain versions)")
    ap.add_argument("--rays", type=int, default=512)
    ap.add_argument("--sr", type=int, default=8000)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    su = setup(dev, args.rays, args.sr)
    room, cfg, base, lines = (su[k] for k in ("room", "cfg", "base",
                                              "lines"))
    n = cfg.audio.chunk_samples
    dry = torch.as_tensor(su["dry"], device=dev)

    feed_path = "steering.jsonl"
    with open(feed_path, "w") as f:
        f.writelines(json.dumps(line) + "\n" for line in lines)
    print(f"feed: {len(lines)} lines -> {feed_path}")

    def stream(params_fn, scene_fn=None, control_fn=None):
        return (Streamer(room.scene, cfg, seed=0)
                .stream_clip(dry, params_fn, scene_fn=scene_fn, loop=False,
                             control_fn=control_fn)).cpu().numpy()

    feed = PoseFeed.open(feed_path).bind_scene(room.builder)
    try:
        fed = stream(lambda i: feed.params(base, i),
                     scene_fn=lambda i: feed.scene(room.scene, i),
                     control_fn=feed.control)
    finally:
        feed.close()

    want = stream(su["params_fn"], scene_fn=su["scene_fn"],
                  control_fn=explicit_control)
    assert np.array_equal(fed, want), \
        "fed stream != explicit params/scene/control stream"
    print("fed stream == explicit trajectory stream (byte-identical)")

    tail_chunks = (cfg.audio.ir_length + n - 1) // n
    assert fed.shape[-1] == (6 + tail_chunks) * n, fed.shape
    print(f"stop at chunk 6 flushed {tail_chunks} tail chunks: "
          f"{fed.shape[-1]} samples "
          f"({fed.shape[-1] / args.sr:.1f} s of a 1.0 s clip + tail)")

    plain = stream(lambda i: base)
    m = min(fed.shape[-1], plain.shape[-1])
    first_diff = int(np.argmax(np.abs(fed[0, :m] - plain[0, :m]) > 0))
    assert n <= first_diff < 2 * n, first_diff
    print(f"steering is audible from chunk 1 on (first differing "
          f"sample {first_diff}); RMS delta "
          f"{np.sqrt(np.mean((fed[0, :m] - plain[0, :m])**2)):.2e}")
    print("live steering OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
