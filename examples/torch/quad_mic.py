"""Microphone-array demo on the PyTorch port: one trace pass, N x N
listeners.

Traces the SmollRoom with a square microphone array around the shipped
listener position (the listeners of a launch share every wall sweep
inside the bounce kernel K4; past what one block's shared memory holds
the wrapper adds bit-exact listener blocks), then bakes an N*N-channel
WAV whose inter-channel delays encode the array geometry.

Run:  python examples/torch/quad_mic.py [--device cpu] [--grid 3]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import realisticaudioraytracing2d_tpu_torch as art  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.utils import audio_io  # noqa: E402


def setup(dev, g: int):
    """SmollRoom at 4,096 rays with ``g x g`` microphones at 1 m spacing
    centred on the shipped listener, and the dry clicks."""
    room = art.rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config(ray_count=4096)
    center = np.asarray(room.listener, np.float32)
    axis_off = (np.arange(g, dtype=np.float32) - (g - 1) / 2.0)
    offsets = np.stack(np.meshgrid(axis_off, axis_off),
                       axis=-1).reshape(-1, 2)
    mics = center[None, :] + offsets
    eng = art.Engine(room.scene, cfg, n_listeners=g * g)
    return dict(room=room, cfg=cfg, mics=mics, eng=eng,
                params=eng.params(room.source, mics),
                dry=audio_io.click_clip(1.0, cfg.audio.sample_rate,
                                        click_times=(0.1, 0.5)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    parser.add_argument("--out", default="quad_out")
    parser.add_argument("--grid", type=int, default=2,
                        help="array side length (grid x grid mics)")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    g = args.grid
    n_mics = g * g
    su = setup(dev, g)
    room, cfg, mics, eng, params = (su[k] for k in (
        "room", "cfg", "mics", "eng", "params"))

    t0 = time.perf_counter()
    state = eng.trace_frames(params, seed=0, n_frames=8)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"traced {n_mics}-mic array, 8 frames x 4096 rays in "
          f"{time.perf_counter() - t0:.2f}s")

    ir = state.normalized().cpu().numpy()       # [n_mics, T, 1]
    sr = cfg.audio.sample_rate
    first = []
    for m in range(n_mics):
        nz = np.nonzero(ir[m, :, 0])[0]
        first.append(int(nz[0]) if nz.size else -1)  # -1: outside the room
    print("first arrival per mic (ms):",
          [round(b / sr * 1e3, 2) if b >= 0 else None for b in first])
    # among mics that heard anything, closer-to-source arrives first,
    # checked pairwise with a distance margin: arrival bins quantize to
    # sample resolution and first arrivals are multi-bounce paths, so
    # near-equidistant mics may tie or swap by a bin
    heard = [m for m in range(n_mics) if first[m] >= 0]
    d = np.linalg.norm(mics - np.asarray(room.source)[None, :], axis=1)
    margin = 2.0 * 343.0 / sr   # two sample bins of path length
    for i in heard:
        for j in heard:
            if d[i] + margin < d[j]:
                assert first[i] <= first[j] + 2, (i, j, d[i], d[j],
                                                  first[i], first[j])

    wet = eng.bake(torch.as_tensor(su["dry"], device=dev),
                   state).cpu().numpy()          # [mics, N+T]
    path = os.path.join(args.out, f"array_{g}x{g}.wav")
    audio_io.write_wav(path, wet.T, sr)
    print(f"wrote {n_mics}-channel {path} ({wet.shape[1]} samples)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
