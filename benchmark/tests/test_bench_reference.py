"""The plain reference against the port's plain paths at tiny sizes: the
scene generators and walls, the Philox draws, the trace and deposit of a
single scene and a batch of rooms, and a stream's output chunk."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from conftest import REPO

from benchmark.reference import audio, philox, physics, scenes

CPU = torch.device("cpu")
SHIPPED = json.loads((REPO / "benchmark" / "configs"
                      / "shipped_rooms.json").read_text())


def _port():
    import realisticaudioraytracing2d_tpu_torch as art
    return art


def _equal_walls(w, scene):
    n = w.a.shape[0]
    for f in ("a", "b", "normal", "absorption", "scattering", "transmission",
              "ior"):
        assert np.array_equal(getattr(w, f), getattr(scene, f)[:n].numpy()), f
    assert not scene.mask[n:].any()


def test_smoll_room_walls_equal_the_port():
    art = _port()
    _equal_walls(scenes.walls(scenes.boxes_from_config(SHIPPED["scene"])),
                 art.rooms.smoll_room(device=CPU).scene)


def test_rooms_draws_equal_the_port():
    art = _port()
    boxes, src, lis = scenes.rooms(5, 11)
    stacked, src_p, lis_p = art.rooms.random_rooms(5, seed=11, device=CPU)
    assert np.array_equal(src, src_p) and np.array_equal(lis, lis_p)
    for i in range(5):
        _equal_walls(scenes.walls(boxes[i]), stacked.row(i))


def test_philox_and_seed_mixing_equal_the_port():
    from realisticaudioraytracing2d_tpu_torch.ops import rng
    seed = 2 ** 40 + 12345
    emit, u = rng.philox_uniforms(seed, 2, 3, 50, CPU, entry=7,
                                  first_frame=4)
    ray = torch.arange(50).repeat(2)
    frame = torch.arange(4, 6).repeat_interleave(50)
    ent = torch.full_like(ray, 7)
    assert torch.equal(philox.emission_jitter(seed, ray, frame, ent, 3),
                       emit.reshape(-1))
    for b in range(3):
        assert torch.equal(philox.ray_uniforms(seed, ray, frame, ent, b),
                           u[:, b].reshape(-1, 3))
    assert philox.mix_seed(seed, 9) == rng.mix_seed(seed, 9)


@pytest.mark.parametrize("frames", [1, 3])
def test_single_scene_trace_equals_the_port(frames):
    art = _port()
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel
    room = art.rooms.smoll_room(device=CPU)
    w = scenes.walls(scenes.boxes_from_config(SHIPPED["scene"]))
    pose = physics.Pose(torch.tensor([[-18.0, 9.0]]),
                        torch.tensor([[[0.0, -3.68], [5.0, 2.0]]]), 0.5,
                        343.0, 1.0)
    ir, work = physics.trace_ir(physics.tables([w], torch.float32, CPU),
                                pose, 77, n_rays=500, n_bounces=4,
                                n_frames=frames, sample_rate=8000,
                                ir_length=12000)
    params = art.TraceParams.make([-18.0, 9.0], [[0.0, -3.68], [5.0, 2.0]],
                                  0.5, 343.0, 1.0, device=CPU)
    port = bounce_kernel.trace_frames_ir_mega_plain(
        room.scene, params, 77, frames, n_rays=500, max_bounces=4,
        sample_rate=8000, ir_length=12000)
    assert ir.shape == (1, 2, 12000, 1) and work.alive > 0 < work.heard
    gap = (ir[0] - port.double()).abs().sum() / port.double().abs().sum()
    assert gap < 1e-6
    # a ray that died is never counted again
    assert work.alive <= 500 * 4 * frames


def test_room_batch_trace_equals_the_port():
    art = _port()
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel
    boxes, src, lis = scenes.rooms(4, 5)
    stacked, _, _ = art.rooms.random_rooms(4, seed=5, device=CPU)
    rows = [1, 3]
    tab = physics.tables([scenes.walls(boxes[r]) for r in rows],
                         torch.float32, CPU)
    pose = physics.Pose(torch.as_tensor(src[rows]),
                        torch.as_tensor(lis[rows])[:, None], 0.5, 343.0, 1.0)
    ir, _ = physics.trace_ir(tab, pose, 99, n_rays=300, n_bounces=3,
                             n_frames=2, sample_rate=8000, ir_length=6000,
                             entry_ids=rows)
    port = bounce_kernel.trace_rooms_ir_mega_plain(
        stacked, src, lis, 99, 2, n_rays=300, max_bounces=3,
        sample_rate=8000, ir_length=6000)
    for k, r in enumerate(rows):
        p = port[r].double()
        assert float((ir[k] - p).abs().sum() / p.abs().sum()) < 1e-6


def test_stream_output_equals_the_port_stream():
    """The reference's ring of crossfaded chunks against the port's
    ``Streamer`` on fixed IRs (host uniforms of the port's own plain
    trace would only repeat the trace test above)."""
    from realisticaudioraytracing2d_tpu_torch import streaming
    n, t = 48, 200
    gen = torch.Generator().manual_seed(3)
    irs = [torch.rand(1, t, 1, generator=gen) * 1e-2 for _ in range(9)]
    dry = torch.rand(9 * n, generator=gen) - 0.5
    state = streaming.init_stream(t, n, device=CPU)
    outs = []
    for k in range(9):
        wet = streaming._crossfaded_wet(
            dry[k * n:(k + 1) * n], irs[k - 1] if k else irs[0], irs[k])
        outs.append(state.ring.push(wet, state.ring.read_head).drain(n))
    for j in (0, 3, 8):
        ref = audio.output_chunk(j, n, t, lambda k: dry[k * n:(k + 1) * n]
                                 .double(), lambda k: irs[k][..., 0].double())
        assert float((outs[j].double() - ref).abs().max()
                     / ref.abs().max()) < 1e-5
