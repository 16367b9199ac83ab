"""PyTorch port on the card: the CUDA bounce kernel (K3 and K4 modes of
``csrc/bounce_kernel.cu``) against its plain PyTorch version, its
determinism, its launch counts, and the wrappers' refusals.

Every test here needs an NVIDIA GPU and nvcc and skips elsewhere. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: the kernel and the plain version see the same uniforms and
compute every hit in the same IEEE order; only the binning sums differ
(u64 fixed point vs float ``index_add_``), which reads below 1e-7 on an
H100. Energy and per-bin L1 within 1e-5 (a few hits of average energy
moving bin would exceed it), the first nonzero bin equal."""

import numpy as np
import pytest
import torch
from torch_parity import cuda, cuda_device, to_numpy  # noqa: F401

import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.ops.trace import (TraceParams,
                                                            emission_angle)

KW = dict(sample_rate=48000, ir_length=72000)


def _setup(device, n_bands=1, room_fn=rooms.smoll_room, gain=1.0):
    room = room_fn(n_bands=n_bands, device=device)
    return room.scene, TraceParams.make(room.source, room.listener,
                                        input_gain=gain, device=device)


def _assert_close_irs(got, want):
    g, w = to_numpy(got).ravel(), to_numpy(want).ravel()
    assert np.isfinite(g).all() and w.sum() > 0
    assert abs(g.sum() - w.sum()) / w.sum() < 1e-5
    assert np.abs(g - w).sum() / np.abs(w).sum() < 1e-5
    assert np.flatnonzero(g)[0] == np.flatnonzero(w)[0]


@cuda
@pytest.mark.parametrize("room_fn,gain", [(rooms.smoll_room, 1.0),
                                          (rooms.big_room, 100.0)])
def test_whole_kernel_matches_plain(cuda_device, room_fn, gain):
    scene, params = _setup(cuda_device, room_fn=room_fn, gain=gain)
    emit, u = rng.philox_uniforms(3, 4, 5, 15000, cuda_device)
    before = bk.trace_frames_ir_whole.launches
    got = bk.trace_frames_ir_whole(scene, params, emit, u, **KW)
    want = bk.trace_frames_ir_plain(scene, params, emit, u, **KW)
    torch.cuda.synchronize()
    assert bk.trace_frames_ir_whole.launches == before + 1
    assert tuple(got.shape) == (1, 72000, 1) and got.dtype == torch.float32
    _assert_close_irs(got, want)


@cuda
@pytest.mark.parametrize("n_rays", [15000, 131072])
def test_plain_emission_angles_are_the_cpu_ones(cuda_device, n_rays):
    """The plain path's emission angle ``(i + u) / R * 2pi`` rounds as IEEE
    division on the card, as on the CPU and in the kernel, also when R is
    not a power of two: the same bits on both devices."""
    jitter = torch.rand(n_rays, generator=torch.Generator().manual_seed(0))
    on_card = emission_angle(n_rays, jitter.to(cuda_device)).cpu()
    assert torch.equal(on_card, emission_angle(n_rays, jitter))


@cuda
def test_mega_kernel_is_deterministic_and_draws_the_philox_stream(
        cuda_device):
    scene, params = _setup(cuda_device)
    kw = dict(n_rays=15000, max_bounces=5, **KW)
    before = bk.trace_frames_ir_mega.launches
    a = bk.trace_frames_ir_mega(scene, params, 42, 2, **kw)
    b = bk.trace_frames_ir_mega(scene, params, 42, 2, **kw)
    c = bk.trace_frames_ir_mega(scene, params, 43, 2, **kw)
    emit, u = rng.philox_uniforms(42, 2, 5, 15000, cuda_device)
    plain = bk.trace_frames_ir_plain(scene, params, emit, u, **KW)
    torch.cuda.synchronize()
    assert bk.trace_frames_ir_mega.launches == before + 3
    assert torch.equal(a, b) and not torch.equal(a, c)
    _assert_close_irs(a, plain)


@cuda
def test_two_listeners_share_one_launch(cuda_device):
    room = rooms.smoll_room(device=cuda_device)
    ears = np.stack([room.listener, room.listener + [0.5, 0.0]])
    params = TraceParams.make(room.source, ears, device=cuda_device)
    emit, u = rng.philox_uniforms(8, 2, 5, 15000, cuda_device)
    got = bk.trace_frames_ir_whole(room.scene, params, emit, u, **KW)
    want = bk.trace_frames_ir_plain(room.scene, params, emit, u, **KW)
    for ear in range(2):
        _assert_close_irs(got[ear], want[ear])
    assert not torch.equal(got[0], got[1])


@cuda
def test_engine_routes_cuda_scenes_to_the_kernel(cuda_device):
    scene, params = _setup(cuda_device)
    cfg = art.smoll_room_config()
    eng = art.Engine(scene, cfg)
    k3, k4 = bk.trace_frames_ir_whole.launches, bk.trace_frames_ir_mega.launches
    seeded = eng.trace_frames(params, seed=4, n_frames=2)
    uniforms = rng.philox_uniforms(4, 2, 5, 15000, cuda_device)
    given = eng.trace_frames(params, n_frames=2, uniforms=uniforms)
    plain = eng.trace_frames(params, seed=4, n_frames=2, backend="plain")
    torch.cuda.synchronize()
    assert bk.trace_frames_ir_mega.launches == k4 + 1
    assert bk.trace_frames_ir_whole.launches == k3 + 1
    # the seed names the same rays in both kernel modes: the sums agree to
    # the last bit (same fixed-point atomics, same numbers)
    assert torch.equal(seeded.sum, given.sum)
    _assert_close_irs(seeded.sum, plain.sum)


@cuda
def test_stream_on_the_card_runs_through_the_kernel(cuda_device):
    scene, params = _setup(cuda_device)
    cfg = art.smoll_room_config()
    dry = torch.zeros(9600, device=cuda_device)
    dry[100] = 1.0
    before = bk.trace_frames_ir_mega.launches
    out = art.Streamer(scene, cfg, seed=1).stream_clip(
        dry, lambda i: params, total_chunks=4)
    torch.cuda.synchronize()
    assert bk.trace_frames_ir_mega.launches == before + 4
    assert tuple(out.shape) == (1, 4 * 4800)
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) > 0


@cuda
def test_wrappers_raise_on_what_the_kernel_does_not_take(cuda_device):
    scene, params = _setup(cuda_device, n_bands=4)
    with pytest.raises(NotImplementedError, match="K=1"):
        bk.trace_frames_ir_mega(scene, params, 0, 1, n_rays=256,
                                max_bounces=2, sample_rate=48000,
                                ir_length=4800)
    scene, params = _setup(cuda_device)
    emit, u = rng.philox_uniforms(0, 1, 2, 256, cuda_device)
    directive = params._replace(
        directivity=torch.ones(3, device=cuda_device))
    with pytest.raises(NotImplementedError, match="directive"):
        bk.trace_frames_ir_whole(scene, directive, emit, u,
                                 sample_rate=48000, ir_length=4800)
    with pytest.raises(ValueError, match="emit"):
        bk.trace_frames_ir_whole(scene, params, emit.cpu(), u,
                                 sample_rate=48000, ir_length=4800)
    with pytest.raises(ValueError, match="scene"):
        bk.trace_frames_ir_whole(scene, params.to("cpu"), emit, u,
                                 sample_rate=48000, ir_length=4800)
