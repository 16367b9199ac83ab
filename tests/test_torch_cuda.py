"""PyTorch port on the card: the CUDA bounce kernel (K3, K4 and the
rooms-batched K9 modes of ``csrc/bounce_kernel.cu``) and the cluster
kernels of the large-scene path (K7, K8 of ``csrc/accel_kernel.cu``)
against their plain PyTorch versions, their determinism, their launch
counts, the engine's routing by wall and band count, the sweep and the
mixdown on the card, and the wrappers' refusals; then the hit-record
path: the wall sweeps (K1, K2 of ``csrc/trace_kernel.cu``) and the
one-frame kernels (K5's hit rows, ``frame_rows_kernel`` of
``csrc/bounce_kernel.cu``, in either lane group; K6, K3/K4's launch at one
frame) against their plain versions, K6 == K3 == K4 bit for bit, K6's
refusals, the routing of a request for hits by listener, band and wall
count, and the float scatters' determinism;
then the diffraction kernels (``csrc/diffraction_kernel.cu``) against the
card's chain bit for bit: round the barrier walk's circle, on barrier
scenes, with host numbers, in place in ``_augment_ir``, and four launches
(a K2 sweep an order) in a profiled barrier chunk's
``art.addenda.diffraction``;
then the banded and many-listener paths: K3/K4/K9 at 8, 32 and 512 bands
and K7 at 32 and 40 against their plain versions, equal bands == one band
bit for bit, K4 == K7 on a sorted banded city, listener blocks == the
whole launch bit for bit (K3, K4, K9, K7, K8), the sweep and mixdown of
scenes past 5,280 walls against single K8/K7 calls, a banded stream
with air absorption and an octave-split SampleScene stream with order-2
diffraction and air against their plain twins; then the spatial captures and
the binaural stream; then the per-arrival Doppler stream (mono and
binaural) against its plain twins on the card and on the CPU, and the
shared-rate Doppler feed on the card against the CPU's; then the live
player on the card against the card's stream of the same seed (mono,
binaural, per-arrival; one K4 a chunk), a pose feed moving a wall and
the source, and a realtime session from empty build directories (the
player builds the kernels and the native library before its threads
start) with no underrun; then the differentiable path (``diff.py``: the
plain trace under autograd on the card) against central differences and
the CPU, its fits' bit-stable reruns, the transmission surrogate through
K1/K2 against the plain surrogate trace, the blur in full float32, and
JAX's transmission and two-source recovery tests, too long for the CPU;
then K4's ``frame_offset`` and ``entry`` against K3 on the same Philox
numbers (bit for bit) and the device-mesh paths on a virtual mesh of the
card (the sharded sweep bit for bit, frames within the fixed point, rays
shard by shard, the mixdown within the float sum); then the cluster
kernels' ``frame_offset``: K8 and K7 (K = 1) == K4 at the same offset
on a sorted city bit for bit, K8 and the 8-band K7 at an offset against
their plain twin, K7's passes at an offset == one pass, and frame shards
of the 10,008-wall city (K8) within the fixed point of the unsharded
call; last, the port's spans in a traced stream chunk, host events with
no device-side copy.

Every test here needs an NVIDIA GPU and nvcc and skips elsewhere. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: the kernel and the plain version see the same uniforms and
compute every hit in the same IEEE order; only the binning sums differ
(u64 fixed point vs float ``index_add_``), which reads below 1e-7 on an
H100. Energy and per-bin L1 within 1e-5 (a few hits of average energy
moving bin would exceed it), the first nonzero bin equal. The cluster
kernels only skip work: early_out on or off, and K4, K7 (K = 1) and K8 on
one sorted scene, give the same bits. K1, K2 and K5 hand out the plain
version's own numbers (distances, indices, hit records): equal bit for
bit, since both make the same IEEE operations and a minimum does not
depend on its order."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch_parity import (cuda, cuda_device, profiler_lead_in,  # noqa: F401
                          to_numpy)

import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.models.scene import Scene
from realisticaudioraytracing2d_tpu_torch import engine
from realisticaudioraytracing2d_tpu_torch.ops import accel
from realisticaudioraytracing2d_tpu_torch.ops import ir as irm
from realisticaudioraytracing2d_tpu_torch.ops import legacy, rng
from realisticaudioraytracing2d_tpu_torch.ops import trace as tt
from realisticaudioraytracing2d_tpu_torch.ops.cuda import accel_kernel as ak
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.ops.cuda import trace_kernel as tk
from realisticaudioraytracing2d_tpu_torch.ops.trace import (TraceParams,
                                                            emission_angle)
from realisticaudioraytracing2d_tpu_torch.parallel.multisource import \
    trace_sources_mixdown
from realisticaudioraytracing2d_tpu_torch.parallel.sweep import sweep_rooms

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
    # bands and listeners run (the banded and blocked tests below); what
    # is still refused: patterns past a block's shared memory, patterns of
    # the wrong shape, tensors on another device
    scene, params = _setup(cuda_device, n_bands=4)
    ir = bk.trace_frames_ir_mega(scene, params, 0, 1, n_rays=256,
                                 max_bounces=2, sample_rate=48000,
                                 ir_length=4800)
    assert tuple(ir.shape) == (1, 4800, 4)
    scene, params = _setup(cuda_device)
    huge = params._replace(directivity=torch.ones(201, device=cuda_device))
    with pytest.raises(NotImplementedError, match="shared memory"):
        bk.trace_frames_ir_mega(scene.pad_to(bk.MAX_WALLS), huge, 0, 1,
                                n_rays=256, max_bounces=2, sample_rate=48000,
                                ir_length=4800)
    emit, u = rng.philox_uniforms(0, 1, 2, 256, cuda_device)
    # patterns run in the kernel (test_directive_kernels_match_plain); a
    # pattern of the wrong shape is refused
    directive = params._replace(
        directivity=torch.ones(4, device=cuda_device))
    with pytest.raises(ValueError, match="directivity"):
        bk.trace_frames_ir_whole(scene, directive, emit, u,
                                 sample_rate=48000, ir_length=4800)
    with pytest.raises(ValueError, match="emit"):
        bk.trace_frames_ir_whole(scene, params, emit.cpu(), u,
                                 sample_rate=48000, ir_length=4800)
    with pytest.raises(ValueError, match="scene"):
        bk.trace_frames_ir_whole(scene, params.to("cpu"), emit, u,
                                 sample_rate=48000, ir_length=4800)


def _mixdown_batch(device, n_src=8):
    """n_src sources in SmollRoom, two ears, one shared scene (stride 0)."""
    room = rooms.smoll_room(device=device)
    g = np.random.default_rng(11)
    src = np.stack([g.uniform(-15, 15, n_src), g.uniform(-3, 8, n_src)],
                   -1).astype(np.float32)
    ears = np.array([[-0.2, -3.68], [0.2, -3.68]], np.float32)
    shared = Scene(*(x[None] for x in room.scene))
    return shared, src, np.repeat(ears[None], n_src, 0), room.scene


@cuda
@pytest.mark.parametrize("layout", ["stacked", "shared"])
def test_rooms_kernel_matches_plain(cuda_device, layout):
    if layout == "stacked":
        scenes, src, lis = rooms.random_rooms(6, seed=3, device=cuda_device)
        gains = 1.0
    else:
        scenes, src, lis, _ = _mixdown_batch(cuda_device)
        gains = torch.linspace(0.5, 2.0, 8, device=cuda_device)
    kw = dict(n_rays=15000, max_bounces=5, input_gain=gains,
              entry_offset=100, **KW)
    before = bk.trace_rooms_ir_mega.launches
    got = bk.trace_rooms_ir_mega(scenes, src, lis, 17, 2, **kw)
    want = bk.trace_rooms_ir_mega_plain(scenes, src, lis, 17, 2, **kw)
    torch.cuda.synchronize()
    assert bk.trace_rooms_ir_mega.launches == before + 1
    assert got.shape == want.shape and got.shape[2:] == (72000, 1)
    for e in range(got.shape[0]):
        if float(want[e].sum()) > 0:
            _assert_close_irs(got[e], want[e])


@cuda
def test_rooms_kernel_of_one_entry_is_the_single_scene_kernel(cuda_device):
    scene, params = _setup(cuda_device)
    kw = dict(n_rays=15000, max_bounces=5, **KW)
    k4 = bk.trace_frames_ir_mega(scene, params, 42, 3, **kw)
    k9 = bk.trace_rooms_ir_mega(Scene.stack([scene]), params.source[None],
                                params.listeners[None], 42, 3, **kw)
    torch.cuda.synchronize()
    assert tuple(k9.shape) == (1, 1, 72000, 1)
    assert torch.equal(k9[0], k4)


@cuda
def test_rooms_kernel_is_deterministic(cuda_device):
    scenes, src, lis = rooms.random_rooms(16, seed=1, device=cuda_device)
    kw = dict(n_rays=15000, max_bounces=5, **KW)
    a = bk.trace_rooms_ir_mega(scenes, src, lis, 5, 2, **kw)
    b = bk.trace_rooms_ir_mega(scenes, src, lis, 5, 2, **kw)
    c = bk.trace_rooms_ir_mega(scenes, src, lis, 6, 2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a row of the batch draws the rays of its global room id
    row = bk.trace_rooms_ir_mega(scenes.row(slice(7, 8)), src[7:8],
                                 lis[7:8], 5, 2, entry_offset=7, **kw)
    assert torch.equal(row[0], a[7])


@cuda
def test_sweep_on_the_card_equals_the_cpu_sweep(cuda_device):
    kw = dict(n_rays=15000, max_bounces=5, n_frames=2, **KW)
    scenes, src, lis = rooms.random_rooms(4, seed=8, device=cuda_device)
    before = bk.trace_rooms_ir_mega.launches
    card = sweep_rooms(scenes, src, lis, 3, **kw)
    torch.cuda.synchronize()
    assert bk.trace_rooms_ir_mega.launches == before + 1
    cpu = sweep_rooms(scenes.to("cpu"), src, lis, 3, **kw)
    assert card.device.type == "cuda" and cpu.device.type == "cpu"
    # the same rays, but the CPU's sin/cos may differ from the card's by an
    # ulp and move a hit that sits on a bin edge: the limits of the JAX
    # parity tests (energy 1e-4, per-bin L1 1%)
    g, w = to_numpy(card), to_numpy(cpu)
    assert np.isfinite(g).all() and w.sum() > 0
    assert abs(g.sum() - w.sum()) / w.sum() < 1e-4
    assert np.abs(g - w).sum() / np.abs(w).sum() < 1e-2


@cuda
def test_mixdown_on_the_card_runs_one_rooms_launch(cuda_device):
    _, src, _, scene = _mixdown_batch(cuda_device)
    ears = np.array([[-0.2, -3.68], [0.2, -3.68]], np.float32)
    params = TraceParams.make(src, ears, device=cuda_device)
    kw = dict(n_rays=15000, max_bounces=5, **KW)
    before = bk.trace_rooms_ir_mega.launches
    mix = trace_sources_mixdown(scene, params, 4, **kw)
    again = trace_sources_mixdown(scene, params, 4, **kw)
    plain = trace_sources_mixdown(scene, params, 4, backend="plain", **kw)
    torch.cuda.synchronize()
    assert bk.trace_rooms_ir_mega.launches == before + 2
    assert tuple(mix.shape) == (2, 72000, 1) and torch.equal(mix, again)
    _assert_close_irs(mix, plain)
    assert not torch.equal(mix[0], mix[1])


@cuda
def test_rooms_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    kw = dict(n_rays=256, max_bounces=2, sample_rate=48000, ir_length=4800)
    # bands and any listener count run; host uniforms are still refused
    scenes, src, lis = rooms.random_rooms(2, seed=0, n_bands=4,
                                          device=cuda_device)
    assert tuple(bk.trace_rooms_ir_mega(scenes, src, lis, 0, 1, **kw).shape
                 ) == (2, 1, 4800, 4)
    scenes, src, lis = rooms.random_rooms(2, seed=0, device=cuda_device)
    assert tuple(bk.trace_rooms_ir_mega(
        scenes, src, np.zeros((2, 17, 2), np.float32), 0, 1, **kw).shape
                 ) == (2, 17, 4800, 1)
    with pytest.raises(ValueError, match="backend='plain'"):
        bk.trace_rooms_ir_mega(scenes, src, lis, 0, 1,
                               uniforms=rng.philox_uniforms(
                                   0, 1, 2, 256, cuda_device), **kw)
    with pytest.raises(ValueError, match="backend='plain'"):
        sweep_rooms(scenes, src, lis, 0,
                    uniforms=rng.philox_uniforms(0, 1, 2, 256, cuda_device),
                    **kw)


# --- the large-scene path: K7 and K8 -----------------------------------------

ACCEL_KW = dict(n_rays=4096, max_bounces=5, sample_rate=16000,
                ir_length=24000)


def _city(device, n_boxes, n_bands=1):
    """A city on the card with the JAX bench's parameters (gain 100)."""
    room = rooms.city_scene(n_boxes, n_bands=n_bands, device=device)
    return room.scene, TraceParams.make(room.source, room.listener,
                                        room.listener_radius, 343.0, 100.0,
                                        device=device)


def _launch_counts():
    return (bk.trace_frames_ir_whole.launches,
            bk.trace_frames_ir_mega.launches,
            ak.trace_frames_ir_accel.launches,
            ak.trace_frames_ir_accel_sorted.launches)


@cuda
@pytest.mark.parametrize("kernel,n_bands", [("K7", 1), ("K7", 8),
                                            ("K7", 32), ("K7", 40),
                                            ("K8", 1)])
def test_accel_kernels_match_plain(cuda_device, kernel, n_bands):
    scene, params = _city(cuda_device, 300, n_bands)
    fn = (ak.trace_frames_ir_accel if kernel == "K7"
          else ak.trace_frames_ir_accel_sorted)
    got = fn(scene, params, 21, 2, **ACCEL_KW)
    want = ak.trace_frames_ir_accel_sorted_plain(scene, params, 21, 2,
                                                 **ACCEL_KW)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (1, 24000, n_bands)
    for k in range(n_bands):
        _assert_close_irs(got[..., k], want[..., k])


@cuda
def test_accel_early_out_is_lossless(cuda_device):
    scene, params = _city(cuda_device, 1200)
    banded, bparams = _city(cuda_device, 1200, 8)
    for fn, sc, p in ((ak.trace_frames_ir_accel, scene, params),
                      (ak.trace_frames_ir_accel_sorted, scene, params),
                      (ak.trace_frames_ir_accel, banded, bparams)):
        work = [torch.zeros(3, dtype=torch.int64, device=cuda_device)
                for _ in range(2)]
        on = fn(sc, p, 3, 2, work_counts=work[0], **ACCEL_KW)
        off = fn(sc, p, 3, 2, early_out=False, work_counts=work[1],
                 **ACCEL_KW)
        torch.cuda.synchronize()
        assert float(on.sum()) > 0 and torch.equal(on, off)
        (tests_on, sweeps_on, slabs_on), (tests_off, sweeps_off, slabs_off) \
            = (w.tolist() for w in work)
        assert sweeps_on == sweeps_off and slabs_on > 0 and slabs_off == 0
        assert tests_on < tests_off / 4


@cuda
def test_k4_k7_k8_are_bit_identical_on_a_sorted_city(cuda_device):
    scene, params = _city(cuda_device, 1200)
    sorted_scene = ak.prepare(scene).scene
    assert scene.n_walls == 4808 and sorted_scene.n_walls <= bk.MAX_WALLS
    k4 = bk.trace_frames_ir_mega(sorted_scene, params, 8, 3, **ACCEL_KW)
    k7 = ak.trace_frames_ir_accel(scene, params, 8, 3, **ACCEL_KW)
    k8 = ak.trace_frames_ir_accel_sorted(scene, params, 8, 3, **ACCEL_KW)
    torch.cuda.synchronize()
    assert float(k4.sum()) > 0
    assert torch.equal(k7, k4) and torch.equal(k8, k4)


@cuda
def test_routing_by_wall_and_band_count(cuda_device):
    def run(scene, params, n_bands=1, backend="auto"):
        before = _launch_counts()
        st = art.trace_accumulate(
            scene, params, art.IRState.zeros(24000, 1, n_bands,
                                             device=cuda_device),
            n_rays=4096, max_bounces=5, sample_rate=16000, n_frames=2,
            seed=1, backend=backend)
        torch.cuda.synchronize()
        assert float(st.sum.sum()) > 0
        return tuple(a - b for a, b in zip(_launch_counts(), before))

    small, p_small = _setup(cuda_device, gain=100.0)
    big, p_big = _city(cuda_device, 1500)          # 6,004 walls
    banded, p_banded = _city(cuda_device, 1500, 4)
    assert big.n_walls > bk.MAX_WALLS
    assert run(small, p_small) == (0, 1, 0, 0)               # K4
    assert run(big, p_big) == (0, 0, 0, 5)                   # K8, B launches
    assert run(banded, p_banded, 4) == (0, 0, 5, 0)          # K7, B launches
    assert run(small, p_small, backend="accel") == (0, 0, 0, 5)
    small_banded, p_sb = _city(cuda_device, 300, 4)
    assert run(small_banded, p_sb, 4, backend="accel") == (0, 0, 5, 0)
    assert run(small_banded, p_sb, 4) == (0, 1, 0, 0)        # K4, banded
    with pytest.raises(ValueError, match="K7/K8"):
        bk.trace_frames_ir_mega(big, p_big, 0, 1, **ACCEL_KW)
    with pytest.raises(ValueError, match="uniforms"):
        art.trace_accumulate(
            big, p_big, art.IRState.zeros(24000, device=cuda_device),
            n_rays=256, max_bounces=2, sample_rate=16000,
            uniforms=rng.philox_uniforms(0, 1, 2, 256, cuda_device))


@cuda
def test_k8_refuses_buffers_it_cannot_ping_pong(cuda_device):
    # a launch reads one state buffer and writes another: the library
    # refuses, before any launch, an output that is its input and a later
    # bounce without a permutation
    prep = ak.prepare(_city(cuda_device, 1500)[0])
    fn = ak._fn("art_accel_bounce", ak._BOUNCE_ARGTYPES)
    n = 1000
    state = torch.empty((2, 8, n), device=cuda_device)
    istate = torch.empty((2, 2, n), dtype=torch.int32, device=cuda_device)
    keys = torch.empty(n, dtype=torch.int64, device=cuda_device)
    perm = torch.arange(n, device=cuda_device)

    energy = torch.empty((2, n * 8 + 4), device=cuda_device)

    def launch(bounce, perm_ptr, src, dst, n_bands=1, e_src=0, e_dst=1,
               shift=0, frame_offset=0, n_rays=n):
        en = (None, None) if n_bands == 1 else (
            energy[e_src].data_ptr() + shift, energy[e_dst].data_ptr())
        return fn(prep.walls.data_ptr(), prep.geo.data_ptr(),
                  prep.walls.shape[1], n_bands, prep.aabb.data_ptr(),
                  prep.saabb.data_ptr(), prep.n_clusters, prep.group,
                  prep.cluster_size, None, 1, None, 0, None, 0, None,
                  prep.bounds.data_ptr(),
                  16000.0, 0, 0, 0, frame_offset, n_rays, 0, n, 2, bounce,
                  100, None, perm_ptr,
                  state[src].data_ptr(), istate[src].data_ptr(),
                  state[dst].data_ptr(), istate[dst].data_ptr(), *en,
                  keys.data_ptr(), None, 1, None, None)

    assert launch(1, perm.data_ptr(), 0, 0) == 1    # cudaErrorInvalidValue
    assert launch(1, None, 0, 1) == 1
    # the frame word: the last frame of a launch must fit 32 bits (2
    # frames of 500 rays from 2^32 - 1 would wrap); nothing is launched
    assert launch(0, None, 0, 1, frame_offset=(1 << 32) - 1,
                  n_rays=n // 2) == 1
    # K > 1: the energies ping-pong between two buffers as well, and the
    # register bucket's rows take 16-byte loads
    assert launch(1, perm.data_ptr(), 0, 1, 8, 0, 0) == 1
    assert launch(1, perm.data_ptr(), 0, 1, 8, shift=4) == 1


@cuda
@pytest.mark.parametrize("n_boxes,frames", [(1500, 2), (10000, 1)])
def test_k8_writes_the_morton_keys_of_its_rays(cuda_device, n_boxes, frames):
    """The keys the kernel leaves after each bounce equal
    ``morton_ray_keys`` of the state it leaves, bit for bit, dead rays
    included; the ids are a permutation of the rays at every bounce."""
    scene, params = _city(cuda_device, n_boxes)
    prep = ak.prepare(scene)
    left = []
    ak.trace_frames_ir_accel_sorted(scene, params, 5, frames, keys_out=left,
                                    **ACCEL_KW)
    torch.cuda.synchronize()
    assert len(left) == ACCEL_KW["max_bounces"]
    n = frames * ACCEL_KW["n_rays"]
    for state, istate, keys in left:
        alive = istate[1] >= 0
        want = accel.morton_ray_keys(state[0], state[1], alive,
                                     prep.bounds[:2], prep.bounds[2:])
        assert torch.equal(keys, want)
        assert torch.equal(istate[0].sort().values,
                           torch.arange(n, dtype=torch.int32,
                                        device=cuda_device))
    dead = [int((i[1] < 0).sum()) for _, i, _ in left]
    assert dead == sorted(dead)


@cuda
def test_k8_call_launches_once_per_bounce_and_prepares_once(cuda_device):
    from torch.profiler import ProfilerActivity, profile
    scene, params = _city(cuda_device, 1500)
    builds = ak.prepare.builds
    before = ak.trace_frames_ir_accel_sorted.launches
    first = ak.trace_frames_ir_accel_sorted(scene, params, 3, 2, **ACCEL_KW)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = ak.trace_frames_ir_accel_sorted(scene, params, 3, 2,
                                                **ACCEL_KW)
        torch.cuda.synchronize()
    bounces = ACCEL_KW["max_bounces"]
    assert ak.prepare.builds == builds + 1
    assert ak.trace_frames_ir_accel_sorted.launches == before + 2 * bounces
    assert torch.equal(first, again)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("accel_bounce_kernel" in n for n in names) == bounces
    # between the launches only the sort of the keys runs: no gather, no
    # per-block order, no wall sort
    assert not any("index_select" in n.lower() or "gather" in n.lower()
                   for n in names)
    assert len(names) <= 30 * bounces


@cuda
def test_cuda_city_never_runs_the_plain_version(cuda_device, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the plain version ran on the card")

    for mod, name in ((bk, "trace_frames_ir_plain"),
                      (bk, "trace_frames_ir_mega_plain"),
                      (ak, "trace_frames_ir_accel_plain"),
                      (ak, "trace_frames_ir_accel_sorted_plain")):
        monkeypatch.setattr(mod, name, refuse)
    scene, params = _city(cuda_device, 1500)
    cfg = art.EngineConfig(sim=art.SimConfig(ray_count=4096, max_bounces=5,
                                             listener_radius=2.0,
                                             input_gain=100.0))
    before = ak.trace_frames_ir_accel_sorted.launches
    eng = art.Engine(scene, cfg)
    st = eng.trace_frames(params, seed=2, n_frames=2)
    dry = torch.zeros(9600, device=cuda_device)
    dry[100] = 1.0
    out = art.Streamer(scene, cfg, seed=1).stream_clip(
        dry, lambda i: params, total_chunks=3)
    torch.cuda.synchronize()
    assert ak.trace_frames_ir_accel_sorted.launches == before + 4 * 5
    assert float(st.sum.sum()) > 0 and st.frames == 2
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) > 0


# --- the hit-record path: K1, K2 (wall sweeps), K5, K6 (one frame) -----------

def _hit_counts():
    """Launches of K1 and K2 (both routes), K5 and K6."""
    return (tk.nearest_hit.launches + tk.nearest_hit.box_launches,
            tk.occlusion_min.launches + tk.occlusion_min.box_launches,
            bk.trace_fused_rows.launches, bk.trace_frame_ir_fused.launches)


def _route_counts():
    """Launches of K1 and K2 by route: brute force, then the box walk."""
    return (tk.nearest_hit.launches, tk.occlusion_min.launches,
            tk.nearest_hit.box_launches, tk.occlusion_min.box_launches)


def _two_ears(room, device, **kw):
    ears = np.stack([room.listener, room.listener + [1.5, 0.5]])
    return TraceParams.make(room.source, ears, device=device, **kw)


def _sweep_scene(which, device):
    """SmollRoom, Big Room, ``city_scene(n)``, or "tie": ``city_scene(62)``
    with 40 copies of wall 9 and of wall 100 appended, so that equal
    distances span clusters (the copies sort next to their original, the
    run longer than a cluster)."""
    if which == "smoll":
        return rooms.smoll_room(device=device).scene
    if which == "big":
        return rooms.big_room(device=device).scene
    if which == "tie":
        scene = rooms.city_scene(62, device=device).scene
        copies = torch.tensor([9] * 40 + [100] * 40, device=device)
        return Scene(*(torch.cat([x, x[copies]]) for x in scene))
    return rooms.city_scene(which, device=device).scene


def _sweep_rays(scene, n, device, seed):
    """``n`` rays from random points of the scene's box, in random
    directions; a third aimed at the midpoints and a sixth at the end
    points of walls 9 and 100 (the tie scene's copies, shared corners)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lo = scene.a.amin(0)
    span = scene.a.amax(0) - lo
    o = lo + span * torch.rand((n, 2), generator=gen, device=device)
    ang = 6.2831853 * torch.rand(n, generator=gen, device=device)
    d = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    k = [9, 100] if scene.n_walls > 100 else [0, 1]
    mids = 0.5 * (scene.a[k] + scene.b[k])
    ends = torch.cat([scene.a[k], scene.b[k]])
    targets = torch.cat([mids.repeat(n // 6, 1), ends.repeat(n // 24, 1)])
    aim = targets - o[:targets.shape[0]]
    d[:targets.shape[0]] = aim / aim.norm(dim=-1, keepdim=True)
    return o, d, gen


@cuda
@pytest.mark.parametrize("route", ["brute", "box"])
@pytest.mark.parametrize("which", ["smoll", "big", 62, 250, 2500, "tie"])
def test_wall_sweeps_equal_their_plain_versions(cuda_device, which, route):
    """K1 and K2 on both routes (the brute sweep over the packed table, the
    box walk over ``prepare``'s sorted tables), on random rays (a count
    that fills no whole block) and rays aimed at walls and corners,
    without and with ``alive`` / ``limit``, against their plain versions:
    distances, indices (the lowest of the scene's indices among equal
    distances) and minima equal bit for bit."""
    scene = _sweep_scene(which, cuda_device)
    packed = tk.pack_walls(scene)
    walls = tk.SweepWalls(packed,
                          ak.prepare(scene) if route == "box" else None)
    n = 5001
    o, d, gen = _sweep_rays(scene, n, cuda_device, 5)
    alive = torch.rand(n, generator=gen, device=cuda_device) > 0.25
    span = float((scene.a.amax(0) - scene.a.amin(0)).norm())
    limit = span * torch.rand(n, generator=gen, device=cuda_device)
    o3, d3, a3, l3 = (x.reshape(n // 3, 3, *x.shape[1:])
                      for x in (o, d, alive, limit))
    before = _route_counts()
    t, idx = tk.nearest_hit(o, d, walls)
    t_m, idx_m = tk.nearest_hit(o, d, walls, alive)
    occ = tk.occlusion_min(o3, d3, walls)
    occ_ml = tk.occlusion_min(o3, d3, walls, a3, l3)
    occ_l = tk.occlusion_min(o3, d3, walls, limit=l3)
    torch.cuda.synchronize()
    step = (2, 3, 0, 0) if route == "brute" else (0, 0, 2, 3)
    assert tuple(a - b for a, b in zip(_route_counts(), before)) == step
    t_p, idx_p = tk.nearest_hit_plain(o, d, walls)
    assert idx.dtype == torch.int32 and int((idx >= 0).sum()) > n // 2
    assert torch.equal(t, t_p) and torch.equal(idx, idx_p)
    t_mp, idx_mp = tk.nearest_hit_plain(o, d, walls, alive)
    assert torch.equal(t_m, t_mp) and torch.equal(idx_m, idx_mp)
    assert bool((idx_m[~alive] == -1).all())
    assert tuple(occ.shape) == (n // 3, 3)
    assert torch.equal(occ, tk.occlusion_min_plain(o3, d3, walls))
    assert torch.equal(occ_ml, tk.occlusion_min_plain(o3, d3, walls, a3, l3))
    assert torch.equal(occ_l, tk.occlusion_min_plain(o3, d3, walls,
                                                     limit=l3))
    below = occ < l3
    assert 0 < int(below.sum()) < below.numel()
    assert torch.equal(occ_l[below], occ[below])
    if which == "tie":     # the copies tie: the original's index wins
        i = idx.clamp(min=0).long()
        hit9 = (idx >= 0) & (scene.a[i] == scene.a[9]).all(-1) \
            & (scene.b[i] == scene.b[9]).all(-1)
        assert int(hit9.sum()) > 20 and bool((idx[hit9] == 9).all())
    # a ray that leaves the scene misses: distance INF, index -1
    far = scene.a.amax(0)[None] + 10.0
    t_far, idx_far = tk.nearest_hit(far, far.new_tensor([[1.0, 0.0]]), walls)
    assert float(t_far) == 1e8 and int(idx_far) == -1


@cuda
@pytest.mark.parametrize("lanes", [1, 4])
def test_brute_sweep_in_either_lane_group_equals_its_plain_version(
        cuda_device, monkeypatch, lanes):
    """The brute route at one lane a ray and in lane groups of 4 (forced
    through ``bounce_kernel.lane_group``, which the wrapper asks), with and
    without ``alive`` / ``limit``, on 1,008 walls (one tile) and 4,808 (five
    tiles): the plain versions' bits."""
    monkeypatch.setattr(bk, "lane_group", lambda n, k: lanes)
    for n_boxes in (250, 1200):
        scene = rooms.city_scene(n_boxes, device=cuda_device).scene
        walls = tk.SweepWalls(tk.pack_walls(scene))
        o, d, gen = _sweep_rays(scene, 3001, cuda_device, 6)
        alive = torch.rand(3001, generator=gen, device=cuda_device) > 0.25
        limit = 300.0 * torch.rand(3001, generator=gen, device=cuda_device)
        for a in (None, alive):
            got = tk.nearest_hit(o, d, walls, a)
            want = tk.nearest_hit_plain(o, d, walls, a)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
            for lim in (None, limit):
                assert torch.equal(tk.occlusion_min(o, d, walls, a, lim),
                                   tk.occlusion_min_plain(o, d, walls, a,
                                                          lim))


@cuda
def test_ray_keys_are_morton_ray_keys(cuda_device):
    """The box walk's key kernel: ``accel.morton_ray_keys`` bit for bit,
    the largest key for a masked ray, points outside the window clamped."""
    scene = rooms.city_scene(2500, device=cuda_device).scene
    prep = ak.prepare(scene)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    o = (torch.rand((70001, 2), generator=gen, device=cuda_device) - 0.5) \
        * 1200.0
    alive = torch.rand(70001, generator=gen, device=cuda_device) > 0.3
    lo, span = prep.bounds[:2], prep.bounds[2:]
    for a in (None, alive):
        got = tk.ray_keys(o, a, prep.bounds)
        want = accel.morton_ray_keys(
            o[:, 0], o[:, 1], torch.ones_like(alive) if a is None else a, lo,
            span)
        assert got.dtype == torch.int64 and torch.equal(got, want)
    assert int((got == 0xFFFFFFFF).sum()) == int((~alive).sum())


@cuda
def test_sweeps_route_by_the_wall_count(cuda_device):
    """``sweep_walls`` takes the box walk from ``BOX_WALK_MIN_WALLS`` walls
    and the brute sweep below it (launch counts per route); the trace on
    either route equals the plain trace."""
    n_min = tk.BOX_WALK_MIN_WALLS
    small = rooms.city_scene(max(1, (n_min - 9) // 4), device=cuda_device)
    large = rooms.city_scene((n_min - 5) // 4, device=cuda_device)
    assert small.scene.n_walls < n_min <= large.scene.n_walls
    emit, u = rng.philox_uniforms(3, 1, 4, 4096, cuda_device)
    for room, box in ((small, False), (large, True)):
        walls = tk.sweep_walls(room.scene)
        assert (walls.sorted is not None) == box
        params = _two_ears(room, cuda_device, input_gain=100.0,
                           listener_radius=2.0)
        before = _route_counts()
        hits, dbg = tt.trace(room.scene, params, emit[0], u[0], n_debug=64,
                             use_kernels=True)
        torch.cuda.synchronize()
        step = (0, 0, 4, 4) if box else (4, 4, 0, 0)
        assert tuple(a - b for a, b in zip(_route_counts(), before)) == step
        want, dbg_plain = tt.trace(room.scene, params, emit[0], u[0],
                                   n_debug=64)
        v = want.valid
        assert int(v.sum()) > 0 and torch.equal(hits.valid, v)
        assert torch.equal(hits.delay[v], want.delay[v])
        assert torch.equal(hits.energy[v], want.energy[v])
        for got, plain in zip(dbg, dbg_plain):
            assert torch.equal(got, plain)


@cuda
def test_trace_with_kernels_equals_the_plain_trace(cuda_device):
    room = rooms.smoll_room(n_bands=2, device=cuda_device)
    params = _two_ears(room, cuda_device)
    emit, u = rng.philox_uniforms(6, 1, 5, 15000, cuda_device)
    before = _hit_counts()
    hits, dbg = tt.trace(room.scene, params, emit[0], u[0], n_debug=100,
                         use_kernels=True)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_hit_counts(), before)) == (5, 5, 0, 0)
    want, dbg_plain = tt.trace(room.scene, params, emit[0], u[0], n_debug=100)
    assert tuple(hits.valid.shape) == (5, 2, 15000, 2)
    assert int(want.valid.sum()) > 1000 and torch.equal(hits.valid, want.valid)
    v = want.valid
    assert torch.equal(hits.delay[v], want.delay[v])
    assert torch.equal(hits.energy[v], want.energy[v])
    assert tuple(dbg.pos.shape) == (6, 100, 2)
    for got, plain in zip(dbg, dbg_plain):
        assert torch.equal(got, plain)


@cuda
@pytest.mark.parametrize("room_fn,gain", [(rooms.smoll_room, 1.0),
                                          (rooms.big_room, 100.0)])
def test_rows_kernel_equals_the_plain_rows(cuda_device, room_fn, gain):
    scene, params = _setup(cuda_device, room_fn=room_fn, gain=gain)
    emit, u = rng.philox_uniforms(3, 1, 5, 15000, cuda_device)
    emit, u = emit[0], u[0]
    before = _hit_counts()
    rows = bk.trace_fused_rows(scene, params, emit, u)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_hit_counts(), before)) == (0, 0, 1, 0)
    want = bk.trace_fused_rows_plain(scene, params, emit, u)
    assert tuple(rows.shape) == (5, 8, 15000)
    assert int((want[:, [2, 5]] > 0.5).sum()) > 500
    assert torch.equal(rows, want)
    assert torch.equal(rows, bk.trace_fused_rows(scene, params, emit, u))
    hits = bk.trace_fused(scene, params, emit, u)
    plain = tt.trace_hits_only(scene, params, emit, u)
    assert torch.equal(hits.valid, plain.valid)
    assert torch.equal(hits.delay[plain.valid], plain.delay[plain.valid])
    # the rows binned in float are K3's IR of the same uniforms
    ir = bk.scatter_hits_rows(rows, **KW)
    assert torch.equal(ir, bk.scatter_hits_rows(rows, **KW))
    _assert_close_irs(ir, bk.trace_frames_ir_whole(scene, params, emit[None],
                                                   u[None], **KW))


@cuda
@pytest.mark.parametrize("n_listeners", [1, 2])
def test_fused_ir_kernel_is_k3_and_k4_bit_for_bit(cuda_device, n_listeners):
    room = rooms.smoll_room(device=cuda_device)
    params = _two_ears(room, cuda_device)
    params = params._replace(listeners=params.listeners[:n_listeners])
    emit, u = rng.philox_uniforms(12, 1, 5, 15000, cuda_device)
    before = _hit_counts(), _launch_counts()
    k6 = bk.trace_frame_ir_fused(room.scene, params, emit[0], u[0], **KW)
    seeded = bk.trace_frame_ir_fused(room.scene, params, seed=12,
                                     n_rays=15000, max_bounces=5, **KW)
    torch.cuda.synchronize()
    # one launch a call, K3's or K4's instantiation, counted as K6's
    assert tuple(a - b for a, b in zip(_hit_counts(), before[0])) == \
        (0, 0, 0, 2)
    assert _launch_counts() == before[1]
    k3 = bk.trace_frames_ir_whole(room.scene, params, emit, u, **KW)
    k4 = bk.trace_frames_ir_mega(room.scene, params, 12, 1, n_rays=15000,
                                 max_bounces=5, **KW)
    assert tuple(k6.shape) == (n_listeners, 72000, 1) and float(k6.sum()) > 0
    assert torch.equal(k6, k3) and torch.equal(seeded, k4)
    assert torch.equal(k6, seeded)
    _assert_close_irs(k6, bk.trace_frame_ir_fused_plain(
        room.scene, params, emit[0], u[0], **KW))
    # the exact_scatter route: a K5 pass per listener, binned in float
    state = bk.trace_accumulate_fused(
        room.scene, params, art.IRState.zeros(72000, n_listeners,
                                              device=cuda_device),
        emit, u, sample_rate=48000, exact_scatter=True)
    assert state.frames == 1
    _assert_close_irs(state.sum, k3)


def _open_corridor(device):
    """Two parallel walls 6 m apart, open at both ends, a listener between
    them: the rays that leave along the corridor escape at once, the
    others after a few bounces."""
    builder = art.SceneBuilder()
    mat = art.AudioMaterial(0.2, 0.3, 0.0, 1.0)
    builder.add_segment((-4.0, -3.0), (4.0, -3.0), (0.0, 1.0), mat)
    builder.add_segment((-4.0, 3.0), (4.0, 3.0), (0.0, -1.0), mat)
    return builder.build(device=device), TraceParams.make(
        [0.0, 0.0], [1.5, 1.0], device=device)


def _rows_case(device, case):
    if case == "open corridor":
        return _open_corridor(device)
    room_fn, gain = (rooms.big_room, 100.0) if case.startswith("Big") else \
        (rooms.smoll_room, 1.0)
    scene, params = _setup(device, room_fn=room_fn, gain=gain)
    if case.endswith("directive"):
        src, mic = _patterns(device)
        params = params._replace(directivity=src, mic_directivity=mic)
    return scene, params


@cuda
@pytest.mark.parametrize("case,n_rays,n_bounces", [
    ("SmollRoom", 15000, 5), ("Big Room", 15000, 5),
    ("SmollRoom", 131072, 8), ("SmollRoom directive", 15000, 5),
    ("open corridor", 15000, 5)])
def test_rows_kernel_is_the_plain_rows_in_either_lane_group(
        cuda_device, monkeypatch, case, n_rays, n_bounces):
    """K5's rows equal the plain rows bit for bit with one lane a ray and
    in lane groups of 4, whichever ``lane_group`` picks, with the same
    work counts; on the open corridor the rows of the bounces after a ray
    escapes are zeros in both (no memset runs)."""
    scene, params = _rows_case(cuda_device, case)
    emit, u = rng.philox_uniforms(8, 1, n_bounces, n_rays, cuda_device)
    emit, u = emit[0], u[0]
    want = bk.trace_fused_rows_plain(scene, params, emit, u)
    assert int((want[:, [2, 5]] > 0.5).sum()) > 100
    out = {}
    for lanes in (1, bk.LANE_GROUP):
        monkeypatch.setattr(bk, "lane_group", lambda n, k, g=lanes: g)
        work = torch.zeros(3, dtype=torch.int64, device=cuda_device)
        before = bk.trace_fused_rows.launches
        out[lanes] = bk.trace_fused_rows(scene, params, emit, u,
                                         work_counts=work), work
        torch.cuda.synchronize()
        assert bk.trace_fused_rows.launches == before + 1
    for lanes, (rows, work) in out.items():
        assert torch.equal(rows, want), lanes
        assert torch.equal(work, out[1][1]), lanes
    if case == "open corridor":    # most rays die before the last bounce
        assert float((want[-1, [2, 5]] > 0.5).float().mean()) < 0.1
        assert float((want[0, [2, 5]] > 0.5).float().mean()) > 0.2


@cuda
@pytest.mark.parametrize("room_fn,gain", [(rooms.smoll_room, 1.0),
                                          (rooms.big_room, 100.0)])
def test_rows_kernel_work_counts_are_k3s(cuda_device, room_fn, gain):
    """K5 runs K3's bounce loop: the same wall tests and sweeps on the same
    uniforms."""
    scene, params = _setup(cuda_device, room_fn=room_fn, gain=gain)
    emit, u = rng.philox_uniforms(14, 1, 5, 15000, cuda_device)
    work = {k: torch.zeros(3, dtype=torch.int64, device=cuda_device)
            for k in ("K5", "K3")}
    bk.trace_fused_rows(scene, params, emit[0], u[0], work_counts=work["K5"])
    bk.trace_frames_ir_whole(scene, params, emit, u, work_counts=work["K3"],
                             **KW)
    torch.cuda.synchronize()
    assert int(work["K3"][1]) > 15000
    assert torch.equal(work["K5"], work["K3"])


@cuda
def test_fused_ir_refuses_bands_and_17_listeners_on_the_card(cuda_device):
    """K6 routes to K3/K4's launch, which takes any band and listener
    count, so its wrapper refuses what the JAX contract refuses before
    anything launches."""
    room = rooms.smoll_room(device=cuda_device)
    emit, u = rng.philox_uniforms(2, 1, 4, 256, cuda_device)
    banded = rooms.smoll_room(n_bands=2, device=cuda_device)
    p1 = TraceParams.make(room.source, room.listener, device=cuda_device)
    p17 = p1._replace(listeners=_listeners(cuda_device, 17))
    before = _hit_counts(), _launch_counts()
    for scene, params, what in ((banded.scene, p1, "one band"),
                                (room.scene, p17, "16 listeners")):
        with pytest.raises(ValueError, match=what):
            bk.trace_frame_ir_fused(scene, params, emit[0], u[0], **KW)
        with pytest.raises(ValueError, match=what):
            bk.trace_frame_ir_fused(scene, params, seed=2, n_rays=256,
                                    max_bounces=4, **KW)
        with pytest.raises(ValueError, match=what):
            bk.trace_accumulate_fused(
                scene, params, art.IRState.zeros(
                    72000, params.listeners.shape[0], scene.n_bands,
                    device=cuda_device),
                emit, u, sample_rate=48000)
    assert (_hit_counts(), _launch_counts()) == before


@cuda
def test_hit_requests_route_by_listeners_bands_and_walls(cuda_device,
                                                         monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the plain version ran on the card")

    for mod, name in ((tk, "nearest_hit_plain"), (tk, "occlusion_min_plain"),
                      (bk, "trace_fused_rows_plain")):
        monkeypatch.setattr(mod, name, refuse)

    def run(scene, params, n_rays=4096, n_bounces=4):
        emit, u = rng.philox_uniforms(2, 1, n_bounces, n_rays, cuda_device)
        before = _hit_counts()
        hits = engine.trace_hits(scene, params, emit[0], u[0])
        torch.cuda.synchronize()
        assert tuple(hits.valid.shape) == (n_bounces, 2, n_rays,
                                           params.listeners.shape[0])
        assert int(hits.valid.sum()) > 0
        return tuple(a - b for a, b in zip(_hit_counts(), before))

    room = rooms.smoll_room(device=cuda_device)
    mono = TraceParams.make(room.source, room.listener, device=cuda_device)
    assert run(room.scene, mono) == (0, 0, 1, 0)                   # K5
    assert run(room.scene, _two_ears(room, cuda_device)) == (4, 4, 0, 0)
    banded = rooms.smoll_room(n_bands=4, device=cuda_device)
    assert run(banded.scene, mono) == (4, 4, 0, 0)                 # K1/K2
    big, p_big = _city(cuda_device, 1500)                    # 6,004 walls
    assert big.n_walls > bk.MAX_WALLS and big.n_walls >= tk.BOX_WALK_MIN_WALLS
    boxed = _route_counts()
    assert run(big, p_big) == (4, 4, 0, 0)                 # by the box walk
    assert tuple(a - b for a, b in zip(_route_counts(), boxed)) == \
        (0, 0, 4, 4)
    eng = art.Engine(room.scene, art.smoll_room_config())
    before = _hit_counts()
    _, dbg = eng.trace_debug(mono, seed=1, n_debug=10)
    assert tuple(a - b for a, b in zip(_hit_counts(), before)) == (5, 5, 0, 0)
    assert tuple(dbg.pos.shape) == (6, 10, 2)
    emit, u = rng.philox_uniforms(2, 1, 4, 256, cuda_device)
    with pytest.raises(ValueError, match="one listener"):
        bk.trace_fused(room.scene, _two_ears(room, cuda_device), emit[0],
                       u[0])
    with pytest.raises(ValueError, match="K7/K8"):
        bk.trace_fused(big, p_big, emit[0], u[0])
    with pytest.raises(ValueError, match="emit"):
        bk.trace_fused_rows(room.scene, mono, emit[0].cpu(), u[0])
    with pytest.raises(ValueError, match="is on"):
        tk.nearest_hit(room.scene.a.cpu(), room.scene.b.cpu(),
                       tk.pack_walls(room.scene))


@cuda
def test_float_scatters_are_deterministic_on_the_card(cuda_device):
    room = rooms.smoll_room(device=cuda_device)
    params = _two_ears(room, cuda_device)
    emit, u = rng.philox_uniforms(9, 1, 5, 15000, cuda_device)
    hits = tt.trace_hits_only(room.scene, params, emit[0], u[0],
                              use_kernels=True)
    ir = irm.scatter_hits(hits, **KW)
    spectro = legacy.scatter_hits_legacy(hits, 48000, 562)
    td = legacy.legacy_ir_to_time_domain(spectro, 48000, 72000)
    for _ in range(3):
        assert torch.equal(ir, irm.scatter_hits(hits, **KW))
        assert torch.equal(spectro, legacy.scatter_hits_legacy(hits, 48000,
                                                               562))
        assert torch.equal(td, legacy.legacy_ir_to_time_domain(spectro, 48000,
                                                               72000))
    assert float(ir.sum()) > 0 and tuple(spectro.shape) == (2, 562, 128)
    assert tuple(td.shape) == (2, 72000) and float(td.abs().sum()) > 0
    # the same hits binned on the CPU: only the order of the float sums differs
    cpu = irm.scatter_hits(tt.Hits(*(x.cpu() for x in hits)), **KW)
    np.testing.assert_allclose(to_numpy(ir), to_numpy(cpu), rtol=1e-5,
                               atol=1e-9)
    assert not torch.are_deterministic_algorithms_enabled()


# --- directive sources and microphones, diffraction and air -------------------

def _patterns(device):
    """A cardioid source padded to C = 5 and a figure-eight microphone."""
    from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
    return (torch.as_tensor(np.pad(dv.cardioid(0.7), (0, 2)), device=device),
            torch.as_tensor(dv.figure_eight(0.3), device=device))


def _omni_coded(params):
    one = torch.ones(1, device=params.source.device)
    return params._replace(directivity=one, mic_directivity=one)


@cuda
@pytest.mark.parametrize("kernel", ["K3", "K4", "K5", "K6", "K9"])
def test_directive_kernels_match_plain(cuda_device, kernel):
    scene, params = _setup(cuda_device)
    src, mic = _patterns(cuda_device)
    p = params._replace(directivity=src, mic_directivity=mic)
    emit, u = rng.philox_uniforms(4, 2, 5, 15000, cuda_device)
    one = dict(n_rays=15000, max_bounces=5, **KW)
    if kernel == "K3":
        runs = [lambda q: bk.trace_frames_ir_whole(scene, q, emit, u, **KW),
                lambda q: bk.trace_frames_ir_plain(scene, q, emit, u, **KW)]
    elif kernel == "K4":
        runs = [lambda q: bk.trace_frames_ir_mega(scene, q, 4, 2, **one),
                lambda q: bk.trace_frames_ir_mega_plain(scene, q, 4, 2,
                                                        **one)]
    elif kernel == "K5":
        runs = [lambda q: bk.trace_fused_rows(scene, q, emit[0], u[0]),
                lambda q: bk.trace_fused_rows_plain(scene, q, emit[0], u[0])]
    elif kernel == "K6":
        runs = [lambda q: bk.trace_frame_ir_fused(scene, q, emit[0], u[0],
                                                  **KW),
                lambda q: bk.trace_frame_ir_fused_plain(scene, q, emit[0],
                                                        u[0], **KW)]
    else:
        shared, srcs, lis, _ = _mixdown_batch(cuda_device)
        from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
        aims = torch.as_tensor(np.stack([np.pad(dv.cardioid(0.8 * i), (0, 2))
                                         for i in range(8)]),
                               device=cuda_device)
        kw = dict(directivity=aims, mic_directivity=mic, **one)
        runs = [lambda q: bk.trace_rooms_ir_mega(shared, srcs, lis, 4, 1,
                                                 **kw),
                lambda q: bk.trace_rooms_ir_mega_plain(shared, srcs, lis, 4,
                                                       1, **kw)]
    got, want = runs[0](p), runs[1](p)
    torch.cuda.synchronize()
    if kernel == "K5":
        assert torch.equal(got, want) and float(got[:, 4].sum()) > 0
    else:
        _assert_close_irs(got, want)
    if kernel != "K9":    # omni-coded patterns give the omni bits
        assert torch.equal(runs[0](_omni_coded(params)), runs[0](params))
    if kernel == "K6":    # and K6 == K3 holds for directive traces too
        assert torch.equal(got, bk.trace_frames_ir_whole(
            scene, p, emit[:1], u[:1], **KW))


@cuda
def test_directive_cluster_kernels_equal_k4_and_plain(cuda_device):
    scene, params = _city(cuda_device, 1200)
    src, mic = _patterns(cuda_device)
    p = params._replace(directivity=src, mic_directivity=mic)
    k4 = bk.trace_frames_ir_mega(ak.prepare(scene).scene, p, 7, 2,
                                 **ACCEL_KW)
    k7 = ak.trace_frames_ir_accel(scene, p, 7, 2, **ACCEL_KW)
    k8 = ak.trace_frames_ir_accel_sorted(scene, p, 7, 2, **ACCEL_KW)
    torch.cuda.synchronize()
    assert float(k4.sum()) > 0 and torch.equal(k4, k7) and torch.equal(k4, k8)
    _assert_close_irs(k8, ak.trace_frames_ir_accel_sorted_plain(
        scene, p, 7, 2, **ACCEL_KW))
    assert torch.equal(ak.trace_frames_ir_accel_sorted(
        scene, _omni_coded(params), 7, 2, **ACCEL_KW),
        ak.trace_frames_ir_accel_sorted(scene, params, 7, 2, **ACCEL_KW))
    banded, bparams = _city(cuda_device, 1200, n_bands=8)
    bp = bparams._replace(directivity=src, mic_directivity=mic)
    _assert_close_irs(ak.trace_frames_ir_accel(banded, bp, 7, 2, **ACCEL_KW),
                      ak.trace_frames_ir_accel_plain(banded, bp, 7, 2,
                                                     **ACCEL_KW))
    assert torch.equal(ak.trace_frames_ir_accel(
        banded, _omni_coded(bparams), 7, 2, **ACCEL_KW),
        ak.trace_frames_ir_accel(banded, bparams, 7, 2, **ACCEL_KW))


@cuda
def test_mixdown_per_source_aims_equal_single_source_launches(cuda_device):
    from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
    shared, srcs, lis, scene = _mixdown_batch(cuda_device)
    aims = torch.as_tensor(np.stack([dv.cardioid(0.8 * i) for i in range(8)]),
                           device=cuda_device)
    mic = torch.as_tensor(np.stack([dv.cardioid(0.5), dv.cardioid(-0.5)]),
                          device=cuda_device)
    kw = dict(n_rays=15000, max_bounces=5, **KW)
    mix = trace_sources_mixdown(scene, TraceParams.make(
        srcs, lis[0], directivity=aims, mic_directivity=mic,
        device=cuda_device), 7, **kw)
    singles = [bk.trace_rooms_ir_mega(
        shared, srcs[s:s + 1], lis[s:s + 1], 7, 1, entry_offset=s,
        directivity=aims[s:s + 1], mic_directivity=mic, **kw)[0]
        for s in range(8)]
    # source 0's launch is K4's
    assert torch.equal(singles[0], bk.trace_frames_ir_mega(
        scene, TraceParams.make(srcs[0], lis[0], directivity=aims[0],
                                mic_directivity=mic, device=cuda_device),
        7, 1, **kw))
    _assert_close_irs(mix, sum(singles))


@cuda
@pytest.mark.parametrize("order", [1, 2])
def test_diffraction_through_k2_equals_its_plain_version(cuda_device, order):
    from realisticaudioraytracing2d_tpu_torch.models.materials import \
        AudioMaterial
    from realisticaudioraytracing2d_tpu_torch.ops import diffraction as dfr
    room = rooms.smoll_room(device=cuda_device)
    room.builder.add_segment((-18.0, 6.0), (-15.0, 6.0), (0.0, 1.0),
                             AudioMaterial(0.9, 0.5, 0.0, 1.0))
    scene = room.builder.build(device=cuda_device)
    src, mic = _patterns(cuda_device)
    p = TraceParams.make(room.source, [[-16.0, 3.0], [0.0, -3.68]],
                         directivity=src, mic_directivity=mic,
                         device=cuda_device)
    before = _hit_counts()[1]
    got = dfr.diffraction_ir(scene, p, order=order, **KW)
    # all visibility sweeps of a paths call in one launch
    assert _hit_counts()[1] == before + (1 if order == 1 else 2)
    want = dfr.diffraction_ir(scene, p, order=order, use_kernels=False, **KW)
    assert float(got[0].sum()) > 0 and torch.equal(got, want)


# --- the diffraction kernels (csrc/diffraction_kernel.cu) ----------------------

def _diffraction_counts():
    """Launches of K2 and of the two diffraction kernels."""
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        diffraction_kernel as dk
    return (tk.occlusion_min.launches + tk.occlusion_min.box_launches,
            dk.segments.launches, dk.bin_paths.launches)


def _kernel_and_chain(scene, p, order, **kw):
    """``diffraction_ir`` through the kernels (a K2 sweep an order, one
    launch of each diffraction kernel: checked) and through the plain
    chain, on the card."""
    from realisticaudioraytracing2d_tpu_torch.ops import diffraction as dfr
    before = _diffraction_counts()
    got = dfr.diffraction_ir(scene, p, order=order, **kw)
    assert tuple(a - b for a, b in zip(_diffraction_counts(), before)) \
        == (order, 1, 1)
    return got, dfr.diffraction_ir(scene, p, order=order, use_kernels=False,
                                   **kw)


@cuda
@pytest.mark.parametrize("pats", [False, True])
@pytest.mark.parametrize("n_listeners", [1, 2])
@pytest.mark.parametrize("n_bands", [1, 8])
@pytest.mark.parametrize("order", [1, 2])
def test_diffraction_kernels_equal_the_card_chain_round_the_walk(
        cuda_device, order, n_bands, n_listeners, pats):
    """SampleScene at the 16 poses of the barrier walk's circle (7
    shadowed, 9 lit), at the barrier cell's rate and IR length: the
    kernels' IR is the card chain's bit for bit."""
    from test_torch_diffraction_kernel import case
    heard = 0
    for i in range(16):
        scene, p = case(f"walk{i}", n_bands, n_listeners, pats, cuda_device)
        got, want = _kernel_and_chain(scene, p, order, sample_rate=44100,
                                      ir_length=88200)
        assert torch.equal(got, want)
        heard += int(bool(want.any()))
    assert 0 < heard < 16


@cuda
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name,n_bands,n_listeners,pats", [
    ("split", 1, 1, False), ("doubled", 8, 2, True),
    ("smoll barrier", 1, 2, True), ("barrier", 8, 2, True),
    ("scattered", 8, 1, True)])
def test_diffraction_kernels_equal_the_card_chain_on_barriers(
        cuda_device, order, name, n_bands, n_listeners, pats):
    """A straight seam, coincident corners, SmollRoom with a barrier, and
    a barrier among 100 short walls (3,226 kept order-2 paths: the sort
    in the scratch, past the shared keys)."""
    from test_torch_diffraction_kernel import case
    scene, p = case(name, n_bands, n_listeners, pats, cuda_device)
    got, want = _kernel_and_chain(scene, p, order, **KW)
    assert float(want.sum()) > 0 and torch.equal(got, want)


@cuda
def test_diffraction_kernels_take_host_numbers(cuda_device):
    """A speed of sound and an input gain given as Python numbers: the
    chain multiplies by f32(1 / c) where it divides by c, and so do the
    kernels."""
    from test_torch_diffraction_kernel import case
    scene, p = case("walk5", 8, 2, True, cuda_device)
    p = p._replace(speed_of_sound=340.0, input_gain=2.5)
    got, want = _kernel_and_chain(scene, p, 2, **KW)
    assert float(want.sum()) > 0 and torch.equal(got, want)


@cuda
def test_augment_ir_adds_the_kernels_paths_in_place(cuda_device,
                                                    monkeypatch):
    """One order-2 ``_augment_ir`` call: the paths are added into the
    fresh IR in place, the chain's bits, through two K2 launches (a sweep
    an order), one of each diffraction kernel and no ``add_rows``
    (``index_put_``)."""
    from test_torch_diffraction_kernel import case
    from realisticaudioraytracing2d_tpu_torch import streaming as st
    from realisticaudioraytracing2d_tpu_torch.ops import diffraction as dfr
    scene, p = case("walk6", 8, 1, False, cuda_device)
    cur = torch.rand((1, 88200, 8), device=cuda_device)
    want = st._augment_ir(cur.clone(), scene, p, 44100, 2, None, plain=True)

    def refuse(*args, **kw):
        raise AssertionError("the chain's binning ran on the card")

    monkeypatch.setattr(dfr, "add_rows", refuse)
    got = cur.clone()
    before = _diffraction_counts()
    out = st._augment_ir(got, scene, p, 44100, 2, None)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_diffraction_counts(), before)) \
        == (2, 1, 1)
    assert out is got and torch.equal(got, want)
    assert bool((got != cur).any())


@cuda
def test_a_profiled_barrier_chunk_launches_four_diffraction_kernels(
        cuda_device):
    """Two profiled chunks of the barrier cell's stream (8 octave bands,
    order 2, air), the listener in the shadow: inside each
    ``art.addenda.diffraction`` span exactly four launch calls and no
    sync or copy, and on the card two K2 sweeps (one an order, as the
    benchmark's barrier cell counts them), one segment launch and one bin
    launch a chunk."""
    from torch.profiler import ProfilerActivity, profile
    from realisticaudioraytracing2d_tpu_torch.ops import air
    from test_torch_diffraction_kernel import walk_pose
    room = rooms.sample_scene(n_bands=8, device=cuda_device)
    cfg = art.sample_scene_config(n_bands=8, ray_count=4096)
    p = art.Engine(room.scene, cfg).params(room.source, walk_pose(5))
    alpha = air.iso9613_alpha(air.band_frequencies(8))
    dry = torch.rand(4 * 4410, device=cuda_device) - 0.5

    def run():
        return art.Streamer(room.scene, cfg, seed=6, diffraction=2,
                            air_alpha=alpha, band_split="octave").stream_clip(
            dry, lambda i: p, total_chunks=2)

    run()                                            # build and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_lead_in()
        run()
        torch.cuda.synchronize()
    cuda_kind = torch.autograd.DeviceType.CUDA
    kernels = [e.name for e in prof.events() if e.device_type == cuda_kind]
    assert sum("wall_sweep_kernel<false" in n for n in kernels) == 4
    assert sum("diffraction_segments_kernel" in n for n in kernels) == 2
    assert sum("diffraction_bin_kernel" in n for n in kernels) == 2
    host = [e for e in prof.events() if e.device_type != cuda_kind]
    spans = [e for e in host if e.name == "art.addenda.diffraction"]
    assert len(spans) == 2
    for r in spans:
        t0, t1 = r.time_range.start, r.time_range.end
        inside = [e.name for e in host if t0 <= e.time_range.start <= t1]
        launches = [n for n in inside
                    if n.startswith(("cudaLaunch", "cuLaunch"))]
        assert len(launches) == 4, inside
        assert not [n for n in inside if "Synchronize" in n
                    or "Memcpy" in n or "index_put" in n], inside


@cuda
def test_stream_with_patterns_diffraction_and_air_matches_plain(cuda_device):
    from realisticaudioraytracing2d_tpu_torch.ops import air
    room = rooms.smoll_room(device=cuda_device)
    cfg = art.smoll_room_config(ray_count=4096)
    src, mic = _patterns(cuda_device)
    p = art.Engine(room.scene, cfg).params(
        room.source, [[-0.1, -3.68], [0.1, -3.68]], directivity=src,
        mic_directivity=mic)
    alpha = air.iso9613_alpha(air.band_frequencies(1))
    dry = torch.zeros(48000, device=cuda_device)
    dry[4800] = 1.0
    outs = []
    for backend in ("auto", "plain"):
        s = art.Streamer(room.scene, cfg, seed=3, n_listeners=2,
                         diffraction=1, air_alpha=alpha, backend=backend)
        outs.append(to_numpy(s.stream_clip(dry, lambda i: p,
                                           total_chunks=4)))
    assert np.abs(outs[1]).max() > 0
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4,
                               atol=1e-6 * np.abs(outs[1]).max())


# --- bands, listener blocks and batches of large scenes -----------------------

def _listener_grid(device, n=64):
    """n listeners on a grid across SmollRoom."""
    xy = torch.stack(torch.meshgrid(torch.linspace(-16, 16, 8),
                                    torch.linspace(-4, 7, n // 8),
                                    indexing="ij"), -1).reshape(-1, 2)
    return xy.to(device)


@cuda
@pytest.mark.parametrize("kernel", ["K3", "K4", "K9"])
@pytest.mark.parametrize("n_bands", [8, 32, 512])
def test_banded_bounce_kernels_match_plain(cuda_device, kernel, n_bands):
    scene, params = _setup(cuda_device, n_bands=n_bands)
    kw = dict(n_rays=15000, max_bounces=5, **KW)
    if kernel == "K3":
        emit, u = rng.philox_uniforms(6, 2, 5, 15000, cuda_device)
        got = bk.trace_frames_ir_whole(scene, params, emit, u, **KW)
        want = bk.trace_frames_ir_plain(scene, params, emit, u, **KW)
    elif kernel == "K4":
        got = bk.trace_frames_ir_mega(scene, params, 6, 2, **kw)
        want = bk.trace_frames_ir_mega_plain(scene, params, 6, 2, **kw)
    else:
        scenes, src, lis = rooms.random_rooms(3, seed=5, n_bands=n_bands,
                                              device=cuda_device)
        got = bk.trace_rooms_ir_mega(scenes, src, lis, 6, 2,
                                     entry_offset=4, **kw)
        want = bk.trace_rooms_ir_mega_plain(scenes, src, lis, 6, 2,
                                            entry_offset=4, **kw)
        got, want = got[0], want[0]
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.shape[-1] == n_bands
    for k in (0, n_bands // 2, n_bands - 1):
        _assert_close_irs(got[..., k], want[..., k])


@cuda
@pytest.mark.parametrize("n_bands", [8, 32, 40])
def test_equal_bands_give_the_one_band_bits(cuda_device, n_bands):
    scene, params = _setup(cuda_device)
    same = scene._replace(
        absorption=scene.absorption.expand(-1, n_bands).contiguous())
    kw = dict(n_rays=15000, max_bounces=5, **KW)
    one = bk.trace_frames_ir_mega(scene, params, 3, 2, **kw)
    many = bk.trace_frames_ir_mega(same, params, 3, 2, **kw)
    city, p_city = _city(cuda_device, 300)
    city_same = city._replace(
        absorption=city.absorption.expand(-1, n_bands).contiguous())
    k8 = ak.trace_frames_ir_accel_sorted(city, p_city, 3, 2, **ACCEL_KW)
    k7 = ak.trace_frames_ir_accel(city_same, p_city, 3, 2, **ACCEL_KW)
    torch.cuda.synchronize()
    assert float(one.sum()) > 0 and float(k8.sum()) > 0
    for k in range(n_bands):
        assert torch.equal(many[..., k], one[..., 0])
        assert torch.equal(k7[..., k], k8[..., 0])


@cuda
@pytest.mark.parametrize("n_bands", [8, 32])
def test_k4_equals_k7_on_a_sorted_banded_city(cuda_device, n_bands):
    scene, params = _city(cuda_device, 1200, n_bands)
    sorted_scene = ak.prepare(scene).scene
    k4 = bk.trace_frames_ir_mega(sorted_scene, params, 8, 2, **ACCEL_KW)
    k7 = ak.trace_frames_ir_accel(scene, params, 8, 2, **ACCEL_KW)
    torch.cuda.synchronize()
    assert float(k4[..., -1].sum()) > 0 and torch.equal(k7, k4)


def _big_mic_pattern(prep, n_listeners):
    """A cardioid microphone pattern padded with zero harmonics to so many
    coefficients that only about 16 listeners fit one K7/K8 block beside
    ``prep``'s super boxes (``[n_listeners, C]``)."""
    from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
    boxes = prep.n_clusters // prep.group * 6 + 24
    n_mic = (bk.SMEM_FLOATS - boxes - 1) // 16 - 2
    n_mic -= 1 - n_mic % 2
    c = np.pad(dv.cardioid(0.7), (0, n_mic - 3)).astype(np.float32)
    return torch.as_tensor(np.tile(c, (n_listeners, 1)))


@cuda
@pytest.mark.parametrize("kernel", ["K3", "K4", "K9", "K7", "K8"])
def test_listener_blocks_equal_calls_on_their_slices(cuda_device, kernel):
    """64 listeners where a block's shared memory holds 16: the call runs
    4 blocks of launches and equals, bit for bit, the calls on each
    block's slice of listeners (one launch each). K3/K4/K9: SmollRoom
    padded to the 5,280-wall limit; K7/K8: a city with a microphone
    pattern of some 3,600 coefficients (a cardioid and zero harmonics)."""
    grid = _listener_grid(cuda_device)
    mic = None
    if kernel in ("K7", "K8"):
        scene, params = _city(cuda_device, 300, 1 if kernel == "K8" else 4)
        grid = params.listeners + grid * 0.5
        mic = _big_mic_pattern(ak.prepare(scene), 64).to(cuda_device)
        step = ak._listener_step(ak.prepare(scene), 1, mic.shape[-1])
        fn = (ak.trace_frames_ir_accel if kernel == "K7"
              else ak.trace_frames_ir_accel_sorted)
        run = lambda p: fn(scene, p, 2, 2, **ACCEL_KW)  # noqa: E731
    else:
        scene, params = _setup(cuda_device, n_bands=4)
        scene = scene.pad_to(bk.MAX_WALLS)
        step = bk.listener_block(scene.n_walls)
        kw = dict(n_rays=4096, max_bounces=5, **KW)
        if kernel == "K3":
            emit, u = rng.philox_uniforms(2, 1, 5, 4096, cuda_device)
            run = lambda p: bk.trace_frames_ir_whole(  # noqa: E731
                scene, p, emit, u, **KW)
        elif kernel == "K4":
            run = lambda p: bk.trace_frames_ir_mega(  # noqa: E731
                scene, p, 2, 1, **kw)
        else:
            run = lambda p: bk.trace_rooms_ir_mega(  # noqa: E731
                Scene.stack([scene]), p.source[None], p.listeners[None], 2,
                1, mic_directivity=p.mic_directivity, **kw)[0]
    assert step == 16
    wrapper = {"K3": bk.trace_frames_ir_whole, "K4": bk.trace_frames_ir_mega,
               "K9": bk.trace_rooms_ir_mega,
               "K7": ak.trace_frames_ir_accel,
               "K8": ak.trace_frames_ir_accel_sorted}[kernel]
    per_call = 5 if kernel in ("K7", "K8") else 1
    before = wrapper.launches
    whole = run(params._replace(listeners=grid, mic_directivity=mic))
    mid = wrapper.launches
    parts = [run(params._replace(
        listeners=grid[l0:l0 + 16],
        mic_directivity=None if mic is None else mic[l0:l0 + 16]))
        for l0 in range(0, 64, 16)]
    torch.cuda.synchronize()
    assert mid - before == 4 * per_call
    assert wrapper.launches - mid == 4 * per_call
    assert tuple(whole.shape[:1]) == (64,)
    assert whole.shape[-1] == scene.n_bands
    heard = int((whole.sum((1, 2)) > 0).sum())
    assert heard >= (1 if kernel in ("K7", "K8") else 16)
    assert torch.equal(whole, torch.cat(parts))


@cuda
@pytest.mark.parametrize("kernel", ["K4", "K9", "K7"])
def test_scratch_chunks_are_counted_and_equal_one_launch(cuda_device,
                                                         monkeypatch,
                                                         kernel):
    """Past the largest register bucket the energies live in a device
    scratch (K4/K9) or in K7's energy buffers; a call whose planes (frames,
    or entries x frames) do not fit it runs them in chunks (K7: passes of
    frames, B launches each). Each chunk's launches are counted in
    ``.launches``, and the IR equals the one-chunk call bit for bit."""
    n_bands = 40
    if kernel == "K7":
        scene, params = _city(cuda_device, 300, n_bands)
        wrapper = ak.trace_frames_ir_accel
        run = lambda: wrapper(scene, params, 3, 5, **ACCEL_KW)  # noqa: E731
        # two frames' two energy buffers a pass
        cap = 2 * 2 * ACCEL_KW["n_rays"] * ak.energy_rows(n_bands)
        per_call = ACCEL_KW["max_bounces"]
    else:
        scene, params = _setup(cuda_device, n_bands=n_bands)
        kw = dict(n_rays=4096, max_bounces=5, **KW)
        cap = 2 * 4096 * n_bands
        per_call = 1
        if kernel == "K4":
            wrapper = bk.trace_frames_ir_mega
            run = lambda: wrapper(scene, params, 3, 5, **kw)  # noqa: E731
        else:
            wrapper = bk.trace_rooms_ir_mega
            run = lambda: wrapper(  # noqa: E731
                Scene.stack([scene]), params.source[None].expand(2, 2),
                params.listeners[None].expand(2, -1, 2), 3, 3, **kw)
    before = wrapper.launches
    one = run()
    mid = wrapper.launches
    monkeypatch.setattr(bk, "SCRATCH_FLOATS", cap)
    chunked = run()
    torch.cuda.synchronize()
    assert mid - before == per_call
    # 5 frames or 2 x 3 planes, 2 a chunk
    assert wrapper.launches - mid == 3 * per_call
    assert float(one.sum()) > 0 and torch.equal(one, chunked)


@cuda
def test_large_scene_sweep_and_mixdown_match_single_calls(cuda_device):
    cities = [rooms.city_scene(1500, seed=s, device=cuda_device)
              for s in (1, 2)]
    scenes = Scene.stack([c.scene for c in cities])
    src = np.stack([c.source for c in cities])
    lis = np.stack([c.listener for c in cities])
    assert scenes.n_walls > bk.MAX_WALLS
    kw = dict(n_rays=4096, max_bounces=5, sample_rate=16000, ir_length=24000)
    before = _launch_counts()
    swept = sweep_rooms(scenes, src, lis, 4, n_frames=2, input_gain=100.0,
                        room_offset=3, **kw)
    counts = tuple(a - b for a, b in zip(_launch_counts(), before))
    assert counts == (0, 0, 0, 2 * 5)                 # K8 per room
    for e, city in enumerate(cities):
        p = TraceParams.make(city.source, city.listener, input_gain=100.0,
                             device=cuda_device)
        one = ak.trace_frames_ir_accel_sorted(city.scene, p, 4, 2,
                                              entry=3 + e, **kw)
        assert float(one.sum()) > 0
        assert torch.equal(swept[e], one / torch.tensor(2.0,
                                                        device=cuda_device))
    # the mixdown: 4 sources in one city, K7 at 4 bands, one sort
    banded = rooms.city_scene(1500, seed=1, n_bands=4, device=cuda_device)
    params = TraceParams.make(
        banded.source[None] + np.array([[0.0, 0.0], [3.0, 0.0], [0.0, 3.0],
                                        [-3.0, 0.0]], np.float32),
        banded.listener[None] + np.array([[0.0, 0.0], [1.0, 0.0]],
                                         np.float32),
        input_gain=100.0, device=cuda_device)
    srcs = params.source
    builds = ak.prepare.builds
    mix = trace_sources_mixdown(banded.scene, params, 9, **kw)
    assert ak.prepare.builds - builds <= 1
    singles = [ak.trace_frames_ir_accel(
        banded.scene, params._replace(source=srcs[s]), 9, 1, entry=s, **kw)
        for s in range(4)]
    plain = ak.trace_rooms_ir_accel_plain(
        banded.scene, srcs, params.listeners.expand(4, 2, 2), 9, 1,
        input_gain=100.0, ray_chunk=1024, **kw).sum(0)
    torch.cuda.synchronize()
    assert tuple(mix.shape) == (2, 24000, 4)
    assert torch.equal(mix, torch.stack(singles).sum(0))
    for k in (0, 3):
        _assert_close_irs(mix[..., k], plain[..., k])


@cuda
def test_banded_stream_with_air_matches_plain(cuda_device):
    scene, params = _setup(cuda_device, n_bands=8)
    cfg = art.smoll_room_config(n_bands=8)
    from realisticaudioraytracing2d_tpu_torch.ops import air
    alpha = air.iso9613_alpha(air.band_frequencies(8))
    dry = torch.zeros(9600, device=cuda_device)
    dry[100] = 1.0
    outs = {}
    for backend in ("auto", "plain"):
        before = bk.trace_frames_ir_mega.launches
        outs[backend] = art.Streamer(scene, cfg, seed=4, air_alpha=alpha,
                                     backend=backend).stream_clip(
            dry, lambda i: params, total_chunks=4)
        torch.cuda.synchronize()
        assert bk.trace_frames_ir_mega.launches - before == (
            4 if backend == "auto" else 0)
    got, want = to_numpy(outs["auto"]), to_numpy(outs["plain"])
    assert got.shape == (1, 4 * 4800) and np.abs(want).max() > 0
    # the limits of the directive stream's test above
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


@cuda
def test_octave_stream_with_diffraction_and_air_matches_plain(cuda_device):
    """SampleScene in 8 bands with the octave split, order-2 diffraction
    and air, the listener in the top wall's shadow: K4 and the
    diffraction kernels (a K2 sweep an order) against the plain trace and
    chain, within the banded stream's limits."""
    from realisticaudioraytracing2d_tpu_torch.ops import air
    room = rooms.sample_scene(n_bands=8, device=cuda_device)
    cfg = art.sample_scene_config(n_bands=8, ray_count=4096)
    p = art.Engine(room.scene, cfg).params(room.source, [18.5, 18.12])
    alpha = air.iso9613_alpha(air.band_frequencies(8))
    dry = torch.zeros(8820, device=cuda_device)
    dry[100] = 1.0
    outs = {}
    for backend in ("auto", "plain"):
        before = tk.occlusion_min.launches
        outs[backend] = art.Streamer(
            room.scene, cfg, seed=4, diffraction=2, air_alpha=alpha,
            band_split="octave", backend=backend).stream_clip(
            dry, lambda i: p, total_chunks=4)
        torch.cuda.synchronize()
        assert tk.occlusion_min.launches - before == (
            8 if backend == "auto" else 0)
    got, want = to_numpy(outs["auto"]), to_numpy(outs["plain"])
    assert got.shape == (1, 4 * 4410) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


@cuda
@pytest.mark.parametrize("n_bands,n_listeners", [(1, 1), (8, 16), (32, 24),
                                                 (512, 64)])
def test_entry_points_take_any_band_and_listener_count(
        cuda_device, tmp_path, n_bands, n_listeners):
    """Each entry point of the banded and many-listener paths runs on the
    card through its kernel and raises nowhere."""
    from realisticaudioraytracing2d_tpu_torch import cli
    room = rooms.smoll_room(n_bands=n_bands, device=cuda_device)
    lis = _listener_grid(cuda_device)[:n_listeners]
    p = TraceParams.make(room.source, lis, device=cuda_device)
    kw = dict(n_rays=2048, max_bounces=5, sample_rate=16000,
              ir_length=8000)
    k4 = bk.trace_frames_ir_mega.launches
    st = art.trace_accumulate(
        room.scene, p, art.IRState.zeros(8000, n_listeners, n_bands,
                                         device=cuda_device),
        n_frames=2, seed=1, n_rays=2048, max_bounces=5, sample_rate=16000)
    cfg = art.smoll_room_config(n_bands=n_bands, ray_count=2048)
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, sample_rate=16000, reverb_duration=0.5))
    out = art.Streamer(room.scene, cfg, seed=2, n_listeners=n_listeners
                       ).stream_clip(torch.ones(3200, device=cuda_device),
                                     lambda i: p, total_chunks=2)
    assert bk.trace_frames_ir_mega.launches == k4 + 3
    assert tuple(st.sum.shape) == (n_listeners, 8000, n_bands)
    assert tuple(out.shape) == (n_listeners, 3200)
    scenes, src, _ = rooms.random_rooms(2, seed=1, n_bands=n_bands,
                                        device=cuda_device)
    k9 = bk.trace_rooms_ir_mega.launches
    swept = sweep_rooms(scenes, src, lis[None].expand(2, -1, -1), 3, **kw)
    mix = trace_sources_mixdown(room.scene, p._replace(
        source=torch.as_tensor(src, device=cuda_device)), 4, **kw)
    torch.cuda.synchronize()
    assert bk.trace_rooms_ir_mega.launches == k9 + 2
    assert tuple(swept.shape) == (2, n_listeners, 8000, n_bands)
    assert tuple(mix.shape) == (n_listeners, 8000, n_bands)
    for x in (st.sum, out, swept, mix):
        assert bool(torch.isfinite(x).all()) and float(x.abs().sum()) > 0
    small = ["--rays", "2048", "--sample-rate", "16000", "--reverb", "0.5",
             "--bands", str(n_bands), "--device", "cuda"]
    wav = str(tmp_path / "dry.wav")
    from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (
        click_clip, write_wav)
    write_wav(wav, click_clip(0.5, 16000, click_times=(0.1,)), 16000)
    cli.main(["trace", "--room", "smoll", *small, "--ir-out",
              str(tmp_path / "ir.npz")])
    cli.main(["bake", "--room", "smoll", *small, "--in", wav, "--out",
              str(tmp_path / "wet.wav")])
    cli.main(["sweep", "--rooms", "2", *small, "--out",
              str(tmp_path / "irs.npz")])
    assert np.load(tmp_path / "irs.npz")["irs"].shape == (2, 1, 8000,
                                                          n_bands)


# --- the redesigned K7 (sorted, banded) and K3/K4 lane groups ----------------

@cuda
def test_k7_at_one_band_is_k8(cuda_device):
    """K7 at K = 1 launches K8's instantiation: the same bits, work counts
    and launches per call, counted as K8's."""
    scene, params = _city(cuda_device, 1500)
    work = [torch.zeros(3, dtype=torch.int64, device=cuda_device)
            for _ in range(2)]
    counts = _launch_counts()
    k7 = ak.trace_frames_ir_accel(scene, params, 6, 2, work_counts=work[0],
                                  **ACCEL_KW)
    k8 = ak.trace_frames_ir_accel_sorted(scene, params, 6, 2,
                                         work_counts=work[1], **ACCEL_KW)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launch_counts(), counts)) == \
        (0, 0, 0, 10)
    assert float(k8.sum()) > 0 and torch.equal(k7, k8)
    assert torch.equal(work[0], work[1])


@cuda
@pytest.mark.parametrize("n_bands", [5, 33])
def test_k7_band_counts_off_the_row_width_match_plain(cuda_device, n_bands):
    """K bands that do not fill the energy buffer's rows of K rounded up
    to 4: the register bucket's padding bands (K = 5) and the wide
    kernel's band-major planes (K = 33) against the plain twin, band by
    band, and the launches counted as K7's."""
    scene, params = _city(cuda_device, 300, n_bands)
    before = ak.trace_frames_ir_accel.launches
    got = ak.trace_frames_ir_accel(scene, params, 4, 2, **ACCEL_KW)
    want = ak.trace_frames_ir_accel_sorted_plain(scene, params, 4, 2,
                                                 **ACCEL_KW)
    torch.cuda.synchronize()
    assert ak.trace_frames_ir_accel.launches - before == \
        ACCEL_KW["max_bounces"]
    assert tuple(got.shape) == (1, 24000, n_bands)
    assert float(got[..., -1].sum()) > 0
    for k in range(n_bands):
        _assert_close_irs(got[..., k], want[..., k])


def _listeners(device, n):
    """SmollRoom's listener and n - 1 more around it."""
    grid = _listener_grid(device)
    return (grid[:n] * 0.25 + torch.tensor([0.0, -3.68], device=device))


@cuda
@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("n_bands", [1, 8, 32])
@pytest.mark.parametrize("n_listeners", [1, 4, 64])
@pytest.mark.parametrize("directive", [False, True])
def test_lane_groups_give_the_one_lane_bits(cuda_device, monkeypatch,
                                            kernel, n_bands, n_listeners,
                                            directive):
    """K3 and K4 in lane groups of 4 equal G = 1 bit for bit, with the
    same work counts."""
    scene, params = _setup(cuda_device, n_bands=n_bands)
    params = params._replace(listeners=_listeners(cuda_device, n_listeners))
    if directive:
        src, mic = _patterns(cuda_device)
        params = params._replace(directivity=src, mic_directivity=mic)
    emit, u = rng.philox_uniforms(9, 1, 5, 15000, cuda_device)

    def run(work):
        if kernel == "K3":
            return bk.trace_frames_ir_whole(scene, params, emit, u,
                                            work_counts=work, **KW)
        return bk.trace_frames_ir_mega(scene, params, 9, 1, n_rays=15000,
                                       max_bounces=5, work_counts=work, **KW)

    out = {}
    for lanes in (1, bk.LANE_GROUP):
        monkeypatch.setattr(bk, "lane_group", lambda n, k, g=lanes: g)
        work = torch.zeros(3, dtype=torch.int64, device=cuda_device)
        out[lanes] = (run(work), work)
    torch.cuda.synchronize()
    ir1, w1 = out[1]
    assert float(ir1.sum()) > 0
    for lanes, (ir, w) in out.items():
        assert torch.equal(ir, ir1), lanes
        assert torch.equal(w, w1), lanes


# --- spatial captures and the binaural stream --------------------------------
#
# The spatial capture is a directive trace with a per-listener microphone
# table (3 or 5 virtual microphones), so it takes the limits of the
# kernels' other directive tests. The binaural decode then takes float32
# target bins ``t = bin - shift * sin(phi)``, whose spacing at 72,000 bins
# is 7.8e-3: an input that differs by the kernel's fixed-point rounding
# can round a ``t`` one spacing over and move ``e * spacing`` of a deposit
# to the next bin (tests/test_torch_spatial.py). Decoded IRs are held per
# bin within DECODE_FLIPS such moves of the largest deposit; the audio
# within what its IRs explain: |d out| <= sum |dry| * max |d IR| (the
# convolution is linear, the crossfade a convex mix), plus 2e-6 of the
# peak for the FFTs.

DECODE_FLIPS = 4


def _decode_limit(w_max, n_t, shadow=0.6):
    return DECODE_FLIPS * (1.0 + shadow) * w_max * float(
        np.spacing(np.float32(n_t)))


def _click(device, n=48000, at=(4800, 20000)):
    dry = torch.zeros(n, device=device)
    dry[list(at)] = 1.0
    return dry


def _binaural_run(scene, cfg, p, dry, n_chunks, **kw):
    """A binaural stream's audio and its decoded IR of every chunk."""
    irs = []
    out = art.Streamer(scene, cfg, binaural=True, **kw).stream_clip(
        dry, lambda i: p, total_chunks=n_chunks,
        facing_fn=lambda i: 0.5 - 0.3 * i,
        on_chunk=lambda i, st: irs.append(st.prev_ir.clone()))
    torch.cuda.synchronize()
    return out, irs


@cuda
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_spatial_capture_matches_plain(cuda_device, kernel, order):
    from realisticaudioraytracing2d_tpu_torch import spatial as sp
    scene, params = _setup(cuda_device)
    kw = dict(n_rays=15000, max_bounces=5, n_frames=1, order=order, **KW)
    if kernel == "K3":
        draws = dict(uniforms=rng.philox_uniforms(3, 1, 5, 15000,
                                                  cuda_device))
        counter = bk.trace_frames_ir_whole
    else:
        draws = dict(seed=3)
        counter = bk.trace_frames_ir_mega
    before = counter.launches
    got, st = sp.trace_spatial(scene, params, **draws, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    _, want = sp.trace_spatial(scene, params, backend="plain", **draws, **kw)
    n = 3 if order == 1 else 5
    assert tuple(st.sum.shape) == (n, 72000, 1) and got.order == order
    for row in range(n):
        _assert_close_irs(st.sum[row], want.sum[row])


@cuda
@pytest.mark.parametrize("n_bands", [1, 8])
def test_spatial_capture_on_a_city_matches_plain(cuda_device, n_bands):
    from realisticaudioraytracing2d_tpu_torch import spatial as sp
    scene, params = _city(cuda_device, 2500, n_bands)
    counter = ak.trace_frames_ir_accel_sorted if n_bands == 1 \
        else ak.trace_frames_ir_accel
    kw = dict(n_rays=4096, max_bounces=5, sample_rate=16000,
              ir_length=24000)
    before = _launch_counts()
    k = counter.launches
    _, st = sp.trace_spatial(scene, params, 2, **kw)
    torch.cuda.synchronize()
    assert counter.launches == k + 5
    after = _launch_counts()
    assert after[:2] == before[:2]                   # no K3 / K4
    want = ak.trace_frames_ir_accel_sorted_plain(
        scene, sp.spatial_params(params), 2, 1, **kw)
    assert tuple(st.sum.shape) == (3, 24000, n_bands)
    for row in range(3):
        _assert_close_irs(st.sum[row], want[row])


@cuda
def test_binaural_stream_matches_plain(cuda_device):
    room = rooms.smoll_room(device=cuda_device)
    cfg = art.smoll_room_config()
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    dry = _click(cuda_device)
    runs = {}
    for backend in ("auto", "plain"):
        k4, k2 = bk.trace_frames_ir_mega.launches, tk.occlusion_min.launches
        runs[backend] = _binaural_run(room.scene, cfg, p, dry, 4, seed=5,
                                      diffraction=1, backend=backend)
        assert bk.trace_frames_ir_mega.launches - k4 == (
            4 if backend == "auto" else 0)
        assert tk.occlusion_min.launches - k2 == (
            4 if backend == "auto" else 0)
    (got, irs_k), (want, irs_p) = runs["auto"], runs["plain"]
    assert tuple(got.shape) == (2, 4 * 4800)
    w_max = max(float(ir.abs().max()) for ir in irs_p)
    d_ir = 0.0
    for a, b in zip(irs_k, irs_p):
        assert tuple(a.shape) == (2, 72000, 1)
        d_ir = max(d_ir, float((a - b).abs().max()))
    assert d_ir <= _decode_limit(w_max, 72000) + 1e-6 * w_max
    g, w = to_numpy(got), to_numpy(want)
    assert np.abs(w).max() > 0 and not np.allclose(w[0], w[1])
    np.testing.assert_allclose(
        g, w, rtol=1e-4,
        atol=2e-6 * np.abs(w).max() + float(dry.abs().sum()) * d_ir)


@cuda
def test_binaural_degenerate_head_equals_mono_within_the_fixed_point(
        cuda_device):
    """Radius 0 and shadow 0: each ear is the W row of the capture. K4
    bins the capture at the scale S3 of its loudest microphone (gain 2),
    the mono trace at S1, each hit rounded to half a step: a bin of W
    differs from the mono bin by at most hits * (0.5 / S1 + 0.5 / S3),
    with ``hits`` = R * 2B per frame at most, plus float32 roundings of
    the two conversions and of the decode's ``coh + (W - coh)`` (3 ulps
    of W). The audio, a sum of ``|dry|``-weighted bins, within that times
    ``sum |dry|`` plus 2e-6 of the peak (the JAX test's limit)."""
    from realisticaudioraytracing2d_tpu_torch import spatial as sp
    room = rooms.smoll_room(device=cuda_device)
    cfg = art.smoll_room_config()
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    dry = _click(cuda_device)
    mono_irs = []
    mono = to_numpy(art.Streamer(room.scene, cfg, seed=2).stream_clip(
        dry, lambda i: p, total_chunks=6,
        on_chunk=lambda i, st: mono_irs.append(st.prev_ir.clone())))[0]
    ears, _ = _binaural_run(room.scene, cfg, p, dry, 6, seed=2,
                            head_radius=0.0, shadow=0.0)
    ears = to_numpy(ears)
    s1 = float(bk.fixed_point_scale(p, 1, 15000, 5))
    s3 = float(bk.fixed_point_scale(sp.spatial_params(p), 1, 15000, 5))
    assert s3 == s1 / 2                 # the cardioids' gain bound of 2
    w_max = max(float(ir.max()) for ir in mono_irs)
    per_bin = 15000 * 2 * 5 * (0.5 / s1 + 0.5 / s3) + 3 * 2.0 ** -24 * w_max
    limit = 2e-6 * np.abs(mono).max() + float(dry.abs().sum()) * per_bin
    assert np.abs(mono).max() > 0
    for ear in ears:
        np.testing.assert_allclose(ear, mono, rtol=0, atol=limit)


@cuda
def test_binaural_stream_and_decode_are_reproducible(cuda_device):
    from realisticaudioraytracing2d_tpu_torch import spatial as sp
    room = rooms.smoll_room(device=cuda_device)
    cfg = art.smoll_room_config()
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    dry = _click(cuda_device)
    a, irs_a = _binaural_run(room.scene, cfg, p, dry, 3, seed=8)
    b, irs_b = _binaural_run(room.scene, cfg, p, dry, 3, seed=8)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(irs_a, irs_b))
    _, st = sp.trace_spatial(room.scene, p, 8, n_rays=15000, max_bounces=5,
                             **KW)
    cap = st.normalized()
    first = sp.binaural_decode_ir(cap, 48000, 0.4, 0.0875, 0.6,
                                  p.speed_of_sound)
    again = sp.binaural_decode_ir(cap, 48000, 0.4, 0.0875, 0.6,
                                  p.speed_of_sound)
    assert torch.equal(first, again) and float(first.abs().sum()) > 0


@cuda
def test_binaural_city_stream_runs_through_k8(cuda_device):
    scene, params = _city(cuda_device, 2500)
    cfg = art.EngineConfig(sim=art.SimConfig(ray_count=4096, max_bounces=5,
                                             listener_radius=2.0,
                                             input_gain=100.0))
    dry = _click(cuda_device, 9600, (100,))
    before = _launch_counts()
    out, irs = _binaural_run(scene, cfg, params, dry, 3, seed=1)
    after = _launch_counts()
    assert after[3] - before[3] == 3 * 5            # K8, one per bounce
    assert after[:3] == before[:3]                  # no K3, K4, K7
    assert tuple(out.shape) == (2, 3 * 4800) and len(irs) == 3
    assert bool(torch.isfinite(out).all())


# --- per-arrival and shared-rate Doppler -------------------------------------
#
# A per-arrival stream through K4 against its plain twin (on the card, and
# on the CPU: the plain trace draws the same Philox numbers from the seed)
# must pick the same tap bins in every chunk; its audio then differs only
# through the IRs, within _per_arrival_limit (chip_smoke.py::
# per_arrival_limit states the derivation): sum |dry| times the residual
# gap, plus each tap bin's gain gap times max |dry| over the current and
# fading taps (a binaural ear tap's gain and ITD come from its W/X/Y
# window), plus 2e-6 of the peak for the FFTs. On the card the plain twin's
# IRs are K4's up to the fixed point's rounding; the CPU's differ by the
# few rays a frame whose paths part at a razor edge where the CPU's and
# the card's cos/sin round an ulp apart (22-34 of 72,000 bins at 15,000 x
# 5 on an H100, ROADMAP section 3), which the measured gaps carry.


def _per_arrival_limit(peak, dry, d_res, d_tap, n_taps=6, n_bands=1,
                       max_shift=None, shadow=0.6):
    per_bin = d_tap if max_shift is None else (
        8.0 + 4.0 * (1.0 + shadow) * max_shift) * d_tap
    return (2e-6 * peak + float(dry.abs().sum()) * d_res
            + 2 * n_taps * 3 * n_bands * float(dry.abs().max()) * per_bin)


def _per_arrival_run(device, binaural, backend="auto", n_chunks=4):
    """A per-arrival stream of clicks on SmollRoom at full width, the
    source approaching at 2 m/s, and its every chunk's IR and carry."""
    room = rooms.smoll_room(device=device)
    cfg = art.smoll_room_config()
    eng = art.Engine(room.scene, cfg)
    src = np.float32(room.source)
    lis = np.float32(room.listener)
    toward = (lis - src) / np.linalg.norm(lis - src)
    seen = []
    out = art.Streamer(room.scene, cfg, seed=9, backend=backend,
                       binaural=binaural).stream_clip(
        _click(device), lambda i: eng.params(
            src + np.float32(toward * 0.2 * i), lis),
        total_chunks=n_chunks, doppler="per_arrival",
        facing_fn=(lambda i: 0.4 - 0.1 * i) if binaural else None,
        on_chunk=lambda i, st: seen.append(
            [st.prev_ir.clone()] + [x.clone()
                                    for x in st.arrival.tensors()]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, seen


@cuda
@pytest.mark.parametrize("binaural", [False, True])
def test_per_arrival_stream_matches_plain_and_cpu(cuda_device, binaural):
    before = bk.trace_frames_ir_mega.launches
    got, seen = _per_arrival_run(cuda_device, binaural)
    assert bk.trace_frames_ir_mega.launches - before == 4    # one a chunk
    again, _ = _per_arrival_run(cuda_device, binaural)
    assert torch.equal(got, again)
    dry = _click(cuda_device)
    live = sum(int(s[4].sum()) for s in seen)
    assert live > 0 and bool(torch.isfinite(got).all())
    for twin_device, backend in ((cuda_device, "plain"),
                                 (torch.device("cpu"), "auto")):
        want, seen_w = _per_arrival_run(twin_device, binaural, backend)
        d_res = d_tap = 0.0
        for a, b in zip(seen, seen_w):
            b = [x.to(cuda_device) for x in b]
            assert torch.equal(a[2], b[2]) and torch.equal(a[4], b[4])
            d_res = max(d_res, float((a[1] - b[1]).abs().max()))
            d_tap = max([d_tap] + [float((x - y).abs().max()) for x, y in
                                   zip(a[3:], b[3:])
                                   if x.dtype == torch.float32])
        g, w = to_numpy(got), to_numpy(want)
        assert g.shape == w.shape == ((2 if binaural else 1), 4 * 4800)
        if binaural and twin_device.type == "cuda":
            # the same capture up to the kernel's rounding: the decode moves
            # a deposit at most a target-bin spacing
            w_max = max(float(s[1].abs().max()) for s in seen_w)
            assert d_res <= _decode_limit(w_max, 72000) + 1e-6 * w_max
        limit = _per_arrival_limit(
            np.abs(w).max(), dry, d_res, d_tap,
            max_shift=(0.0875 / 343.0 * 48000) if binaural else None)
        gap = float(np.abs(g - w).max())
        assert gap <= limit, (twin_device.type, backend, gap, limit, d_res,
                              d_tap)


@cuda
def test_doppler_feed_stream_on_the_card_matches_cpu(cuda_device):
    # the shared-rate feed rounds once from float64 on either device, so
    # the warped dry is the CPU's bit for bit; the stream then differs by
    # the IRs' rounding only
    outs, irs = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        room = rooms.smoll_room(device=dev)
        cfg = art.smoll_room_config()
        eng = art.Engine(room.scene, cfg)
        dry = torch.from_numpy(np.sin(np.arange(19200) * 0.05).astype(
            np.float32)).to(dev)
        src = np.float32(room.source)
        poses = lambda i: eng.params(src - np.float32([3.0 * i, 0.0]),  # noqa
                                     room.listener)
        feed = art.streaming.DopplerFeed(dry, poses, 4800, 48000, 4, False)
        outs[dev.type] = [to_numpy(feed.chunk(i)) for i in range(4)]
        seen = []
        k4 = bk.trace_frames_ir_mega.launches
        irs[dev.type] = (to_numpy(art.Streamer(room.scene, cfg, seed=4)
                                  .stream_clip(dry, poses, total_chunks=4,
                                               doppler=True,
                                               on_chunk=lambda i, st:
                                               seen.append(st.prev_ir
                                                           .clone()))),
                         seen, dry)
        if dev.type == "cuda":
            assert bk.trace_frames_ir_mega.launches - k4 == 4
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(a, b)
    (g, irs_g, dry), (w, irs_w, _) = irs["cuda"], irs["cpu"]
    d_ir = max(float((a.cpu() - b).abs().max()) for a, b in zip(irs_g, irs_w))
    np.testing.assert_allclose(
        g, w, rtol=0,
        atol=2e-6 * np.abs(w).max() + float(dry.abs().sum()) * d_ir)


# ---- the live pipeline on the card -------------------------------------------


def _live_setup(device, binaural=False):
    room = rooms.smoll_room(device=device)
    cfg = art.smoll_room_config()
    eng = art.Engine(room.scene, cfg)
    src = np.float32(room.source)
    dry = torch.zeros(48000, device=device)
    dry[[4800, 28800]] = 1.0                    # clicks at 0.1 s, 0.6 s
    return room, cfg, dry, lambda i: eng.params(
        src + np.float32([0.2 * i, 0.0]), room.listener)


@cuda
@pytest.mark.parametrize("mode", ["mono", "binaural", "per_arrival"])
def test_live_player_on_the_card_equals_its_stream(cuda_device, mode):
    # integrity mode: the audio thread hears the card's stream of the same
    # seed (the producer adds wet chunk and taps in the stream's order)
    from realisticaudioraytracing2d_tpu_torch.live import LivePlayer
    binaural = mode == "binaural"
    room, cfg, dry, poses = _live_setup(cuda_device)
    kw = dict(binaural=binaural)
    run = dict(params_fn=poses, doppler=(mode == "per_arrival" and
                                         "per_arrival"),
               facing_fn=(lambda i: 0.3 * i) if binaural else None)
    k4 = bk.trace_frames_ir_mega.launches
    rep = LivePlayer(room.scene, cfg, seed=5, **kw).run(
        dry, total_chunks=8, loop=False, **run)
    assert bk.trace_frames_ir_mega.launches - k4 == 8     # one a chunk
    want = to_numpy(art.Streamer(room.scene, cfg, seed=5, **kw).stream_clip(
        dry, loop=False, total_chunks=8, **run))
    assert rep.underruns == 0 and rep.chunks == 8
    assert rep.audio.shape == want.shape == (2 if binaural else 1, 8 * 4800)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(rep.audio, want, rtol=0, atol=1e-6)


@cuda
def test_pose_feed_moves_a_wall_on_the_card(cuda_device, tmp_path):
    from realisticaudioraytracing2d_tpu_torch.live import LivePlayer
    from realisticaudioraytracing2d_tpu_torch.posefeed import PoseFeed
    room, cfg, _, poses = _live_setup(cuda_device)
    # a dry signal in every chunk: each move changes the chunks after it
    dry = torch.from_numpy(np.random.default_rng(6).normal(
        size=48000).astype(np.float32) * 0.3).to(cuda_device)
    path = tmp_path / "feed.jsonl"
    path.write_text(json.dumps({"chunk": 2, "obstacle": "Wall (4)",
                                "position": [-9.0, 5.0], "angle": 0.2})
                    + "\n" + json.dumps({"chunk": 3, "source": [-15.0, 6.0]})
                    + "\n")
    feed = PoseFeed.open(str(path)).bind_scene(room.builder)
    moved = room.builder.move_collider(room.scene, "Wall (4)",
                                       position=(-9.0, 5.0), angle=0.2)
    assert moved.device == room.scene.device
    assert moved.n_walls == room.scene.n_walls

    def fed_params(i):
        p = feed.params(poses(i), i)
        assert p.source.device == room.scene.device
        return p

    got = LivePlayer(room.scene, cfg, seed=6).run(
        dry, total_chunks=6, loop=False, params_fn=fed_params,
        scene_fn=lambda i: feed.scene(room.scene, i))
    want = LivePlayer(room.scene, cfg, seed=6).run(
        dry, total_chunks=6, loop=False,
        params_fn=lambda i: poses(i)._replace(
            source=torch.tensor([-15.0, 6.0], device=cuda_device))
        if i >= 3 else poses(i),
        scene_fn=lambda i: moved if i >= 2 else room.scene)
    np.testing.assert_array_equal(got.audio, want.audio)
    plain = LivePlayer(room.scene, cfg, seed=6).run(
        dry, total_chunks=6, loop=False, params_fn=poses)
    assert not np.array_equal(got.audio, plain.audio)


@cuda
def test_live_realtime_from_a_cold_build_has_no_underruns(cuda_device,
                                                          tmp_path,
                                                          monkeypatch):
    # empty build directories: the player builds the CUDA kernels (nvcc)
    # and the native library (g++) before its threads start, so the audio
    # clock never waits on a compiler
    from realisticaudioraytracing2d_tpu_torch import native
    from realisticaudioraytracing2d_tpu_torch.live import LivePlayer
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    build.load_library.cache_clear()
    try:
        room, cfg, dry, poses = _live_setup(cuda_device)
        player = LivePlayer(room.scene, cfg, seed=7)
        assert build.library_path().exists() and native.available()
        assert native.library_path().parent == tmp_path / "torch_native"
        rep = player.run(dry, total_chunks=20, loop=True, realtime=True,
                         prime=1, params_fn=poses)
    finally:
        build.load_library.cache_clear()
    assert rep.chunks == 20 and rep.audio.shape == (1, 20 * 4800)
    assert rep.underruns == 0, rep.summary()
    assert rep.realtime_factor > 1.0


# -- differentiable acoustics (diff.py) --------------------------------------
#
# The differentiable forward is the plain trace under autograd on the card
# (the hand kernels have no backward, as in the JAX package). Fixtures are
# tests/test_diff.py's (built by the port: this file imports no JAX).

def _shoebox(device, absorption=0.3, scattering=0.4, divider=None,
             source=(-1.0, 0.0), listeners=(1.0, 0.3), radius=0.5):
    from realisticaudioraytracing2d_tpu_torch.models.materials import \
        AudioMaterial
    from realisticaudioraytracing2d_tpu_torch.models.scene import Transform2D
    obstacles = None
    if divider is not None:
        obstacles = [(Transform2D((0.0, 0.0), 0.0, (0.2, 3.0)),
                      AudioMaterial(absorption=0.1, scattering=0.0,
                                    transmission=divider))]
        source, listeners = (-1.2, 0.0), (1.2, 0.2)
    scene = rooms.shoebox_room(
        4.0, 4.0, wall_material=AudioMaterial(absorption=absorption,
                                              scattering=scattering
                                              if divider is None else 0.2),
        obstacles=obstacles, device=device)
    return scene, TraceParams.make(source, listeners, listener_radius=radius,
                                   device=device)


DIFF_KW = dict(max_bounces=4, sample_rate=8000, ir_length=512)


@cuda
def test_diff_smollroom_gradient_on_the_card(cuda_device):
    """SmollRoom's scattering and absorption gradients are finite and
    nonzero on the card (JAX's ``test_scattering_gradient_finite_on_
    refractive_scene`` at 4,096 rays and 2,048 bins), and the card's
    value and gradients agree with the CPU's on the same Philox draws
    within what a few razor-edge rays explain (ROADMAP section 3: the
    plain trace on the CPU and on the card): value rtol 1e-2, gradients
    within 10% of the largest."""
    from realisticaudioraytracing2d_tpu_torch import diff
    out = {}
    for where, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        scene, p = _setup(dev)
        groups, n_groups = diff.infer_material_groups(scene)
        mp = diff.MaterialParams(*(
            x.requires_grad_(True)
            for x in diff.MaterialParams.from_scene(scene, groups,
                                                    n_groups)))
        sc = diff.apply_materials(scene, groups, mp,
                                  ("absorption", "scattering"))
        pred = diff.simulate_ir(sc, p, 3, n_rays=4096, max_bounces=5,
                                sample_rate=8000, ir_length=2048,
                                device=dev)
        value = torch.sum(pred)
        value.backward()
        out[where] = (float(value.detach()),
                         to_numpy(mp.absorption.grad).ravel(),
                         to_numpy(mp.scattering.grad))
    for v, ga, gs in out.values():
        assert v > 0 and np.isfinite(ga).all() and np.isfinite(gs).all()
        assert np.abs(gs).max() > 0 and np.abs(ga).max() > 0
    (vc, gac, gsc), (vh, gah, gsh) = out["card"], out["cpu"]
    np.testing.assert_allclose(vc, vh, rtol=1e-2)
    for g, h in ((gac, gah), (gsc, gsh)):
        assert np.abs(g - h).max() <= 0.1 * np.abs(h).max(), (g, h)


@cuda
def test_diff_gradient_matches_central_difference_on_the_card(cuda_device):
    """JAX's ``test_gradient_matches_central_difference`` on the card:
    absorption's autograd gradient within rtol 5e-2 of a central
    difference of the card's own forward."""
    from realisticaudioraytracing2d_tpu_torch import diff
    scene, p = _shoebox(cuda_device)
    groups, n_groups = diff.infer_material_groups(scene)
    mp0 = diff.MaterialParams.from_scene(scene, groups, n_groups)

    def loss_at(delta):
        mp = mp0._replace(absorption=mp0.absorption + delta)
        return torch.sum(diff.simulate_ir(
            diff.apply_materials(scene, groups, mp), p, 0, n_rays=64,
            device=cuda_device, **DIFF_KW))

    delta = torch.zeros_like(mp0.absorption, requires_grad=True)
    loss_at(delta).backward()
    eps, checked = 1e-3, 0
    with torch.no_grad():
        for gi in range(n_groups):
            e = torch.zeros_like(mp0.absorption)
            e[gi] = eps
            fd = float(loss_at(e) - loss_at(-e)) / (2 * eps)
            ad = float(delta.grad[gi].sum())
            if abs(fd) < 1e-7 and abs(ad) < 1e-7:
                continue
            np.testing.assert_allclose(ad, fd, rtol=5e-2)
            checked += 1
    assert checked >= 1


@cuda
def test_diff_fits_on_the_card_rerun_bit_identical(cuda_device):
    """JAX's ``test_fit_recovers_absorption`` on the card, and two
    identical fits give the same losses and logits bit for bit: the
    splats' deterministic accumulate and their gather backward, hard
    (absorption) and soft (ior, blurred loss)."""
    from realisticaudioraytracing2d_tpu_torch import diff
    true_scene, p = _shoebox(cuda_device, absorption=0.45)
    target = diff.simulate_ir(true_scene, p, 7, n_rays=64, frames=4,
                              device=cuda_device, **DIFF_KW)
    start, _ = _shoebox(cuda_device, absorption=0.12)
    kw = dict(n_rays=64, max_bounces=4, sample_rate=8000, frames=1,
              fields=("absorption",), loss="edc", steps=60, lr=0.1,
              device=cuda_device)
    runs = [diff.fit_materials(start, p, target, 0, **kw) for _ in range(2)]
    assert torch.equal(runs[0].losses, runs[1].losses)
    assert torch.equal(runs[0].params.absorption, runs[1].params.absorption)
    losses = to_numpy(runs[0].losses)
    assert losses[-10:].mean() < 0.65 * losses[:10].mean(), losses
    groups, _ = diff.infer_material_groups(start)
    fitted = to_numpy(torch.sigmoid(runs[0].params.absorption))
    assert abs(float(fitted[int(groups[0]), 0]) - 0.45) < 0.08, fitted
    soft = [diff.fit_materials(start, p, target, 0, n_rays=64,
                               max_bounces=4, sample_rate=8000,
                               fields=("ior", "absorption"), loss="blur",
                               soft=True, steps=10, lr=0.1,
                               device=cuda_device) for _ in range(2)]
    assert torch.equal(soft[0].losses, soft[1].losses)
    assert torch.isfinite(soft[0].losses).all()


@cuda
@pytest.mark.parametrize("room_fn", [rooms.smoll_room, "divider"])
def test_surrogate_trace_with_kernels_equals_plain_on_the_card(cuda_device,
                                                               room_fn):
    """``trace(use_kernels=True, transmission_surrogate=True)``: K1/K2 do
    the two wall passes and the branch stays tensor code; the hits equal
    the plain surrogate trace's bit for bit (SmollRoom's transmissive
    slant wall; the divider at t = 0.5), and with every transmission 0
    the surrogate equals the hard trace."""
    if room_fn == "divider":
        scene, p = _shoebox(cuda_device, divider=0.5)
    else:
        scene, p = _setup(cuda_device)
    emit, u = rng.philox_uniforms(4, 1, 5, 15000, device=cuda_device)
    tk.nearest_hit.launches = tk.occlusion_min.launches = 0
    with_k = tt.trace_hits_only(scene, p, emit[0], u[0], use_kernels=True,
                                transmission_surrogate=True)
    torch.cuda.synchronize()
    assert (tk.nearest_hit.launches, tk.occlusion_min.launches) == (5, 5)
    plain = tt.trace_hits_only(scene, p, emit[0], u[0],
                               transmission_surrogate=True)
    assert bool(plain.valid.any())
    for a, b in zip(with_k, plain):
        assert torch.equal(a, b)
    opaque = scene._replace(transmission=torch.zeros_like(
        scene.transmission))
    hard = tt.trace_hits_only(opaque, p, emit[0], u[0], use_kernels=True)
    surr = tt.trace_hits_only(opaque, p, emit[0], u[0], use_kernels=True,
                              transmission_surrogate=True)
    assert all(torch.equal(a, b) for a, b in zip(hard, surr))


@cuda
def test_gaussian_blur_on_the_card_is_full_float32(cuda_device):
    """The blur sums in float64 and rounds once, never TF32: the card
    equals the CPU within 1e-7 of the largest value at 72,000 bins (a
    TF32 convolution would be ~1e-3 off)."""
    from realisticaudioraytracing2d_tpu_torch import diff
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 72000, 1), dtype=np.float32))
    assert torch.backends.cudnn.allow_tf32 in (True, False)
    for sigma in (0.5, 4.0, 24.0):
        got = to_numpy(diff.gaussian_blur_time(x.to(cuda_device), sigma))
        want = to_numpy(diff.gaussian_blur_time(x, sigma))
        assert np.abs(got - want).max() <= 1e-7 * np.abs(want).max()


@cuda
def test_transmission_gradient_and_fit_on_the_card(cuda_device):
    """JAX's ``test_transmission_gradient_matches_fd_of_hard_expectation``
    (the surrogate's d(total energy)/d(transmission) against central
    differences of the hard forward's expectation, each over 6 seeds of
    8 frames x 512 rays: within 25%) and ``test_fit_recovers_
    transmission`` (from 0.15 to the hard target's 0.6 within 0.15, 200
    steps) on the card: past the CPU tests' budget."""
    from realisticaudioraytracing2d_tpu_torch import diff
    scene, p = _shoebox(cuda_device, divider=0.5)
    groups, n_groups = diff.infer_material_groups(scene)
    mask = to_numpy(scene.mask) & (to_numpy(scene.transmission) > 0)
    div = int(groups[mask][0])
    mp0 = diff.MaterialParams.from_scene(scene, groups, n_groups)

    def grad_dt(seed):
        tr = torch.tensor(0.5, device=cuda_device, requires_grad=True)
        logits = mp0.transmission.clone()
        logits[div] = 0.0
        logits = logits + torch.nn.functional.one_hot(
            torch.tensor(div), n_groups).to(cuda_device) * (
            torch.log(tr) - torch.log1p(-tr))
        fitted = diff.apply_materials(scene, groups, mp0._replace(
            transmission=logits), ("transmission",))
        torch.sum(diff.simulate_ir(fitted, p, seed, n_rays=512, frames=8,
                                   transmission_surrogate=True,
                                   device=cuda_device, **DIFF_KW)).backward()
        return float(tr.grad)

    g = np.mean([grad_dt(i) for i in range(6)])

    def hard_energy(t, seed):
        sc, _ = _shoebox(cuda_device, divider=t)
        return float(diff.simulate_ir(sc, p, seed, n_rays=512, frames=8,
                                      device=cuda_device, **DIFF_KW).sum())

    fd = np.mean([(hard_energy(0.6, 100 + i) - hard_energy(0.4, 100 + i))
                  / 0.2 for i in range(6)])
    assert fd > 0 and g > 0
    assert abs(g - fd) / fd < 0.25, (g, fd)
    true_scene, _ = _shoebox(cuda_device, divider=0.6)
    target = diff.simulate_ir(true_scene, p, 7, n_rays=256, frames=4,
                              device=cuda_device, **DIFF_KW)
    start, _ = _shoebox(cuda_device, divider=0.15)
    result = diff.fit_materials(start, p, target, 0, n_rays=256,
                                max_bounces=4, sample_rate=8000, frames=1,
                                fields=("transmission",), loss="edc",
                                steps=200, lr=0.1, device=cuda_device)
    fit_t = float(torch.sigmoid(result.params.transmission)[div])
    assert abs(fit_t - 0.6) < 0.15, fit_t


@cuda
def test_localize_two_simultaneous_sources_on_the_card(cuda_device):
    """JAX's ``test_localize_two_simultaneous_sources`` on the card: two
    sources emitting at once, recovered jointly from one mixed IR at two
    microphones (permutation-invariant error under 0.15 m)."""
    from realisticaudioraytracing2d_tpu_torch import diff
    scene, _ = _shoebox(cuda_device)
    p = TraceParams.make((0.0, 0.0), [(1.2, 0.8), (-1.2, -0.9)],
                         listener_radius=0.4, device=cuda_device)
    true = torch.tensor([[-1.0, 0.4], [0.9, -1.1]], device=cuda_device)
    target = sum(diff.simulate_ir(scene, p._replace(source=true[j]),
                                  rng.mix_seed(0, j), n_rays=256, soft=True,
                                  device=cuda_device, **DIFF_KW)
                 for j in range(2))
    result = diff.localize_source(
        scene, p, target, 0, n_rays=256, max_bounces=4, sample_rate=8000,
        n_sources=2, n_starts=12, steps=200, anneal_steps=30.0,
        bounds=np.array([[-1.6, -1.6], [1.6, 1.6]], np.float32),
        device=cuda_device)
    fitted = to_numpy(result.position)
    assert fitted.shape == (2, 2)
    tn = to_numpy(true)
    err = min(np.linalg.norm(fitted - tn, axis=1).mean(),
              np.linalg.norm(fitted[::-1] - tn, axis=1).mean())
    assert err < 0.15, (fitted, err, to_numpy(result.losses))


# -- the device-mesh paths ----------------------------------------------------

def _virtual_mesh(device, shape, names=("rooms",)):
    from realisticaudioraytracing2d_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(shape, names, devices=[device] * int(np.prod(shape)))


@cuda
@pytest.mark.parametrize("n_bands", [1, 8, 40])
def test_k4_frame_offset_and_entry_draw_their_philox_numbers(cuda_device,
                                                             n_bands):
    """K4's ``frame_offset`` moves only the frames' Philox counter word:
    at 0 the launch keeps its bits (== K3 on frames 0 .. of the stream);
    at ``f`` (and any ``entry``) it equals K3 on the uniforms of frames
    ``f ..`` bit for bit and its plain version within the limits above,
    in the register buckets and the scratch (40 bands)."""
    scene, params = _setup(cuda_device, n_bands=n_bands)
    kw = dict(n_rays=15000, max_bounces=5, **KW)
    plain0 = bk.trace_frames_ir_mega(scene, params, 21, 2, **kw)
    assert torch.equal(plain0, bk.trace_frames_ir_mega(
        scene, params, 21, 2, frame_offset=0, entry=0, **kw))
    for f, e in ((0, 0), (5, 0), (3, 3)):
        before = bk.trace_frames_ir_mega.launches
        k4 = bk.trace_frames_ir_mega(scene, params, 21, 2, entry=e,
                                     frame_offset=f, **kw)
        assert bk.trace_frames_ir_mega.launches == before + 1
        emit, u = rng.philox_uniforms(21, 2, 5, 15000, cuda_device, entry=e,
                                      first_frame=f)
        k3 = bk.trace_frames_ir_whole(scene, params, emit, u, **KW)
        torch.cuda.synchronize()
        assert torch.equal(k4, k3), (f, e)
        _assert_close_irs(k4, bk.trace_frames_ir_mega_plain(
            scene, params, 21, 2, entry=e, frame_offset=f, **kw))
    assert not torch.equal(plain0, k4)


@cuda
def test_sharded_paths_on_a_virtual_mesh_of_the_card(cuda_device):
    """The sweep over 4 shards == the unsharded sweep bit for bit (4 K9
    launches); the frame-sharded run == the unsharded K4 within the fixed
    point (a bin of n deposits moves by at most n / S); the ray-sharded
    trace's shard 0 is K4 at its rays, entry 0; the mixdown over 4 shards
    (4 K9 launches) equals the unsharded one within the float sum."""
    from realisticaudioraytracing2d_tpu_torch.parallel import (
        frames, multisource, rays)
    from realisticaudioraytracing2d_tpu_torch.parallel.sweep import \
        sweep_rooms_sharded
    scenes, src, lis = rooms.random_rooms(64, seed=0, device=cuda_device)
    kw = dict(n_rays=15000, max_bounces=5, **KW)
    m4 = _virtual_mesh(cuda_device, (4,))
    before = bk.trace_rooms_ir_mega.launches
    swept = sweep_rooms_sharded(scenes, src, lis, 3, m4, n_frames=2, **kw)
    assert bk.trace_rooms_ir_mega.launches == before + 4
    assert torch.equal(swept, sweep_rooms(scenes, src, lis, 3, n_frames=2,
                                          **kw))
    scene, params = _setup(cuda_device)
    st = art.IRState.zeros(72000, device=cuda_device)
    sh = frames.accumulate_frames_sharded(scene, params, st, 7, m4,
                                          n_frames=8, n_rays=15000,
                                          max_bounces=5, sample_rate=48000)
    un = bk.trace_frames_ir_mega(scene, params, 7, 8, **kw)
    res = 1.0 / float(bk.fixed_point_scale(params, 8, 15000, 5))
    limit = 8 * 15000 * 2 * 5 * res + 1e-6 * un.abs()
    assert sh.frames == 8 and bool(((sh.sum - un).abs() <= limit).all())
    m8 = _virtual_mesh(cuda_device, (1, 8), ("rooms", "rays"))
    before = bk.trace_frames_ir_mega.launches
    ray_ir = rays.trace_rays_sharded(scene, params, 5, m8, n_rays=16384,
                                     max_bounces=5, **KW)
    assert bk.trace_frames_ir_mega.launches == before + 8
    shard0 = bk.trace_frames_ir_mega(scene, params, 5, 1, n_rays=2048,
                                     max_bounces=5, **KW)
    parts = [bk.trace_frames_ir_mega(scene, params, 5, 1, n_rays=2048,
                                     max_bounces=5, entry=d, **KW)
             for d in range(8)]
    assert torch.equal(parts[0], shard0)
    assert torch.equal(ray_ir, sum(parts[1:], parts[0]))
    _, src8, lis8, _ = _mixdown_batch(cuda_device)
    m_src = _virtual_mesh(cuda_device, (1, 4), ("rooms", "rays"))
    room = rooms.smoll_room(device=cuda_device)
    p = TraceParams.make(src8, lis8[0], device=cuda_device)
    before = bk.trace_rooms_ir_mega.launches
    mixed = multisource.trace_sources_mixdown_sharded(room.scene, p, 9,
                                                      m_src, **kw)
    assert bk.trace_rooms_ir_mega.launches == before + 4
    whole = trace_sources_mixdown(room.scene, p, 9, **kw)
    torch.cuda.synchronize()
    assert float(whole.sum()) > 0
    np.testing.assert_allclose(to_numpy(mixed), to_numpy(whole), rtol=1e-5,
                               atol=1e-9)


# -- frame offsets in the cluster kernels ------------------------------------

@cuda
def test_k7_k8_at_a_frame_offset_are_k4_at_it_on_a_sorted_city(cuda_device):
    """K8 and K7 at one band (K8's instantiation) on the Morton-sorted
    4,808-wall city equal K4 on the sorted table at the same
    ``frame_offset`` bit for bit, at 0 (the calls without an offset) and
    at 5 (the frames 5, 6, 7 of the stream: K3 on those rows)."""
    scene, params = _city(cuda_device, 1200)
    sorted_scene = ak.prepare(scene).scene
    assert sorted_scene.n_walls <= bk.MAX_WALLS
    for f in (0, 5):
        k4 = bk.trace_frames_ir_mega(sorted_scene, params, 8, 3,
                                     frame_offset=f, **ACCEL_KW)
        before = _launch_counts()
        k8 = ak.trace_frames_ir_accel_sorted(scene, params, 8, 3,
                                             frame_offset=f, **ACCEL_KW)
        k7 = ak.trace_frames_ir_accel(scene, params, 8, 3, frame_offset=f,
                                      **ACCEL_KW)
        assert _launch_counts()[3] == before[3] + 2 * 5
        torch.cuda.synchronize()
        assert float(k4.sum()) > 0, f
        assert torch.equal(k8, k4) and torch.equal(k7, k4), f
    emit, u = rng.philox_uniforms(8, 3, 5, ACCEL_KW["n_rays"], cuda_device,
                                  first_frame=5)
    k3 = bk.trace_frames_ir_whole(sorted_scene, params, emit, u,
                                  sample_rate=ACCEL_KW["sample_rate"],
                                  ir_length=ACCEL_KW["ir_length"])
    torch.cuda.synchronize()
    assert torch.equal(k8, k3)
    assert torch.equal(ak.trace_frames_ir_accel_sorted(
        scene, params, 8, 3, **ACCEL_KW), ak.trace_frames_ir_accel_sorted(
        scene, params, 8, 3, frame_offset=0, **ACCEL_KW))


@cuda
@pytest.mark.parametrize("kernel,n_bands", [("K8", 1), ("K7", 8)])
def test_cluster_kernels_at_a_frame_offset_match_plain(cuda_device, kernel,
                                                       n_bands):
    """K8 and the 8-band K7 at ``frame_offset=5`` on the 10,008-wall city
    against their plain twin at the same offset (the limits above)."""
    scene, params = _city(cuda_device, 2500, n_bands)
    fn = (ak.trace_frames_ir_accel if kernel == "K7"
          else ak.trace_frames_ir_accel_sorted)
    got = fn(scene, params, 21, 2, frame_offset=5, **ACCEL_KW)
    want = ak.trace_frames_ir_accel_sorted_plain(scene, params, 21, 2,
                                                 frame_offset=5, **ACCEL_KW)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (1, ACCEL_KW["ir_length"], n_bands)
    for k in range(n_bands):
        _assert_close_irs(got[..., k], want[..., k])
    assert not torch.equal(got, fn(scene, params, 21, 2, **ACCEL_KW))


@cuda
def test_k7_passes_at_a_frame_offset_equal_one_pass(cuda_device,
                                                    monkeypatch):
    """K7's passes of frames (``frames_per_pass``) draw frames
    ``frame_offset + f0 ..``: 5 frames from offset 4 in passes of 2 equal
    the one-pass call bit for bit (the u64 accumulator sums either
    order)."""
    scene, params = _city(cuda_device, 300, 8)
    run = lambda: ak.trace_frames_ir_accel(  # noqa: E731
        scene, params, 3, 5, frame_offset=4, **ACCEL_KW)
    one = run()
    monkeypatch.setattr(bk, "SCRATCH_FLOATS",
                        2 * 2 * ACCEL_KW["n_rays"] * ak.energy_rows(8))
    assert ak.frames_per_pass(8, 5, ACCEL_KW["n_rays"]) == 2
    before = ak.trace_frames_ir_accel.launches
    passes = run()
    torch.cuda.synchronize()
    assert ak.trace_frames_ir_accel.launches - before == 3 * 5
    assert float(one.sum()) > 0 and torch.equal(one, passes)


@cuda
def test_frames_sharded_on_a_city_past_the_wall_limit(cuda_device):
    """``accumulate_frames_sharded`` on the 10,008-wall city over a virtual
    4-shard mesh of the card: 4 K8 calls of ``max_bounces`` launches, no
    K4, within ``n / S`` (+ 1e-6 of the value) of the unsharded K8 call."""
    from realisticaudioraytracing2d_tpu_torch.parallel import frames
    scene, params = _city(cuda_device, 2500)
    assert scene.n_walls > bk.MAX_WALLS
    m4 = _virtual_mesh(cuda_device, (4,))
    st = art.IRState.zeros(ACCEL_KW["ir_length"], device=cuda_device)
    run = dict(n_rays=ACCEL_KW["n_rays"], max_bounces=5,
               sample_rate=ACCEL_KW["sample_rate"])
    before = _launch_counts()
    sh = frames.accumulate_frames_sharded(scene, params, st, 7, m4,
                                          n_frames=8, **run)
    assert _launch_counts() == (before[0], before[1], before[2],
                                before[3] + 4 * 5)
    un = ak.trace_frames_ir_accel_sorted(scene, params, 7, 8, **ACCEL_KW)
    res = 1.0 / float(bk.fixed_point_scale(params, 8, ACCEL_KW["n_rays"],
                                           5))
    limit = 8 * ACCEL_KW["n_rays"] * 2 * 5 * res + 1e-6 * un.abs()
    torch.cuda.synchronize()
    assert float(un.sum()) > 0
    assert sh.frames == 8 and bool(((sh.sum - un).abs() <= limit).all())


@cuda
def test_stream_spans_on_the_card_have_no_device_echo(cuda_device):
    """A traced stream chunk on the card records the port's spans on the
    host (K4's route and its argument preparation inside the retrace) and
    no device-side event of theirs: the card's trace holds only its
    kernels, copies and fills."""
    from torch.profiler import ProfilerActivity, profile
    scene, params = _setup(cuda_device)
    cfg = art.smoll_room_config()
    st = art.Streamer(scene, cfg, seed=1)
    dry = torch.rand(4800, device=cuda_device)
    st.process(dry, params)                   # build and warm outside
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_lead_in()
        st.process(dry, params)
        torch.cuda.synchronize()
    cuda_kind = torch.autograd.DeviceType.CUDA
    host = [e.name for e in prof.events() if e.name.startswith("art.")
            and e.device_type != cuda_kind]
    assert sorted(host) == sorted(
        ["art.stream.retrace", "art.trace.k4", "art.k4.prep",
         "art.stream.addenda", "art.stream.crossfade", "art.stream.ring"])
    assert not [e.name for e in prof.events()
                if e.device_type == cuda_kind and e.name.startswith("art.")]
    assert any("frames_ir_kernel" in e.name for e in prof.events()
               if e.device_type == cuda_kind)
