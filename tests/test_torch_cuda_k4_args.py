"""PyTorch port on the card: the single-scene launch's argument kernel
(``k4_args_kernel`` of ``csrc/k4_args_kernel.cu``, through
``ops/cuda/bounce_kernel.py::k4_args``) against its plain twin, the chain
of ``pack_walls_banded``, ``pack_scalars`` and ``fixed_point_scale``
(``k4_args_plain``), bit for bit: 1, 2 and 8 bands, 1, 4 and 64
listeners, omni and directive, a listener on the source, a zero gain,
bounds that are powers of two and bounds a few ulps above them (where
the scale's log2 decides the floor), non-float32 scalar inputs, and a
random sweep of poses; then what K3, K4 and K6 do with it: K4's IR at
the stream's shape keeps the bits of the commit before it, K3, K4 and K6
through the kernel equal their launch on the twin's arguments, one
argument launch per call (a listener-blocked launch too), no PyTorch
kernel beside it in a profiled call, and no call to the twin on the card.

Every test here needs an NVIDIA GPU and nvcc and skips elsewhere. This
file imports no JAX:

    python -m pytest tests/test_torch_cuda_k4_args.py -m cuda --noconftest
"""

import hashlib

import numpy as np
import pytest
import torch
from torch_parity import cuda, cuda_device, profiler_lead_in  # noqa: F401

from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams

# the shipped stream's trace: 15,000 rays x 5 bounces, 48 kHz, 72,000 bins
STREAM = dict(n_rays=15000, max_bounces=5, sample_rate=48000,
              ir_length=72000)
# K4's IR at STREAM over 2 frames of seed 42 on SmollRoom (its source and
# listener), built by the
# commit before the argument kernel (chip_smoke.py::PARENT_BITS, the same
# name): sha256 of its f32 bytes, first 16 hex digits
PARENT_K4_STREAM_BITS = "2da62d18303cafd5"
# (frames, rays, bounces) of the scale: the stream's, the bench's 8
# frames, and a hit count of 2^17
SHAPES = ((1, 15000, 5), (8, 131072, 8), (1, 16384, 4))


def _case(device, n_bands=1, n_listeners=1, directive=False, seed=0,
          gain=1.0, on_source=False):
    """SmollRoom with ``n_bands`` random absorption bands and
    ``n_listeners`` listeners drawn around the source from ``seed``
    (the first on the source with ``on_source``); directive: a cardioid
    source and figure-eight microphones, each listener aimed its own way
    when there are several."""
    room = rooms.smoll_room(n_bands=n_bands, device=device)
    g = np.random.default_rng(seed)
    scene = room.scene
    if n_bands > 1:
        scene = scene._replace(absorption=torch.as_tensor(
            g.uniform(0.0, 1.0, (scene.n_walls, n_bands)).astype(np.float32),
            device=device))
    src = np.asarray(room.source, np.float32)
    lis = (src + g.uniform(-6.0, 6.0, (n_listeners, 2))).astype(np.float32)
    if on_source:
        lis[0] = src
    mic = None
    if directive:
        mic = (dv.figure_eight(0.3) if n_listeners == 1 else
               np.stack([dv.figure_eight(a) for a in
                         g.uniform(-np.pi, np.pi, n_listeners)]))
    params = TraceParams.make(src, lis, input_gain=gain,
                              directivity=dv.cardioid(-0.9) if directive
                              else None, mic_directivity=mic, device=device)
    return scene, params


def _bits(x):
    return x.contiguous().view(torch.int64 if x.dtype == torch.float64
                               else torch.int32)


def _assert_same_bits(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w)), (g, w)


def _args_both(scene, params, shape, tables=None):
    got = bk.k4_args(scene, params, *shape, tables=tables)
    want = bk.k4_args_plain(scene, params, *shape, tables=tables)
    torch.cuda.synchronize()
    return got, want


@cuda
@pytest.mark.parametrize("directive", [False, True])
@pytest.mark.parametrize("n_listeners", [1, 4, 64])
@pytest.mark.parametrize("n_bands", [1, 2, 8])
def test_k4_args_equal_the_plain_chain_bit_for_bit(cuda_device, n_bands,
                                                   n_listeners, directive):
    scene, params = _case(cuda_device, n_bands, n_listeners, directive,
                          seed=n_bands * 100 + n_listeners)
    for shape in SHAPES:
        before = bk.k4_args.launches
        got, want = _args_both(scene, params, shape)
        assert bk.k4_args.launches == before + 1
        _assert_same_bits(got, want)
    assert got[0].shape == (1, 10 + n_bands, scene.n_walls)


@cuda
@pytest.mark.parametrize("directive", [False, True])
def test_k4_args_edge_poses(cuda_device, directive):
    """A listener on the source (the d^2 clamp), a zero gain (the bound's
    clamp at 1: the largest scale, 2^62) and a bound that is a power of
    two (2^17 hits of gain 1 at d^2 >= 0.5: log2 exact, scale 2^45)."""
    scene, params = _case(cuda_device, n_listeners=3, directive=directive,
                          on_source=True)
    _assert_same_bits(*_args_both(scene, params, SHAPES[0]))
    zero = params._replace(input_gain=torch.zeros((), device=cuda_device))
    got, want = _args_both(scene, zero, SHAPES[0])
    _assert_same_bits(got, want)
    assert float(got[2]) == 2.0 ** 62
    if not directive:
        far = params._replace(listeners=params.source[None] + 1.0)
        got, want = _args_both(scene, far, (1, 16384, 4))
        _assert_same_bits(got, want)
        assert float(got[2]) == 2.0 ** 45


@cuda
@pytest.mark.parametrize("shape", [(1, 16384, 4), (64, 1 << 20, 4),
                                   (1024, 1 << 24, 32)])
def test_k4_args_scale_a_few_ulps_above_a_power_of_two(cuda_device, shape):
    """Bounds 2^k (1 + m 2^-52), m = 0 .. 40, through a pattern gain bound
    of 1 + m 2^-52 (source coefficients [1, m 2^-52, 0]; a microphone of
    [1]) at 2^k hits: where log2 rounds to k or to the next double up,
    the floor of 62 - log2 moves by one, so the kernel's log2 must round
    as PyTorch's does."""
    scene, params = _case(cuda_device, n_listeners=1)
    far = params._replace(listeners=params.source[None] + 1.0)
    mic = torch.ones((1, 1, 1), device=cuda_device)
    scales = set()
    for m in range(41):
        src = torch.tensor([[1.0, m * 2.0 ** -52, 0.0]], device=cuda_device)
        got, want = _args_both(scene, far, shape, tables=(src, mic))
        _assert_same_bits(got, want)
        scales.add(float(got[2]))
    assert len(scales) <= 2


@cuda
def test_k4_args_random_poses(cuda_device):
    """400 poses from one seed: 1-8 listeners, a quarter of them within
    0.7 of the source (the NEE bound above the gain), gains in [0, 200),
    random frame, ray and bounce counts, a third directive."""
    g = np.random.default_rng(7)
    room = rooms.smoll_room(device=cuda_device)
    src = np.asarray(room.source, np.float32)
    for i in range(400):
        n_l = int(g.integers(1, 9))
        reach = 0.7 if g.random() < 0.25 else 12.0
        lis = (src + g.uniform(-reach, reach, (n_l, 2))).astype(np.float32)
        directive = i % 3 == 0
        params = TraceParams.make(
            src, lis, input_gain=float(g.uniform(0.0, 200.0)),
            listener_radius=float(g.uniform(0.1, 2.0)),
            speed_of_sound=float(g.uniform(300.0, 400.0)),
            directivity=dv.cardioid(float(g.uniform(-3, 3))) if directive
            else None,
            mic_directivity=dv.figure_eight(float(g.uniform(-3, 3)))
            if directive else None, device=cuda_device)
        shape = (int(g.integers(1, 65)), int(g.integers(1, 200000)),
                 int(g.integers(1, 17)))
        _assert_same_bits(*_args_both(room.scene, params, shape))


@cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_k4_args_non_float32_scalars(cuda_device, dtype):
    """A source and a gain in another dtype: the kernel reads them in
    double for the scale and rounds them for the scalars, as the twin's
    .double() and stack(...).to(float32) do."""
    scene, params = _case(cuda_device, n_listeners=2)
    odd = params._replace(
        source=torch.tensor([-18.1234567891, 9.00000012345], dtype=dtype,
                            device=cuda_device),
        input_gain=torch.tensor(1.2345678912345, dtype=dtype,
                                device=cuda_device))
    _assert_same_bits(*_args_both(scene, odd, SHAPES[0]))


@cuda
def test_k4_at_the_stream_shape_keeps_the_parent_bits(cuda_device):
    room = rooms.smoll_room(device=cuda_device)
    params = TraceParams.make(room.source, room.listener,
                              device=cuda_device)
    ir = bk.trace_frames_ir_mega(room.scene, params, 42, 2, **STREAM)
    torch.cuda.synchronize()
    digest = hashlib.sha256(ir.contiguous().cpu().numpy().tobytes()
                            ).hexdigest()[:16]
    assert digest == PARENT_K4_STREAM_BITS


def _on_twin_args(host_uniforms, scene, params, emit, u, key, n_frames,
                  counter=None):
    """The launch of ``_launch_scene`` on the twin's arguments: K3/K4 as
    they ran before the argument kernel."""
    src, mic = bk.pattern_tables(params.directivity, params.mic_directivity,
                                 1, params.listeners.shape[0], scene.device)
    walls, scal, scale = bk.k4_args_plain(
        scene, params, n_frames, STREAM["n_rays"], STREAM["max_bounces"])
    return bk._launch(host_uniforms, walls, params.listeners[None], scal,
                      emit, u, key, 0, n_frames, STREAM["n_rays"],
                      STREAM["max_bounces"], STREAM["sample_rate"],
                      STREAM["ir_length"], scale, None, src, mic,
                      scene.n_bands, counter)[0]


@cuda
@pytest.mark.parametrize("n_bands,n_listeners,directive",
                         [(1, 1, False), (1, 3, True), (8, 4, False)])
def test_k3_k4_k6_through_the_kernel_equal_the_twin_args(
        cuda_device, n_bands, n_listeners, directive):
    scene, params = _case(cuda_device, n_bands, n_listeners, directive,
                          seed=3)
    key = rng.seed_key(rng.mix_seed(7, 0))
    k4 = bk.trace_frames_ir_mega(scene, params, rng.mix_seed(7, 0), 1,
                                 **STREAM)
    assert torch.equal(k4, _on_twin_args(False, scene, params, None, None,
                                         key, 1))
    emit, u = rng.philox_uniforms(5, 1, STREAM["max_bounces"],
                                  STREAM["n_rays"], cuda_device)
    k3 = bk.trace_frames_ir_whole(scene, params, emit, u,
                                  sample_rate=STREAM["sample_rate"],
                                  ir_length=STREAM["ir_length"])
    assert torch.equal(k3, _on_twin_args(True, scene, params, emit, u,
                                         (0, 0), 1))
    if n_bands == 1:
        k6 = bk.trace_frame_ir_fused(scene, params, emit[0], u[0],
                                     sample_rate=STREAM["sample_rate"],
                                     ir_length=STREAM["ir_length"])
        assert torch.equal(k6, k3)


@cuda
def test_one_argument_launch_per_call(cuda_device):
    """K3, K4 and K6 each launch the argument kernel once a call, and a
    launch whose listeners run in blocks (64 listeners beside 5,280 walls)
    once for all its blocks."""
    scene, params = _case(cuda_device)
    emit, u = rng.philox_uniforms(5, 1, STREAM["max_bounces"],
                                  STREAM["n_rays"], cuda_device)
    kw = dict(sample_rate=STREAM["sample_rate"],
              ir_length=STREAM["ir_length"])
    calls = (
        lambda: bk.trace_frames_ir_mega(scene, params, 1, 1, **STREAM),
        lambda: bk.trace_frames_ir_whole(scene, params, emit, u, **kw),
        lambda: bk.trace_frame_ir_fused(scene, params, emit[0], u[0], **kw),
        lambda: bk.trace_frame_ir_fused(scene, params, seed=1,
                                        n_rays=STREAM["n_rays"],
                                        max_bounces=STREAM["max_bounces"],
                                        **kw))
    for call in calls:
        before = bk.k4_args.launches
        call()
        assert bk.k4_args.launches == before + 1
    big, many = _case(cuda_device, n_listeners=64, seed=9)
    big = big.pad_to(bk.MAX_WALLS)
    assert bk.listener_block(bk.MAX_WALLS) < 64
    before, k4_before = bk.k4_args.launches, bk.trace_frames_ir_mega.launches
    blocked = bk.trace_frames_ir_mega(big, many, 3, 1, n_rays=2048,
                                      max_bounces=3, sample_rate=8000,
                                      ir_length=4000)
    torch.cuda.synchronize()
    assert bk.k4_args.launches == before + 1
    assert bk.trace_frames_ir_mega.launches - k4_before == -(
        -64 // bk.listener_block(bk.MAX_WALLS))
    assert blocked.shape == (64, 4000, 1)


@cuda
@pytest.mark.parametrize("route", ["K4", "K3"])
def test_profiled_call_launches_the_argument_kernel_and_the_trace(
        cuda_device, route):
    """A profiled K4 (K3) call at the stream's shape: on the card one
    k4_args_kernel and one frames_ir_kernel, besides only the trace's own
    memset and fixed-point conversion (no PyTorch kernel); the argument
    kernel's launch is the only launch inside the span art.k4.prep."""
    from torch.profiler import ProfilerActivity, profile
    scene, params = _case(cuda_device)
    emit, u = rng.philox_uniforms(5, 1, STREAM["max_bounces"],
                                  STREAM["n_rays"], cuda_device)

    def call():
        if route == "K4":
            return bk.trace_frames_ir_mega(scene, params, 1, 1, **STREAM)
        return bk.trace_frames_ir_whole(scene, params, emit, u,
                                        sample_rate=STREAM["sample_rate"],
                                        ir_length=STREAM["ir_length"])

    call()                                    # build and warm outside
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_lead_in()
        call()
        torch.cuda.synchronize()
    cuda_kind = torch.autograd.DeviceType.CUDA
    kernels = [e.name for e in prof.events() if e.device_type == cuda_kind
               and "spin_kernel" not in e.name
               and not e.name.lower().startswith(("memset", "memcpy"))]
    assert sum("k4_args_kernel" in n for n in kernels) == 1
    assert sum("frames_ir_kernel" in n for n in kernels) == 1
    assert all("k4_args_kernel" in n or "frames_ir_kernel" in n
               or "fixed_to_float_kernel" in n for n in kernels), kernels
    host = [e for e in prof.events() if e.device_type != cuda_kind]
    prep = [e for e in host if e.name == "art.k4.prep"]
    assert len(prep) == 1
    t0, t1 = prep[0].time_range.start, prep[0].time_range.end
    inside = [e.name for e in host
              if e.name.startswith(("cudaLaunch", "cuLaunch"))
              and t0 <= e.time_range.start <= t1]
    assert len(inside) == 1


@cuda
def test_the_card_never_runs_the_twin(cuda_device, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the plain argument chain ran on the card")

    for name in ("k4_args_plain", "pack_walls_banded", "pack_walls",
                 "pack_scalars", "fixed_point_scale", "fixed_point_scales"):
        monkeypatch.setattr(bk, name, refuse)
    scene, params = _case(cuda_device, n_bands=2, n_listeners=2,
                          directive=True)
    ir = bk.trace_frames_ir_mega(scene, params, 1, 1, **STREAM)
    torch.cuda.synchronize()
    assert float(ir.sum()) > 0
