"""PyTorch port on the card: the binaural decode kernel
(``binaural_decode_kernel`` of ``csrc/binaural_decode_kernel.cu``, through
``ops/cuda/binaural_kernel.py::binaural_decode``).

* Bit for bit: the kernel equals the plain chain's deposits computed on
  the card (``spatial.binaural_entries``: every source bin's ``lo``, ``hi``
  and its two deposits, from the card's sqrt, atan2, sin, clamp and
  floor) summed in index order (``index_add_`` on the host) plus the
  diffuse rest, at the headphone cell's shape on a traced capture and at
  each case of tests/test_torch_binaural_decode.py: a deposit moved one
  bin, or one rounded otherwise, flips the bits of a sum.
* Against the card's own chain (its sorted ``index_put_``): equal bits
  wherever a bin takes fewer than 32 deposits, and within the reordering
  bound of the bin's deposits where it takes more. Only the summation
  order differs: the chain sums a row of 32 or more in a warp reduction.
* A rerun gives the same bits; one launch a call
  (``binaural_decode.launches``) and that kernel alone on the card; the
  composed headphone stream never runs the chain, and a profiled
  composed chunk shows two decode launches (one in each decode span) and
  no ``indexing_backward`` kernel; its radix sort is the arrival table's
  ``torch.sort`` alone.

Every test here needs an NVIDIA GPU and nvcc and skips elsewhere. This
file imports no JAX:

    python -m pytest tests/test_torch_cuda_binaural_decode.py -m cuda \\
        --noconftest
"""

import pytest
import torch
from test_torch_binaural_decode import CASES, HEAD, SR, _value, capture
from torch_parity import cuda, cuda_device, profiler_lead_in  # noqa: F401

import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import spatial as spm
from realisticaudioraytracing2d_tpu_torch import streaming
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import ir as irm
from realisticaudioraytracing2d_tpu_torch.ops.cuda import binaural_kernel \
    as bdk

def _bits(x):
    return x.contiguous().view(torch.int32)


def _card(v, dev):
    return v.to(dev) if isinstance(v, torch.Tensor) else v


def _case(name, dev):
    n_l, n_t, n_k, sr, facing, speed, kw = CASES[name]
    opts = {**HEAD, "decorrelate": True, **kw}
    cap = capture(n_l, n_t, n_k, seed=len(name),
                  edges=name == "clamped_edges").to(dev)
    return (cap, sr, _card(_value(facing), dev), _card(_value(speed), dev),
            opts)


def _traced_capture(dev, seed=8):
    """A [3, 72,000, 1] capture of the shipped SmollRoom through K4."""
    room = rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config()
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    _, st = spm.trace_spatial(room.scene, p, seed, n_rays=15000,
                              max_bounces=5, sample_rate=SR,
                              ir_length=72000)
    return st.normalized(), p.speed_of_sound


def _in_index_order(cap, sr, facing, speed, opts):
    """The chain's card-computed deposits summed in index order on the
    host, the diffuse rest added: ``[2L, T, K]`` and the deposit count of
    each output bin."""
    sp = spm.spatial_from_ir(cap)
    rows, values, diffuse = spm.binaural_entries(
        sp, sr, facing, opts["head_radius"], opts["shadow"], speed)
    rows, values, diffuse = rows.cpu(), values.cpu(), diffuse.cpu()
    deposits = torch.zeros(2 * diffuse.numel()).index_add_(0, rows, values)
    decorr = spm._decorrelated(opts["decorrelate"], opts["head_radius"],
                               opts["shadow"])
    dups = torch.bincount(rows, minlength=2 * diffuse.numel())
    return (spm.binaural_ears(deposits, diffuse, decorr),
            dups.reshape(-1, *diffuse.shape[1:]), deposits)


def _decode(cap, sr, facing, speed, opts):
    return spm.binaural_decode_ir(cap, sr, facing, opts["head_radius"],
                                  opts["shadow"], speed,
                                  decorrelate=opts["decorrelate"])


@cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_the_chain_deposited_in_index_order(cuda_device,
                                                          name):
    cap, sr, facing, speed, opts = _case(name, cuda_device)
    before = bdk.binaural_decode.launches
    got = _decode(cap, sr, facing, speed, opts)
    sp = spm.spatial_from_ir(cap)
    lft, rgt = sp.binaural(sr, facing, speed_of_sound=speed, **opts)
    torch.cuda.synchronize()
    assert bdk.binaural_decode.launches == before + 2
    want, _, _ = _in_index_order(cap, sr, facing, speed, opts)
    assert torch.equal(_bits(got.cpu()), _bits(want))
    assert torch.equal(_bits(torch.cat([lft, rgt]).cpu()), _bits(want))
    assert float(want.abs().sum()) > 0


@cuda
@pytest.mark.parametrize("facing", [0.3, -2.0])
def test_kernel_on_a_traced_capture(cuda_device, facing):
    """The cell's shape: a K4 capture of SmollRoom, the stream's card
    tensor speed of sound and a Python facing, and a card tensor facing."""
    cap, speed = _traced_capture(cuda_device)
    opts = {**HEAD, "decorrelate": True}
    want, _, _ = _in_index_order(cap, SR, facing, speed, opts)
    for fac in (facing, torch.tensor(facing, device=cuda_device)):
        got = _decode(cap, SR, fac, speed, opts)
        assert torch.equal(_bits(got.cpu()), _bits(want))
    assert float(want[:, :, 0].abs().sum()) > 0


@cuda
@pytest.mark.parametrize("name", ["cell", "clamped_edges", "four_bands",
                                  "slow_speed_tensor", "slow_speed_number",
                                  "traced"])
def test_kernel_against_the_card_chain(cuda_device, name):
    """The card's chain (``binaural_plain``: its deterministic
    ``index_put_``) sums a bin's deposits one after another in index
    order below 32 of them, as the kernel does, and in a warp reduction
    from 32 on: the same bits below, within the reordering bound of a sum
    of non-negative deposits above, 2 (n - 1) 2^-24 of the bin's deposit
    sum, plus an ulp of the result for the diffuse term's add."""
    if name == "traced":
        cap, speed = _traced_capture(cuda_device, seed=3)
        sr, facing, opts = SR, 0.7, {**HEAD, "decorrelate": True}
    else:
        cap, sr, facing, speed, opts = _case(name, cuda_device)
    got = _decode(cap, sr, facing, speed, opts).cpu()
    chain = spm.binaural_plain(spm.spatial_from_ir(cap), sr, facing,
                               opts["head_radius"], opts["shadow"], speed,
                               opts["decorrelate"]).cpu()
    _, dups, deposits = _in_index_order(cap, sr, facing, speed, opts)
    deposits = deposits.reshape(got.shape)
    differ = got != chain
    assert not bool((differ & (dups < 32)).any())
    ulp = 2.0 ** -24
    limit = (2 * (dups - 1).clamp(min=0) * ulp * deposits.abs()
             + 2 * ulp * chain.abs())
    assert bool(((got - chain).abs() <= limit).all())
    if name in ("slow_speed_tensor", "slow_speed_number"):
        assert int(dups.max()) >= 32        # the warp reduction's rows


@cuda
@pytest.mark.parametrize("name", ["slow_speed_number", "traced"])
def test_any_shared_halo_gives_the_same_bits(cuda_device, name,
                                             monkeypatch):
    """The shared halo is a cache of the window's sources: none, a few,
    part of the window and all of it give the index-order bits (a block's
    window then splits into global, shared and global segments at every
    offset)."""
    if name == "traced":
        cap, speed = _traced_capture(cuda_device, seed=4)
        sr, facing, opts = SR, -0.6, {**HEAD, "decorrelate": True}
    else:
        cap, sr, facing, speed, opts = _case(name, cuda_device)
    want, _, _ = _in_index_order(cap, sr, facing, speed, opts)
    for halo in (0, 1, 3, 7, 45, 100, bdk.MAX_SHARED_HALO):
        monkeypatch.setattr(bdk, "shared_halo",
                            lambda *args, _halo=halo: _halo)
        got = _decode(cap, sr, facing, speed, opts)
        assert torch.equal(_bits(got.cpu()), _bits(want)), halo


@cuda
def test_rerun_gives_the_same_bits(cuda_device):
    cap, speed = _traced_capture(cuda_device, seed=5)
    opts = {**HEAD, "decorrelate": True}
    first = _decode(cap, SR, 1.1, speed, opts)
    again = [_decode(cap, SR, 1.1, speed, opts) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(first), _bits(a)) for a in again)


@cuda
def test_one_launch_and_only_the_kernel_on_the_card(cuda_device):
    """One decode launch a call, for a capture and for a SpatialIR, and in
    a profiled call the decode kernel alone on the card."""
    from torch.profiler import ProfilerActivity, profile
    cap, speed = _traced_capture(cuda_device, seed=6)
    sp = spm.spatial_from_ir(cap)
    opts = {**HEAD, "decorrelate": True}
    calls = (lambda: _decode(cap, SR, 0.2, speed, opts),
             lambda: sp.binaural(SR, 0.2, speed_of_sound=speed),
             lambda: sp.binaural(SR, 0.2, speed_of_sound=343.0,
                                 decorrelate=False))
    for call in calls:
        call()
        torch.cuda.synchronize()
        before = bdk.binaural_decode.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiler_lead_in()
            call()
            torch.cuda.synchronize()
        assert bdk.binaural_decode.launches == before + 1
        cuda_kind = torch.autograd.DeviceType.CUDA
        kernels = [e.name for e in prof.events()
                   if e.device_type == cuda_kind
                   and "spin_kernel" not in e.name]
        assert kernels and all("binaural_decode_kernel" in n
                               for n in kernels), kernels
        assert len(kernels) == 1, kernels


def _composed(dev, n_chunks, seed=5):
    """A composed headphone stream (per-arrival Doppler on a binaural
    streamer, a turning head) of ``n_chunks`` 0.1 s chunks on SmollRoom."""
    room = rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config()
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    dry = torch.rand(8 * 4800, generator=torch.Generator(dev).manual_seed(
        seed), device=dev) - 0.5
    out = art.Streamer(room.scene, cfg, seed=seed, binaural=True,
                       arrival_taps=6).stream_clip(
        dry, lambda i: p, total_chunks=n_chunks, loop=True,
        facing_fn=lambda i: 0.4 - 0.3 * i, doppler="per_arrival")
    torch.cuda.synchronize()
    return out


@cuda
def test_the_card_never_runs_the_chain(cuda_device, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the plain decode chain ran on the card")

    for mod, name in ((spm, "binaural_plain"), (spm, "binaural_entries"),
                      (spm, "binaural_ears"), (irm, "add_rows")):
        monkeypatch.setattr(mod, name, refuse)
    before = bdk.binaural_decode.launches
    out = _composed(cuda_device, 3)
    assert bdk.binaural_decode.launches - before == 6   # two a chunk
    assert float(out.abs().sum()) > 0


@cuda
def test_profiled_composed_chunks_have_no_sorted_accumulate(cuda_device,
                                                            monkeypatch):
    """Two profiled composed chunks: two decode launches a chunk, one
    inside each decode span (``art.stream.decode``,
    ``art.arrival.residual``), no ``indexing_backward`` kernel, and the
    radix sort kernels of the arrival table's one ``torch.sort`` a chunk,
    no more."""
    from torch.profiler import ProfilerActivity, profile
    early = []
    real_table = streaming._arrival_table

    def table(ir, early_bins, n_taps, *args, **kw):
        early.append(early_bins)
        return real_table(ir, early_bins, n_taps, *args, **kw)

    monkeypatch.setattr(streaming, "_arrival_table", table)
    _composed(cuda_device, 2)                          # build and warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_lead_in()
        _composed(cuda_device, 2)
    cuda_kind = torch.autograd.DeviceType.CUDA
    kernels = [e.name for e in prof.events() if e.device_type == cuda_kind
               and "spin_kernel" not in e.name]
    assert sum("binaural_decode_kernel" in n for n in kernels) == 4
    assert not any("indexing_backward" in n for n in kernels), kernels
    host = [e for e in prof.events() if e.device_type != cuda_kind]
    for span in ("art.stream.decode", "art.arrival.residual"):
        ranges = [e for e in host if e.name == span]
        assert len(ranges) == 2
        for r in ranges:
            t0, t1 = r.time_range.start, r.time_range.end
            inside = [e for e in host
                      if e.name.startswith(("cudaLaunch", "cuLaunch"))
                      and t0 <= e.time_range.start <= t1]
            assert len(inside) == 1, (span, [e.name for e in inside])
    # the arrival table's sort, profiled alone at the chunk's size
    assert len(set(early)) == 1
    score = torch.rand((1, early[0]), device=cuda_device)
    torch.sort(score, dim=1, descending=True, stable=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as alone:
        profiler_lead_in()
        torch.sort(score, dim=1, descending=True, stable=True)
        torch.cuda.synchronize()
    sorts = [e.name for e in alone.events() if "RadixSort" in e.name]
    assert sum("RadixSort" in n for n in kernels) == 2 * len(sorts)
