"""PyTorch port on the card: per-arrival Doppler's tap kernels
(``ear_taps_kernel`` and ``tap_synthesis_kernel`` of
``csrc/arrival_taps_kernel.cu``, through
``ops/cuda/arrival_taps_kernel.py``).

* The ear-tap table equals the card's chain (``streaming._ear_taps``)
  bit for bit: the same float32 operations in the same order, the same
  libdevice sqrt, atan2 and sin; its flags and match equal the CPU
  chain's, its rows the CPU chain's within two ulps plus what the two
  libraries' sin and atan2 (a few ulps apart) move them. At the
  headphone cell's shape (A = 6, K = 1, T = 72,000) and at K = 4, over
  the cases of tests/test_torch_arrival_taps_kernel.py: taps at bin 0
  and T - 1, a 64-bin glide, the first chunk, no valid tap, every
  previous tap vanished, a float64 speed of sound, the degenerate head.
* The tap synthesis equals the CPU chain (``streaming._tap_chunk_plain``)
  within test_torch_doppler.py's ``_tap_limit(..., 1e-5)`` (the kernel
  sums its terms in row order, the chain in torch's reduction order) at
  n = 4,800 and a 10,562-sample window, in every form ``_tap_chunk``
  takes (the cell's ear rows, K = 4, the mono scalar and banded forms),
  with reads before the window, and from a ``DryWindow`` (looped, across
  the clip's end, the first chunk, past the end, a stop) against the
  gated window tensor.
* A composed stream (binaural x per-arrival) through the kernels against
  the same stream through the chain on the card, with the speed of sound
  changing every chunk and a stop: equal carries and wet chunks, taps
  within the tap limit; a rerun gives the same bits.
* One launch a call of each (``.launches``), and a profiled composed
  chunk launches exactly two kernels inside ``art.arrival.taps``; the
  card never runs the chain; malformed inputs raise ``ValueError``.

Every test here needs an NVIDIA GPU and nvcc and skips elsewhere. This
file imports no JAX:

    python -m pytest tests/test_torch_cuda_tap_kernel.py -m cuda \\
        --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_arrival_taps_kernel import (EAR_CASES, FORMS, WINDOWS,
                                            dry_window, ear_case, tap_limit,
                                            tap_rows)
from torch_parity import cuda, cuda_device, profiler_lead_in  # noqa: F401

import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import streaming as st
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import convolve as cv
from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
    arrival_taps_kernel as atk


def _bits(x):
    return x.contiguous().view(torch.int32)


def _card(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, st.ArrivalCarry):
        return st.ArrivalCarry(None, *(getattr(x, f).to(dev) for f in
                                       ("idx", "g3", "val", "x3", "y3")))
    if isinstance(x, st.DryWindow):
        return dataclasses.replace(x, dry=x.dry.to(dev))
    return x


@cuda
@pytest.mark.parametrize("name", EAR_CASES)
def test_ear_taps_equal_the_card_chain(cuda_device, name):
    case = [_card(a, cuda_device) for a in ear_case(name)]
    before = atk.ear_taps.launches
    got = atk.ear_taps(*case)
    torch.cuda.synchronize()
    assert atk.ear_taps.launches == before + 1
    chain = st._ear_taps(*case)
    for f, g, w in zip(st.EarTaps._fields, got, chain):
        assert g.dtype == w.dtype and g.shape == w.shape, f
        if g.dtype == torch.float32:
            assert torch.equal(_bits(g.cpu()), _bits(w.cpu())), f
        else:
            assert torch.equal(g.cpu(), w.cpu()), f


@cuda
@pytest.mark.parametrize("name", EAR_CASES)
def test_ear_taps_against_the_cpu_chain(cuda_device, name):
    """Flags and match equal; rows within two ulps plus a sine gap of
    2^-19 (libdevice's atan2f is within 3 ulps and sinf within 2, the
    CPU's within 1: some 5 ulps of pi) times what it moves:
    ``max_shift`` for a delay, the largest W for a gain."""
    case = ear_case(name)
    got = atk.ear_taps(*(_card(a, cuda_device) for a in case))
    want = st._ear_taps(*case)
    for f in ("valid", "j", "mutual", "vanished"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    ms = atk.max_shift_known(case[6], case[5], case[8])
    w_max = max(float(case[0].g3.abs().max()),
                float(case[1].g3.abs().max()))
    worst = {}
    for f in ("tau0", "tau1", "g0", "g1"):
        g, w = getattr(got, f).cpu().numpy(), getattr(want, f).numpy()
        move = 2.0 ** -19 * (ms if f.startswith("tau") else w_max)
        gap = np.abs(g - w)
        assert bool((gap <= 2 * np.spacing(np.abs(w)) + move).all()), f
        worst[f] = float((gap / np.spacing(np.abs(w))).max())
    print(name, "largest gaps in ulps of the CPU chain's rows", worst)


@cuda
@pytest.mark.parametrize("form", FORMS)
def test_synthesis_against_the_cpu_chain(cuda_device, form):
    args = tap_rows(form)
    before = atk.tap_synthesis.launches
    got = st._tap_chunk(*(_card(a, cuda_device) for a in args))
    torch.cuda.synchronize()
    assert atk.tap_synthesis.launches == before + 1
    want = st._tap_chunk_plain(*args)
    dry, _, _, g0, g1, _, _ = args
    gap = float((got.cpu() - want).abs().max())
    assert gap <= tap_limit(dry, g0, g1), (gap, tap_limit(dry, g0, g1))
    assert float(want.abs().max()) > 0
    # and against the card's own chain (its sum in another order again)
    card = st._tap_chunk_plain(*(_card(a, cuda_device) for a in args))
    assert float((got - card).abs().max()) <= tap_limit(dry, g0, g1)


@cuda
@pytest.mark.parametrize("name", WINDOWS)
def test_synthesis_reads_a_dry_window_from_the_clip(cuda_device, name):
    w = dry_window(name)
    rows = tap_rows("ears")[1:]
    got = st._tap_chunk(_card(w, cuda_device),
                        *(_card(a, cuda_device) for a in rows))
    gated = cv.gate_input(w.tensor())
    want = st._tap_chunk_plain(gated, *rows)
    assert float((got.cpu() - want).abs().max()) <= tap_limit(
        gated, *rows[2:4])
    # every term's read is the window's: a kernel fed the gated tensor
    # gives the same bits
    again = st._tap_chunk(gated.to(cuda_device),
                          *(_card(a, cuda_device) for a in rows))
    assert torch.equal(_bits(got), _bits(again))


def _composed(dev, n_chunks=5, seed=7, stop=None, chain=False,
              monkeypatch=None):
    """A composed headphone stream of SmollRoom (per-arrival Doppler on a
    binaural streamer, a turning head, the source walking) whose speed of
    sound changes every chunk; ``stop``: the chunk a stop control comes
    at. With ``chain`` the taps run the plain chain on the card. Returns
    the output, each chunk's carry and each chunk's tap rows."""
    room = rooms.smoll_room(device=dev)
    cfg = art.smoll_room_config()
    eng = art.Engine(room.scene, cfg)
    dry = (torch.rand(6 * 4800, generator=torch.Generator(dev).manual_seed(
        seed), device=dev) - 0.5)
    src = np.float32(room.source)
    rows, carries = [], []
    real_taps = st._window_taps

    def window_taps(window, k, *args):
        rows.append(args[:-1])                # tau0, tau1, g0, g1, valid
        return real_taps(window, k, *args)

    monkeypatch.setattr(st, "_window_taps", window_taps)
    if chain:
        def plain(w, *args):
            if isinstance(w, st.DryWindow):
                w = cv.gate_input(w.tensor())
            return st._tap_chunk_plain(w, *args)
        monkeypatch.setattr(atk, "ear_taps", st._ear_taps)
        monkeypatch.setattr(st, "_tap_chunk", plain)

    def params(i):
        p = eng.params(src + np.float32([0.3 * i, -0.2 * i]), room.listener)
        return p._replace(speed_of_sound=torch.full_like(
            p.speed_of_sound, 343.0 - 25.0 * i))

    out = art.Streamer(room.scene, cfg, seed=seed, binaural=True).stream_clip(
        dry, params, total_chunks=n_chunks, loop=True,
        facing_fn=lambda i: 0.4 - 0.3 * i, doppler="per_arrival",
        control_fn=(lambda i: {"stop": i == stop}) if stop else None,
        on_chunk=lambda i, s: carries.append(
            [x.clone() for x in s.arrival.tensors()]))
    torch.cuda.synchronize()
    monkeypatch.undo()
    return out, carries, rows, dry


@cuda
@pytest.mark.parametrize("stop", [None, 3])
def test_composed_stream_through_the_kernels_matches_the_chain(
        cuda_device, monkeypatch, stop):
    got, carries, rows, dry = _composed(cuda_device, stop=stop,
                                        monkeypatch=monkeypatch)
    want, carries_w, rows_w, _ = _composed(cuda_device, stop=stop,
                                           chain=True,
                                           monkeypatch=monkeypatch)
    for a, b in zip(carries, carries_w):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert len(rows) == len(rows_w) == 5
    for a, b in zip(rows, rows_w):
        for f, x, y in zip(("tau0", "tau1", "g0", "g1", "valid"), a, b):
            assert torch.equal(x.cpu().view(-1).view(torch.uint8),
                               y.cpu().view(-1).view(torch.uint8)), f
    assert sum(int(r[4].sum()) for r in rows) > 0
    # the chunks' taps differ by their sums' order alone (and the output
    # by the rounding of the ring's add)
    limit = sum(tap_limit(dry, r[2], r[3]) for r in rows_w) + 2 * float(
        np.spacing(np.float32(want.abs().max().item())))
    gap = float((got - want).abs().max())
    assert gap <= limit, (gap, limit)
    again, _, _, _ = _composed(cuda_device, stop=stop,
                               monkeypatch=monkeypatch)
    assert torch.equal(_bits(got), _bits(again))


@cuda
def test_the_card_never_runs_the_chain(cuda_device, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the plain tap chain ran on the card")

    for name in ("_tap_chunk_plain", "_ear_taps", "_match_arrivals",
                 "_ear_fields", "_device_window", "_band_windows"):
        monkeypatch.setattr(st, name, refuse)
    before = (atk.ear_taps.launches, atk.tap_synthesis.launches)
    room = rooms.smoll_room(device=cuda_device)
    cfg = art.smoll_room_config()
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    dry = torch.rand(6 * 4800, device=cuda_device) - 0.5
    out = art.Streamer(room.scene, cfg, seed=3, binaural=True).stream_clip(
        dry, lambda i: p, total_chunks=3, loop=True,
        facing_fn=lambda i: 0.2 * i, doppler="per_arrival")
    torch.cuda.synchronize()
    assert (atk.ear_taps.launches - before[0],
            atk.tap_synthesis.launches - before[1]) == (3, 3)
    assert float(out.abs().sum()) > 0


@cuda
def test_a_profiled_composed_chunk_launches_two_tap_kernels(cuda_device):
    """Two profiled composed chunks: inside each ``art.arrival.taps`` span
    exactly two launch calls, the ear-tap table's and the synthesis's,
    and those two kernels on the card, once a chunk each."""
    from torch.profiler import ProfilerActivity, profile
    room = rooms.smoll_room(device=cuda_device)
    cfg = art.smoll_room_config()
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    dry = torch.rand(4 * 4800, device=cuda_device) - 0.5

    def run():
        return art.Streamer(room.scene, cfg, seed=5,
                            binaural=True).stream_clip(
            dry, lambda i: p, total_chunks=2, loop=True,
            facing_fn=lambda i: 0.3 - 0.2 * i, doppler="per_arrival")

    run()                                            # build and warm
    torch.cuda.synchronize()
    before = (atk.ear_taps.launches, atk.tap_synthesis.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_lead_in()
        run()
        torch.cuda.synchronize()
    assert (atk.ear_taps.launches - before[0],
            atk.tap_synthesis.launches - before[1]) == (2, 2)
    cuda_kind = torch.autograd.DeviceType.CUDA
    kernels = [e.name for e in prof.events() if e.device_type == cuda_kind]
    assert sum("ear_taps_kernel" in n for n in kernels) == 2
    assert sum("tap_synthesis_kernel" in n for n in kernels) == 2
    host = [e for e in prof.events() if e.device_type != cuda_kind]
    spans = [e for e in host if e.name == "art.arrival.taps"]
    assert len(spans) == 2
    for r in spans:
        t0, t1 = r.time_range.start, r.time_range.end
        inside = [e.name for e in host
                  if e.name.startswith(("cudaLaunch", "cuLaunch"))
                  and t0 <= e.time_range.start <= t1]
        assert len(inside) == 2, inside


@cuda
def test_malformed_inputs_raise_on_the_card(cuda_device):
    dev = cuda_device
    dry, tau0, tau1, g0, g1, valid, n = (_card(a, dev)
                                         for a in tap_rows("ears"))
    with pytest.raises(ValueError):
        st._tap_chunk(dry, tau0, tau1, g0, g1, valid.float(), n)
    with pytest.raises(ValueError):
        st._tap_chunk(dry, tau0, tau1[:, :3], g0, g1, valid, n)
    with pytest.raises(ValueError):
        st._tap_chunk(dry.double(), tau0, tau1, g0, g1, valid, n)
    with pytest.raises(ValueError):
        st._tap_chunk(dry, tau0.cpu(), tau1, g0, g1, valid, n)
    case = [_card(a, dev) for a in ear_case("cell")]
    cur = case[0]
    bad = st.ArrivalCarry(None, cur.idx.int(), cur.g3, cur.val, cur.x3,
                          cur.y3)
    with pytest.raises(ValueError):
        atk.ear_taps(bad, *case[1:])
    with pytest.raises(ValueError):
        atk.ear_taps(*case[:3], torch.tensor(0.1, dtype=torch.float64,
                                             device=dev), *case[4:])
    with pytest.raises(ValueError):
        atk.ear_taps(case[0], _card(ear_case("four_bands")[1], dev),
                     *case[2:])
