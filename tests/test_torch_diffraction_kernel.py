"""PyTorch port: the diffraction kernels on the CPU.

On the card ``art.addenda.diffraction`` is three launches at order 1 and
four at order 2 (``ops/cuda/diffraction_kernel.py``):
``diffraction_segments_kernel`` (the edge table, K2's packed walls and
every visibility segment of both orders, once), a K2 sweep an order, and
``diffraction_bin_kernel`` (the paths judged, binned and added into the
IR). Here:

* the kernel source itself, compiled for the CPU (``cuda_emulation.py``:
  a thread a CUDA thread, a barrier a ``__syncthreads``), with K2's
  plain version between its launches, against the CPU chain
  (``ops/diffraction.py``, ``use_kernels=False``, its lengths' square
  root correctly rounded as on the card: ``ieee_norm``): the edge
  table's weights, the packed walls and each family's visibility equal
  the chain's, and the IR added in place equals ``ir +
  diffraction_ir(...)`` bit for bit (with patterns the same bins within
  the host libm's sin, cos and atan2, a few ulps from PyTorch's CPU
  kernels) on SampleScene round the barrier walk's circle (shadowed and
  lit), on a split and a doubled barrier (a straight seam, coincident
  corners) and on SmollRoom with a barrier, at orders 1 and 2, K = 1 and
  8, one and two listeners, with and without source and microphone
  patterns, with an input gain given as a number or a tensor (the
  chain's reciprocal or its division), and on a barrier among 100 short
  walls (3,226 kept order-2 paths, more than the shared keys: the sort
  runs in the caller's scratch); with blocks of 32 threads and room for
  4 shared keys the same bits;
* the inputs the wrapper refuses (``ValueError`` before the library is
  loaded), and that a CPU scene runs the chain, never the kernels.

tests/test_torch_cuda.py holds the kernels on the card.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from cuda_emulation import available, emulated

from realisticaudioraytracing2d_tpu_torch import streaming as st
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.models.materials import \
    AudioMaterial
from realisticaudioraytracing2d_tpu_torch.models.scene import SceneBuilder
from realisticaudioraytracing2d_tpu_torch.ops import diffraction as dfr
from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
from realisticaudioraytracing2d_tpu_torch.ops.cuda import build
from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
    diffraction_kernel as dk
from realisticaudioraytracing2d_tpu_torch.ops.cuda import trace_kernel as tk
from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams

SR, T = 44100, 44100
SOURCE = (Path(__file__).resolve().parents[1]
          / "realisticaudioraytracing2d_tpu_torch" / "csrc"
          / "diffraction_kernel.cu")
OPAQUE = AudioMaterial(absorption=0.9, scattering=0.5, transmission=0.0,
                       ior=1.0)
# the barrier walk's circle: 4 m about the top wall's right-hand end
CENTRE, RADIUS = np.array([18.5, 14.12]), 4.0
needs_gxx = pytest.mark.skipif(not available(), reason="needs g++")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emulated(SOURCE, tmp_path_factory.mktemp("diffraction_emu"))


@pytest.fixture(autouse=True)
def ieee_norm(monkeypatch):
    """The chain's lengths with a correctly rounded square root, as the
    card's ``sqrtf`` and the emulated ``__fsqrt_rn`` round it: PyTorch's
    CPU ``sqrt`` may land an ulp off (6.2755408 for the root of
    39.382416, 6.2755413 correctly rounded)."""
    monkeypatch.setattr(dfr, "_norm", lambda x: torch.sqrt(
        (x * x).sum(-1).double()).float())


def walk_pose(i: int, n: int = 16) -> np.ndarray:
    a = 2.0 * np.pi * i / n
    return CENTRE + RADIUS * np.array([np.cos(a), np.sin(a)])


def barrier(n_bands=1, split=False, doubled=False, scattered=False,
            device="cpu"):
    b = SceneBuilder(n_bands=n_bands)
    if doubled:     # a two-point closed loop: two coincident walls
        b.add_polygon([np.array([[0.0, -4.0], [0.0, 4.0]])], OPAQUE)
    elif split:     # a straight seam at (0, 0)
        b.add_segment((0.0, -4.0), (0.0, 0.0), (1.0, 0.0), OPAQUE)
        b.add_segment((0.0, 0.0), (0.0, 4.0), (1.0, 0.0), OPAQUE)
    else:
        b.add_segment((0.0, -4.0), (0.0, 4.0), (1.0, 0.0), OPAQUE)
    if scattered:   # 100 short segments about it: 3,226 kept paths
        g = np.random.default_rng(1)
        for _ in range(100):
            c = g.uniform(-15.0, 15.0, 2)
            a = g.uniform(0.0, np.pi)
            d = 0.2 * np.array([np.cos(a), np.sin(a)])
            b.add_segment(tuple(c - d), tuple(c + d),
                          (-np.sin(a), np.cos(a)), OPAQUE)
    return b.build(device=device)


def smoll_barrier(n_bands=1, device="cpu"):
    b = rooms.smoll_room(n_bands=n_bands, device=device).builder
    b.add_segment((-18.0, 6.0), (-15.0, 6.0), (0.0, 1.0), OPAQUE)
    return b.build(device=device)


def patterns(n_listeners: int):
    """A cardioid source padded to C = 5 and a figure-eight microphone,
    per listener where there are two."""
    src = np.pad(dv.cardioid(0.7), (0, 2))
    mic = dv.figure_eight(0.3) if n_listeners == 1 else np.stack(
        [dv.figure_eight(0.3), np.pad(dv.cardioid(2.5), (0, 2))])
    return src, mic


def case(name: str, n_bands: int, n_listeners: int, pats: bool,
         device="cpu"):
    """``(scene, params)`` of a named case: ``walk<i>``, SampleScene at
    pose i of 16 on the barrier walk's circle (2 to 8 shadowed), or a
    barrier scene."""
    if name.startswith("walk"):
        room = rooms.sample_scene(n_bands=n_bands, device=device)
        scene, src = room.scene, room.source
        lis = walk_pose(int(name[4:]))
    elif name == "smoll barrier":
        scene = smoll_barrier(n_bands, device)
        src, lis = (-18.0, 9.0), (-16.0, 3.0)
    else:
        scene = barrier(n_bands, split=name == "split",
                        doubled=name == "doubled",
                        scattered=name == "scattered", device=device)
        src, lis = (-3.0, 0.5), (3.0, -0.5)
    listeners = np.stack([lis, np.asarray(lis) + [0.5, -0.3]][:n_listeners])
    d, m = patterns(n_listeners) if pats else (None, None)
    return scene, TraceParams.make(src, listeners, directivity=d,
                                   mic_directivity=m, device=device)


def kernel_ir(lib, scene, params, order, cur):
    got = cur.clone()
    out = dk.add_paths(got, scene, params, sample_rate=SR,
                       band_freqs=dfr.band_frequencies(scene.n_bands),
                       order=order, lib=lib)
    assert out is got
    return got


def chain_ir(scene, params, order, cur):
    return cur + dfr.diffraction_ir(scene, params, sample_rate=SR,
                                    ir_length=cur.shape[1], order=order,
                                    use_kernels=False)


def assert_chain(got, want, cur, pats):
    """Bit for bit without patterns. With patterns the host's libm stands
    in for the card's sinf, cosf and atan2f (``cuda_emulation.py``), a few
    ulps from PyTorch's CPU kernels: the same bins change, each within
    1e-5 (on the card the kernels equal the card's chain bit for bit,
    tests/test_torch_cuda.py)."""
    if not pats:
        assert torch.equal(got, want)
        return
    assert torch.equal(got == cur, want == cur)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


CASES = [("walk3", 8, 1, False), ("walk5", 8, 1, True),
         ("walk4", 1, 2, True), ("walk8", 8, 2, False),
         ("walk12", 1, 1, False), ("split", 1, 1, False),
         ("doubled", 8, 2, True), ("smoll barrier", 1, 2, True),
         ("smoll barrier", 8, 1, False), ("barrier", 8, 2, True),
         ("scattered", 1, 1, True)]


@needs_gxx
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name,n_bands,n_listeners,pats", CASES)
def test_emulated_kernels_equal_the_chain(lib, name, n_bands, n_listeners,
                                          pats, order):
    scene, p = case(name, n_bands, n_listeners, pats)
    cur = torch.rand((n_listeners, T, n_bands),
                     generator=torch.Generator().manual_seed(7))
    got = kernel_ir(lib, scene, p, order, cur)
    want = chain_ir(scene, p, order, cur)
    assert_chain(got, want, cur, pats)
    if name not in ("walk12",):      # walk12 is lit: no path
        assert bool((want != cur).any())


@needs_gxx
def test_walk_circle_is_shadowed_and_lit_alike(lib):
    """All 16 poses of the walk at order 2 in 8 bands: the shadowed ones
    get paths, the lit ones none, each equal to the chain."""
    heard = []
    for i in range(16):
        scene, p = case(f"walk{i}", 8, 1, False)
        cur = torch.zeros((1, T, 8))
        got = kernel_ir(lib, scene, p, 2, cur)
        assert torch.equal(got, chain_ir(scene, p, 2, cur))
        heard.append(bool(got.any()))
    assert 0 < sum(heard) < 16


@needs_gxx
@pytest.mark.parametrize("gain", [2.5, 3, torch.tensor(2.5)])
def test_a_host_gain_divides_as_the_chain_divides(lib, gain):
    """A Python number's ``gain / x`` is ``x.reciprocal() * gain``, a
    tensor's a true division: the kernels follow either."""
    scene, p = case("walk5", 8, 2, False)
    p = p._replace(input_gain=gain)
    cur = torch.zeros((2, T, 8))
    want = chain_ir(scene, p, 2, cur)
    assert float(want.sum()) > 0
    assert_chain(kernel_ir(lib, scene, p, 2, cur), want, cur, False)


@needs_gxx
def test_segments_equal_the_chain_parts(lib):
    """The segment launch's edge weights, packed walls and, through K2's
    plain version, each family's visibility equal the chain's."""
    scene, p = case("walk4", 8, 2, False)
    x = dk.inputs(torch.zeros((2, 64, 8)), scene, p, sample_rate=SR,
                  band_freqs=dfr.band_frequencies(8), order=2)
    seg = dk.segments(x, lib)
    pts, weight = dfr.edge_table(scene)
    assert torch.equal(seg.edge[4], weight)
    assert torch.equal(seg.packed, tk.pack_walls(scene))
    clear = ~(tk.occlusion_min(seg.origins, seg.directions, seg.packed,
                               limit=seg.limit) < seg.limit)
    src, lis = p.source, p.listeners
    families = ((src, pts), (src, lis), (pts[None], lis[:, None]),
                (pts[:, None], pts[None]))
    want = dfr._segments_clear(families, scene, None)
    parts = clear.split([m.numel() for m in want])
    for got, w in zip(parts, want):
        assert torch.equal(got.reshape(w.shape), w)
    assert 0 < int(want[3].sum()) < want[3].numel()


@needs_gxx
@pytest.mark.parametrize("name,order", [("walk4", 2), ("scattered", 2),
                                        ("split", 1)])
def test_small_blocks_and_the_scratch_sort_equal_the_chain(tmp_path, name,
                                                           order):
    """The source with blocks of 32 threads and room for 4 keys in shared
    memory: the edge table takes several edges a thread, the compaction
    several tiles an order, the kept paths sort in the caller's scratch;
    the same bits."""
    small = tmp_path / "diffraction_kernel.cu"
    text = SOURCE.read_text()
    for a, b in (("constexpr int kSharedKeys = 2048;",
                  "constexpr int kSharedKeys = 4;"),
                 ("constexpr int kThreads = 256;",
                  "constexpr int kThreads = 32;")):
        assert a in text
        text = text.replace(a, b)
    small.write_text(text)
    lib_small = emulated(small, tmp_path / "emu")
    scene, p = case(name, 8, 2, False)
    cur = torch.zeros((2, T, 8))
    want = chain_ir(scene, p, order, cur)
    assert int((want != 0).any(-1).sum()) > 2
    assert torch.equal(kernel_ir(lib_small, scene, p, order, cur), want)


def _no_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(build, "load_library", refuse)


def _good():
    scene, p = case("walk4", 8, 2, True)
    return torch.zeros((2, 32, 8)), scene, p


BAD_INPUTS = {
    "ir dtype": lambda ir, s, p: (ir.double(), s, p),
    "ir shape": lambda ir, s, p: (ir[0], s, p),
    "ir strides": lambda ir, s, p: (ir.transpose(0, 1).contiguous()
                                    .transpose(0, 1), s, p),
    "ir listeners": lambda ir, s, p: (ir[:1], s, p),
    "ir bands": lambda ir, s, p: (ir[..., :4].contiguous(), s, p),
    "walls dtype": lambda ir, s, p: (ir, s._replace(a=s.a.double()), p),
    "walls shape": lambda ir, s, p: (ir, s._replace(b=s.b[:-1]), p),
    "mask dtype": lambda ir, s, p: (ir, s._replace(mask=s.mask.float()), p),
    "source shape": lambda ir, s, p: (ir, s, p._replace(
        source=p.source[None])),
    "listeners dtype": lambda ir, s, p: (ir, s, p._replace(
        listeners=p.listeners.double())),
    "speed of sound": lambda ir, s, p: (ir, s, p._replace(
        speed_of_sound=torch.ones(2))),
    "gain": lambda ir, s, p: (ir, s, p._replace(input_gain="1")),
    "source pattern": lambda ir, s, p: (ir, s, p._replace(
        directivity=p.directivity[None])),
    "mic pattern": lambda ir, s, p: (ir, s, p._replace(
        mic_directivity=torch.ones((3, 3)))),
    "pattern device": lambda ir, s, p: (ir, s, p._replace(
        directivity=p.directivity.to("meta"))),
}


@pytest.mark.parametrize("bad", list(BAD_INPUTS))
def test_malformed_inputs_raise_before_the_library(monkeypatch, bad):
    _no_library(monkeypatch)
    ir, s, p = BAD_INPUTS[bad](*_good())
    with pytest.raises(ValueError):
        dk.add_paths(ir, s, p, sample_rate=SR,
                     band_freqs=dfr.band_frequencies(8), order=2)


@pytest.mark.parametrize("kw", [dict(order=3), dict(sample_rate=0),
                                dict(band_freqs=[125.0, 250.0])])
def test_malformed_arguments_raise_before_the_library(monkeypatch, kw):
    _no_library(monkeypatch)
    ir, s, p = _good()
    args = dict(sample_rate=SR, band_freqs=dfr.band_frequencies(8), order=2)
    args.update(kw)
    with pytest.raises(ValueError):
        dk.add_paths(ir, s, p, **args)


def test_a_cpu_ir_is_refused_without_a_library(monkeypatch):
    _no_library(monkeypatch)
    ir, s, p = _good()
    with pytest.raises(ValueError, match="CUDA"):
        dk.add_paths(ir, s, p, sample_rate=SR,
                     band_freqs=dfr.band_frequencies(8), order=2)


@pytest.mark.parametrize("use_kernels", [None, True, False])
def test_a_cpu_scene_runs_the_chain(monkeypatch, use_kernels):
    """``diffraction_ir``, ``add_diffraction`` and ``_augment_ir`` on the
    CPU: the chain (K2's plain version with ``use_kernels`` True), never
    the kernels, and ``add_diffraction`` returns a new tensor."""
    _no_library(monkeypatch)
    before = (dk.segments.launches, dk.bin_paths.launches)
    scene, p = case("walk4", 8, 1, False)
    cur = torch.rand((1, 2000, 8))
    ir = dfr.diffraction_ir(scene, p, sample_rate=8000, ir_length=2000,
                            order=2, use_kernels=use_kernels)
    summed = dfr.add_diffraction(cur, scene, p, sample_rate=8000, order=2,
                                 use_kernels=use_kernels)
    assert summed is not cur and torch.equal(summed, cur + ir)
    assert float(ir.sum()) > 0
    aug = st._augment_ir(cur.clone(), scene, p, 8000, 2, None,
                         plain=use_kernels is False)
    assert torch.equal(aug, cur + ir)
    assert (dk.segments.launches, dk.bin_paths.launches) == before
