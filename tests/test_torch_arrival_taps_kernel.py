"""PyTorch port: per-arrival Doppler's tap kernels on the CPU.

On the card the composed stream's ``art.arrival.taps`` is two launches
(``ops/cuda/arrival_taps_kernel.py``): ``ear_taps`` (the mutual-nearest
match, four ear-field sets and the tap rows) and ``tap_synthesis`` (the
taps of every per-arrival stream, which reads a one-band stream's dry
history straight from the clip, a ``streaming.DryWindow``). Here:

* the CPU route is the plain chain bit for bit: ``ear_taps`` is
  ``streaming._ear_taps``, ``tap_synthesis`` and ``streaming._tap_chunk``
  are ``streaming._tap_chunk_plain`` (a DryWindow built by
  ``_device_window`` and gated), and a chunk step given a DryWindow
  equals the step given its tensor;
* the promotion of the chain's tap forms (scalar ``[L, A]`` delays, ``[L,
  A, 3]`` and ``[L, A, 3, K]`` gains and delays) into the kernel's
  arguments, and the window's host ints;
* the inputs the wrappers refuse (``ValueError`` before a launch);
* the kernel source itself, compiled for the CPU (``cuda_emulation.py``:
  a thread a CUDA thread, a barrier a ``__syncthreads``), against the
  chain: the match, flags and delays of the rows equal, the gains within
  the host libm's sin / atan2 of the card's (a few ulps), the taps
  within ``1e-5 max|dry| sum|g|`` (test_torch_doppler.py's
  ``_tap_limit``: the chain sums its terms in torch's reduction order,
  the kernel in row order).

The cases are the headphone cell's shapes (A = 6 taps, K = 1, n = 4,800,
T = 72,000, a 10,562-sample window at 48 kHz) and K = 4: taps at bin 0
and T - 1, reads before the window, a 64-bin glide (matched) beside a
65-bin one (not), the first chunk, no valid tap, every previous tap
vanished, a float64 speed of sound, the degenerate head, looped and
stopped windows. tests/test_torch_cuda_tap_kernel.py holds the kernels
on the card.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from cuda_emulation import available, emulated

from realisticaudioraytracing2d_tpu_torch import streaming as st
from realisticaudioraytracing2d_tpu_torch.ops import convolve as cv
from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
    arrival_taps_kernel as atk

SR = 48000
HEAD = dict(head_radius=0.0875, shadow=0.6)
# the headphone cell: 6 taps, 72,000 bins, 4,800-sample chunks, a 0.12 s
# early window (5,760 bins), its extraction window 5,718 bins
T, A, N, EARLY = 72000, 6, 4800, 5760
WD = N + EARLY + 2
MATCH_BINS = 64.0
SOURCE = (Path(__file__).resolve().parents[1]
          / "realisticaudioraytracing2d_tpu_torch" / "csrc"
          / "arrival_taps_kernel.cu")


def table(seed, n_l=1, n_a=A, n_k=1, bins=5718, idx=None, val=None):
    """A binaural tap table (``streaming.ArrivalCarry`` without its
    residual) from ``seed``: bins below ``bins``, about 70% valid, W >= 0
    and an intensity vector of up to 1.2 W at a uniform bearing."""
    g = np.random.default_rng(seed)
    if idx is None:
        idx = g.integers(0, bins, (n_l, n_a))
    if val is None:
        val = g.uniform(size=(n_l, n_a)) > 0.3
    w = g.exponential(size=(n_l, n_a, 3, n_k)).astype(np.float32)
    r = w * g.uniform(0.0, 1.2, w.shape)
    phi = g.uniform(-np.pi, np.pi, w.shape)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    return st.ArrivalCarry(None, torch.as_tensor(idx, dtype=torch.int64),
                           f(w), torch.as_tensor(val, dtype=torch.bool),
                           f(r * np.cos(phi)), f(r * np.sin(phi)))


def _moved(tab, shifts):
    """``tab`` with its first taps' bins moved by ``shifts``: the previous
    chunk's table of a table whose taps glide."""
    idx = tab.idx.clone()
    idx[:, :len(shifts)] += torch.tensor(shifts, dtype=torch.int64)
    return st.ArrivalCarry(None, idx, *(getattr(tab, f) for f in
                                        ("g3", "val", "x3", "y3")))


def ear_case(name):
    """``(cur, prev, facing, prev_facing, n_t, sample_rate, head_radius,
    shadow, speed_of_sound, decorrelate, match_bins)`` of case ``name``:
    ``ear_taps``' arguments."""
    c343 = torch.tensor(343.0)
    if name == "cell":
        cur = table(1)
        prev = _moved(table(2), ())
        prev.idx[0, :4] = cur.idx[0, :4] + torch.tensor([3, -5, 70, 0])
        return (cur, prev, 0.3, torch.tensor(0.1), T, SR, *HEAD.values(),
                c343, True, MATCH_BINS)
    if name == "edges":
        cur = table(3, idx=[[0, T - 1, 1, T - 2, 9000, 61]],
                    val=np.ones((1, A), bool))
        return (cur, _moved(cur, (0, 0, 2)), -1.5, 1.6, T, SR,
                *HEAD.values(), torch.tensor(120.0), True, MATCH_BINS)
    if name == "glide_64":
        cur = table(4, val=np.ones((1, A), bool),
                    idx=[[100, 900, 1700, 2500, 3300, 4100]])
        return (cur, _moved(cur, (64, -64, 65, -65)), 0.0, 0.2, T, SR,
                *HEAD.values(), c343, True, MATCH_BINS)
    if name == "is_first":
        cur = table(5)
        return (cur, cur, 0.8, 0.8, T, SR, *HEAD.values(), c343, True,
                MATCH_BINS)
    if name == "all_vanished":
        return (table(6, val=np.zeros((1, A), bool)),
                table(7, val=np.ones((1, A), bool)), 1.0, 0.5, T, SR,
                *HEAD.values(), c343, True, MATCH_BINS)
    if name == "none_valid":
        return (table(8, val=np.zeros((1, A), bool)),
                table(9, val=np.zeros((1, A), bool)), 1.0, 0.5, T, SR,
                *HEAD.values(), c343, True, MATCH_BINS)
    if name == "four_bands":
        cur = table(10, n_l=2, n_k=4)
        prev = _moved(table(11, n_l=2, n_k=4), ())
        prev.idx[:, :4] = cur.idx[:, :4] + 2
        return (cur, prev, 0.7, torch.tensor(0.2), T, SR, *HEAD.values(),
                torch.tensor(300.0, dtype=torch.float64), False, MATCH_BINS)
    if name == "degenerate_head":
        cur = table(12)
        return (cur, _moved(cur, (1, -1)), 2.0, 2.1, T, SR, 0.0, 0.0, c343,
                True, MATCH_BINS)
    raise KeyError(name)


EAR_CASES = ["cell", "edges", "glide_64", "is_first", "all_vanished",
             "none_valid", "four_bands", "degenerate_head"]


def clip(seed=20, samples=8 * N):
    """A noise clip with every seventh sample under the input gate."""
    g = np.random.default_rng(seed)
    x = g.normal(size=samples).astype(np.float32)
    x[::7] = 5e-5
    return torch.from_numpy(x)


def dry_window(name, dry=None):
    """A ``streaming.DryWindow`` of chunk ``i`` of a 40,000-sample clip,
    by case: looping mid-clip, looping across its end, the first looped
    chunk (its head before the stream: silence), not looping past the
    clip's end, cut by a stop at sample 17,000."""
    dry = clip() if dry is None else dry
    i, loop, stop = {"loop": (5, True, None), "wrap": (7, True, None),
                     "first": (0, True, None), "past_end": (8, False, None),
                     "stop": (3, False, 17000)}[name]
    return st.DryWindow(dry, WD, *st.window_scalars(i, N, WD, dry.shape[-1],
                                                    loop, stop), loop)


WINDOWS = ["loop", "wrap", "first", "past_end", "stop"]


def tap_rows(form, seed=30):
    """``(dry, tau0, tau1, g0, g1, valid, n)`` of a tap form: ``ears``
    (the cell's ``[2, 24, 3, 1]`` rows, a window tensor), ``ears_k4``
    (two listeners' ``[4, 24, 3, 4]``, a ``[4, Wd]`` band split),
    ``scalar`` (mono: ``[2, 12]`` delays and ``[2, 12, 3]`` gains),
    ``banded`` (``[2, 12]``
    delays, ``[2, 12, 3, 4]`` gains), ``per_bin`` (``[2, 12, 3]`` delays
    and gains), ``before_window`` (delays past the window's head, so some
    reads fall before it) and ``glide_64``."""
    g = np.random.default_rng(seed)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    window = f(g.normal(size=WD))
    bands = f(g.normal(size=(4, WD)))
    if form in ("ears", "ears_k4"):
        k = 1 if form == "ears" else 4
        ears = st._ear_taps(*ear_case("cell" if k == 1 else "four_bands"))
        return ((window if k == 1 else bands), ears.tau0, ears.tau1,
                ears.g0, ears.g1, ears.valid, N)
    shape = (2, 12)
    tau0 = g.uniform(1, EARLY, shape)
    glide = {"glide_64": 64.0}.get(form, 40.0)
    tau1 = np.clip(tau0 + g.choice([-glide, glide], shape)
                   * g.uniform(0.5, 1.0, shape), 0, WD - 3)
    if form == "before_window":
        tau0 = tau0 + (WD - N) - 50.0
        tau1 = tau1 + (WD - N) + 30.0
    g_shape = shape + ((3, 4) if form == "banded" else (3,))
    g0, g1 = f(np.abs(g.normal(size=g_shape))), f(np.abs(g.normal(
        size=g_shape)))
    valid = torch.from_numpy(g.uniform(size=shape) > 0.3)
    if form == "per_bin":
        off = np.arange(-1.0, 2.0)
        tau0, tau1 = tau0[..., None] + off, tau1[..., None] + off
    return ((bands if form == "banded" else window), f(tau0), f(tau1), g0,
            g1, valid, N)


FORMS = ["ears", "ears_k4", "scalar", "banded", "per_bin", "before_window",
         "glide_64"]


def tap_limit(dry, g0, g1, rel=1e-5):
    """test_torch_doppler.py's ``_tap_limit``: ``rel`` of ``max |dry|``
    times ``sum |g|``."""
    return rel * float(dry.abs().max()) * float(g0.abs().sum()
                                                + g1.abs().sum())


def _bits(x):
    return x.contiguous().view(torch.int32)


# ---- the CPU route is the chain ---------------------------------------------


@pytest.mark.parametrize("name", EAR_CASES)
def test_cpu_ear_taps_are_the_chain(name):
    before = atk.ear_taps.launches
    got = atk.ear_taps(*ear_case(name))
    want = st._ear_taps(*ear_case(name))
    assert atk.ear_taps.launches == before
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    n_l, n_a = want.j.shape
    assert want.tau0.shape == (2 * n_l, 4 * n_a, 3, want.tau0.shape[-1])


@pytest.mark.parametrize("form", FORMS)
def test_cpu_synthesis_is_the_chain(form):
    args = tap_rows(form)
    before = atk.tap_synthesis.launches
    want = st._tap_chunk_plain(*args)
    assert torch.equal(_bits(atk.tap_synthesis(*args)), _bits(want))
    assert torch.equal(_bits(st._tap_chunk(*args)), _bits(want))
    assert atk.tap_synthesis.launches == before
    assert want.shape == (args[1].shape[0], N) and float(
        want.abs().max()) > 0


@pytest.mark.parametrize("name", WINDOWS)
def test_cpu_window_synthesis_is_the_gated_window(name):
    w = dry_window(name)
    assert torch.equal(w.tensor(), st._device_window(
        w.dry, w.wd, w.start, w.prefix, w.cut, w.loop))
    _, tau0, tau1, g0, g1, valid, n = tap_rows("ears")
    got = atk.tap_synthesis(w, tau0, tau1, g0, g1, valid, n)
    want = st._tap_chunk_plain(cv.gate_input(w.tensor()), tau0, tau1, g0,
                               g1, valid, n)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("binaural", [False, True])
def test_a_step_given_a_dry_window_equals_the_step_given_its_tensor(
        binaural):
    """The composed and the mono per-arrival step read a DryWindow as the
    window tensor it stands for: the same wet chunk, taps and carry."""
    g = np.random.default_rng(40)
    n, t, early = 256, 900, 500
    wd = n + early + 2
    dry = clip(41, 3000)
    w = st.DryWindow(dry, wd, *st.window_scalars(4, n, wd, 3000, True,
                                                 None), True)
    irs = torch.from_numpy(g.exponential(size=(3 if binaural else 1, t,
                                               1)).astype(np.float32))
    irs[:, :early:37] *= 40.0
    if binaural:
        irs[1:] += irs[:1]                     # W + X, W + Y: a capture
    carry = st.init_arrival_carry(t, 2 if binaural else 1,
                                  binaural=binaural, device="cpu")
    outs = []
    for window in (w, w.tensor()):
        if binaural:
            outs.append(st._per_arrival_binaural(
                dry[:n], window, carry, irs, torch.tensor(0.2), 0.5, True,
                n, 8000, 0.0875, 0.6, torch.tensor(343.0), True))
        else:
            outs.append(st._per_arrival_parts(dry[:n], window, carry, irs,
                                              True, n, 1))
    (wet_a, taps_a, c_a), (wet_b, taps_b, c_b) = outs
    assert torch.equal(wet_a, wet_b) and torch.equal(taps_a, taps_b)
    assert float(taps_a.abs().max()) > 0
    for x, y in zip(c_a.tensors(), c_b.tensors()):
        assert torch.equal(x, y)


# ---- the kernel's arguments ------------------------------------------------


@pytest.mark.parametrize("form, promoted", [
    ("ears", (0, 1, 1, 1, 1)), ("ears_k4", (0, 4, 4, 4, 4)),
    ("scalar", (1, 1, 1, 1, 1)), ("banded", (1, 1, 4, 4, 4)),
    ("per_bin", (0, 1, 1, 1, 1))])
def test_synthesis_arguments_promote_each_form(form, promoted):
    """``(tau_scalar, Kt, Kg, Kd, K)``: a scalar delay is the chain's ``tau
    + (d - 1)``, a ``[L, R, 3]`` delay or gain the chain's ``[L, R, 3,
    1]``, broadcast over the bands."""
    dry, tau0, tau1, g0, g1, valid, n = tap_rows(form)
    args = atk.synthesis_inputs(dry, tau0, tau1, g0, g1, valid, n)
    (rows, n_dry, total, wd, start, prefix, cut, loop, gate, eps, t0, t1,
     tau_scalar, n_kt, h0, h1, n_kg, val, n_l, n_r, n_k, n_out,
     inv_n) = args
    assert (tau_scalar, n_kt, n_kg, n_dry, n_k) == promoted
    assert (n_l, n_r, n_out) == (*valid.shape, n)
    assert (total, wd, start, prefix, cut, loop, gate) == (
        WD, WD, 0, 0, WD, 0, 0)
    assert rows.shape == (n_dry, WD) and rows.is_contiguous()
    assert torch.equal(t0, tau0) and torch.equal(h1, g1)
    assert torch.equal(val, valid) and t1.shape == tau1.shape
    assert inv_n == float(np.float32(1.0) / np.float32(n))
    assert eps == float(np.float32(cv.EPS))
    assert len(args) + 2 == len(atk._SYNTH_ARGTYPES)


@pytest.mark.parametrize("name", WINDOWS)
def test_synthesis_arguments_of_a_dry_window(name):
    w = dry_window(name)
    args = atk.synthesis_inputs(w, *tap_rows("ears")[1:])
    assert args[0] is w.dry or args[0].data_ptr() == w.dry.data_ptr()
    assert args[1:10] == [1, w.dry.numel(), WD, w.start,
                          min(max(w.prefix, 0), WD),
                          min(max(w.cut, 0), WD), int(w.loop), 1,
                          float(np.float32(cv.EPS))]


@pytest.mark.parametrize("name", ["cell", "four_bands", "degenerate_head"])
def test_ear_arguments(name):
    case = ear_case(name)
    args = atk.ear_inputs(*case)
    cur, prev, facing, prev_facing, n_t, sr, radius, shadow, speed, decorr, \
        bins = case
    assert len(args) + 4 == len(atk._EAR_ARGTYPES)
    assert args[10:14] == [*cur.g3.shape[:2], cur.g3.shape[-1], n_t]
    if decorr and radius > 0.0:                # the ears' [1, T, 1] signs
        assert all(s.shape == (1, n_t, 1) for s in args[24:26])
    else:
        assert args[24:26] == [None, None]
    # on the CPU (the emulation) a CPU tensor is read by pointer; on the
    # card it is a host number
    if isinstance(prev_facing, torch.Tensor):
        assert args[16].data_ptr() == prev_facing.data_ptr()
        assert args[17] == 0.0
    else:
        assert args[16] is None and args[17] == prev_facing
    assert args[26] == bins and args[21] == float(sr)
    outs = atk.ear_outputs(*args[10:13], torch.device("cpu"))
    res = atk.ear_result(*outs)
    assert res.tau0.data_ptr() == outs[0].data_ptr()
    assert res.valid.shape == (2 * args[10], 4 * args[11])
    assert res.vanished.shape == res.mutual.shape == res.j.shape


# ---- what the wrappers refuse ----------------------------------------------


def _refused_synthesis():
    dry, tau0, tau1, g0, g1, valid, n = tap_rows("ears")
    w = dry_window("loop")
    return {
        "dry float64": (dry.double(), tau0, tau1, g0, g1, valid, n),
        "dry 3-d": (dry[None, None], tau0, tau1, g0, g1, valid, n),
        "dry list": (list(dry), tau0, tau1, g0, g1, valid, n),
        "tau0 and tau1 differ": (dry, tau0, tau1[:, :-1], g0, g1, valid, n),
        "g float64": (dry, tau0, tau1, g0.double(), g1.double(), valid, n),
        "valid not bool": (dry, tau0, tau1, g0, g1, valid.float(), n),
        "valid 1-d": (dry, tau0, tau1, g0, g1, valid[0], n),
        "tau rows": (dry, tau0[:, :5], tau1[:, :5], g0, g1, valid, n),
        "tau bins": (dry, tau0[:, :, :2], tau1[:, :, :2], g0, g1, valid, n),
        "g 2-d": (dry, tau0, tau1, g0[..., 0, 0], g1[..., 0, 0], valid, n),
        "bands": (torch.zeros(3, WD), tau0.expand(-1, -1, -1, 2),
                  tau1.expand(-1, -1, -1, 2), g0, g1, valid, n),
        "n": (dry, tau0, tau1, g0, g1, valid, 0),
        "window clip 2-d": (dataclasses.replace(w, dry=w.dry[None]), tau0,
                            tau1, g0, g1, valid, n),
        "window wd": (dataclasses.replace(w, wd=0), tau0, tau1, g0, g1,
                      valid, n),
        "window loop start": (dataclasses.replace(w, start=-1), tau0, tau1,
                              g0, g1, valid, n),
        "device": (dry, tau0.to("meta"), tau1, g0, g1, valid, n),
    }


@pytest.mark.parametrize("case", sorted(_refused_synthesis()))
def test_synthesis_refuses(case):
    with pytest.raises(ValueError):
        atk.synthesis_inputs(*_refused_synthesis()[case])


def _refused_ears():
    args = list(ear_case("cell"))
    cur, prev = args[0], args[1]

    def swap(t, **kw):
        return st.ArrivalCarry(None, *(kw.get(f, getattr(t, f)) for f in
                                       ("idx", "g3", "val", "x3", "y3")))

    def with_args(**kw):
        names = ["cur", "prev", "facing", "prev_facing", "n_t",
                 "sample_rate", "head_radius", "shadow", "speed", "decorr",
                 "bins"]
        return [kw.get(n, a) for n, a in zip(names, args)]

    return {
        "idx int32": with_args(cur=swap(cur, idx=cur.idx.int())),
        "val float": with_args(prev=swap(prev, val=prev.val.float())),
        "g3 float64": with_args(cur=swap(cur, g3=cur.g3.double())),
        "x3 shape": with_args(prev=swap(prev, x3=prev.x3[..., :2, :])),
        "prev taps": with_args(prev=table(3, n_a=A - 1)),
        "prev bands": with_args(prev=table(3, n_k=2)),
        "idx 1-d": with_args(cur=swap(cur, idx=cur.idx[0])),
        "y3 missing": with_args(cur=swap(cur, y3=None)),
        "facing 2 elements": with_args(facing=torch.zeros(2)),
        "facing int": with_args(prev_facing=torch.tensor(1)),
        "facing string": with_args(facing="north"),
        "speed int": with_args(speed=torch.tensor(343)),
        "shadow": with_args(shadow=1.5),
        "bins": with_args(n_t=0),
        "device": with_args(prev=swap(prev, g3=prev.g3.to("meta"))),
    }


@pytest.mark.parametrize("case", sorted(_refused_ears()))
def test_ear_taps_refuse(case):
    with pytest.raises(ValueError):
        atk.ear_inputs(*_refused_ears()[case])


# ---- the kernel source, emulated on the CPU ---------------------------------


@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    if not available():
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return atk.bind(emulated(SOURCE, tmp_path_factory.mktemp("taps")))


def _emulated_ears(fns, args):
    inputs = atk.ear_inputs(*args)
    out = atk.ear_outputs(*inputs[10:13], torch.device("cpu"))
    assert fns["art_ear_taps"](*atk.pointers(inputs + list(out)), None) == 0
    return atk.ear_result(*out)


def _emulated_synthesis(fns, *args):
    inputs = atk.synthesis_inputs(*args)
    out = torch.full((args[5].shape[0], args[6]), float("nan"))
    assert fns["art_tap_synthesis"](*atk.pointers(inputs), out.data_ptr(),
                                    None) == 0
    return out


@pytest.mark.parametrize("name", EAR_CASES)
def test_emulated_ear_taps_equal_the_chain(emulation, name):
    """Flags and match equal; delays and gains within two ulps plus what
    a gap of 2^-18 in the sine (the host's sinf / atan2f against torch's,
    a few ulps) moves them: ``max_shift`` times it for a delay, the
    largest W times it for a gain. So the kernel's rows, row order, ears
    and match are the chain's."""
    args = ear_case(name)
    got = _emulated_ears(emulation, args)
    want = st._ear_taps(*args)
    for f in ("valid", "j", "mutual", "vanished"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    cur, prev = args[:2]
    ms = atk.max_shift_known(args[6], args[5], args[8])
    w_max = max(float(cur.g3.abs().max()), float(prev.g3.abs().max()))
    for f in ("tau0", "tau1", "g0", "g1"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape
        move = 2.0 ** -18 * (ms if f.startswith("tau") else w_max)
        limit = 2 * np.spacing(np.abs(w.numpy())) + move
        assert bool((np.abs((g - w).numpy()) <= limit).all()), f
    if name == "glide_64":
        assert want.mutual[0].tolist() == [True, True, False, False, True,
                                           True]
    if name == "all_vanished":
        assert bool(want.vanished.all())


@pytest.mark.parametrize("form", FORMS)
def test_emulated_synthesis_within_the_tap_limit(emulation, form):
    args = tap_rows(form)
    got = _emulated_synthesis(emulation, *args)
    want = st._tap_chunk_plain(*args)
    dry, _, _, g0, g1, _, _ = args
    assert float((got - want).abs().max()) <= tap_limit(dry, g0, g1)
    assert float(want.abs().max()) > 0


@pytest.mark.parametrize("name", WINDOWS)
def test_emulated_window_reads_are_the_gated_window(emulation, name):
    w = dry_window(name)
    rows = tap_rows("ears")[1:]
    got = _emulated_synthesis(emulation, w, *rows)
    gated = cv.gate_input(w.tensor())
    want = st._tap_chunk_plain(gated, *rows)
    assert float((got - want).abs().max()) <= tap_limit(gated, *rows[2:4])
    if name in ("stop", "first", "past_end"):
        assert bool((gated == 0).any())
