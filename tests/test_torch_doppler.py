"""PyTorch port: per-arrival and shared-rate Doppler streams.

The same numpy inputs (or JAX's own draws, fed through ``uniforms_fn``)
go through the JAX package's ``streaming`` functions and the port's:

* the arrival table (``_window3``, ``_arrival_table`` with tied scores and
  edge bins, ``_match_arrivals``, ``_remove_taps``), ``_band_windows``,
  the history window (``window_scalars``, ``_device_window``,
  ``dry_history_window`` at chunk ~10^6, past int32 sample positions),
  the tap synthesis ``_tap_chunk``, the chunk steps ``_per_arrival_parts``
  and ``_per_arrival_binaural``, ``warp_chunk`` and ``DopplerFeed``;
* ``Streamer.stream_clip(doppler="per_arrival")`` at K = 1, K = 4,
  binaural and binaural x 4 bands (the composition the JAX tests never
  ran), a JAX per-arrival state carried across by ``convert``,
  ``doppler=True``, and the ``reset_ir`` / stop controls;
* port-only twins of JAX's physics tests, with JAX's own bounds.

Tolerances:

* integers and masks (tap bins, validity, matches, window scalars, feed
  positions) are equal; gathers and masks of equal numbers (``g3``, the
  residuals, the windows, a K = 1 band split) equal bit for bit;
* a band split at K > 1 within 1e-6 of the window's peak (two FFT
  libraries round differently);
* ``_tap_chunk`` (its ramp multiplies by the float32 ``1 / n``, as XLA
  compiles the jitted step) against eager JAX (which divides) and jitted
  JAX (which also fuses ``tau0 + (tau1 - tau0) r`` and the interpolation
  into multiply-adds) within 1e-5 of ``sum |g| * max |dry|``: an ulp of
  the ramp or of a delay moves a read position by an ulp (6e-5 below
  1,024 samples), and ``floor(p)`` and its fraction move together, so the
  read moves by that times the dry's slope; with static integer delays
  bit for bit;
* ``warp_chunk`` and ``DopplerFeed`` bit for bit: the port rounds the
  read position and the interpolation once from float64, the value of
  XLA's fused multiply-adds;
* streams within test_torch_streaming.py's rtol 2e-3 and an atol of 1e-4
  of the stream's peak (the taps' order of summation and the multiply-adds
  above, through up to 9 chunks of crossfade); their tap bins equal
  chunk by chunk, so the residual IRs differ from JAX's only where the
  traced IRs do (held within test_torch_spatial.py's directive trace
  limit, rtol 1e-4 and atol 1e-6 of the peak: fed JAX's draws, a bin sums
  its hits in another order than XLA's scatter-add, and XLA's fused
  multiply-adds move a razor-edge hit's splat, ROADMAP section 3, PR 7);
  the binaural ones' decoded residuals within test_torch_spatial.py's
  decode limit (four target-bin spacings of the largest deposit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_chunk_uniforms, to_numpy, to_torch

import realisticaudioraytracing2d_tpu as jart
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu import streaming as jst
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch import streaming as st
from realisticaudioraytracing2d_tpu_torch.utils.audio_io import noise_burst

STREAM_RTOL = 2e-3
DECODE_FLIPS = 4


def _j(x):
    return jnp.asarray(np.asarray(x))


# JAX's table functions jitted (integer and mask outputs; one compile
# each instead of one per eager operation)
_jax_table = jax.jit(jst._arrival_table, static_argnums=(1, 2))
_jax_match = jax.jit(jst._match_arrivals, static_argnums=(5,))
_jax_remove = jax.jit(jst._remove_taps)
# the chunk steps jitted, as JAX's stream step runs them: the port's
# steps take the stream's form of the tap ramp
_jax_parts = jax.jit(jst._per_arrival_parts, static_argnums=(4, 5, 6))
_jax_binaural = jax.jit(jst._per_arrival_binaural,
                        static_argnums=(6, 7, 8, 9, 10, 12))


def _t(x):
    return to_torch(np.asarray(x))


def _stream_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=STREAM_RTOL,
                               atol=1e-4 * np.abs(want).max())


def _decoded_close(got, want, shadow=0.6):
    """test_torch_spatial.py's limit: four float32 target-bin spacings of
    the largest deposit, ``(1 + shadow) * max W``, bounded here by the
    decoded IR's own peak."""
    got, want = np.asarray(got), np.asarray(want)
    n_t = want.shape[-2]
    move = (1.0 + shadow) * float(np.abs(want).max()) * float(
        np.spacing(np.float32(n_t)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=DECODE_FLIPS * move
                               + 1e-6 * np.abs(want).max())


def _table_equal(got, want):
    (gi, gg, gv), (wi, wg, wv) = got, want
    np.testing.assert_array_equal(to_numpy(gi), np.asarray(wi))
    np.testing.assert_array_equal(to_numpy(gv), np.asarray(wv))
    np.testing.assert_array_equal(to_numpy(gg), np.asarray(wg))


def _sparse_ir(rng, n_l, t, k, n_peaks=40):
    e = np.zeros((n_l, t, k), np.float32)
    for li in range(n_l):
        bins = rng.choice(t, n_peaks, replace=False)
        e[li, bins] = rng.exponential(size=(n_peaks, k))
        e[li, bins + 1 - (bins == t - 1)] += 0.3 * rng.exponential(
            size=(n_peaks, k))
    e[0, 0] = 2.0                                   # edge taps
    e[-1, t - 1] = 1.5
    return e.astype(np.float32)


# ---- the arrival table ------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_arrival_table_matches_jax(k):
    rng = np.random.default_rng(k)
    e = _sparse_ir(rng, 2, 400, k)
    for early, taps in ((300, 8), (400, 6), (37, 3)):
        got = st._arrival_table(_t(e), early, taps)
        want = _jax_table(_j(e), early, taps)
        _table_equal(got, want)
    idx = rng.integers(0, 400, (2, 9))
    idx[0, :2] = (0, 399)                           # masked neighbours
    np.testing.assert_array_equal(
        to_numpy(st._window3(_t(e), _t(idx))),
        np.asarray(jst._window3(_j(e), _j(idx.astype(np.int32)))))


def test_arrival_table_ties_follow_top_k():
    # equal peaks (a symmetric room), mirrored windows [a, b, c] / [c, b, a]
    # of equal sums, two equal peaks 2 bins apart (the earlier-ranked one
    # wins the clash), and more slots than maxima: the -1 scores tie and
    # top_k takes them in bin order
    t = 256
    e = np.zeros((2, t, 1), np.float32)
    for b in (50, 80, 110, 140):
        e[0, b - 1:b + 2, 0] = (0.25, 1.0, 0.5)
    e[0, 200, 0], e[0, 202, 0] = 1.75, 1.75
    e[1, 30:33, 0] = (0.1, 0.7, 0.3)
    e[1, 60:63, 0] = (0.3, 0.7, 0.1)
    for taps in (4, 8, 12):
        got = st._arrival_table(_t(e), t, taps)
        want = _jax_table(_j(e), t, taps)
        _table_equal(got, want)
    idx, _, valid = got
    assert to_numpy(idx)[0, :6].tolist() == [50, 80, 110, 140, 200, 202]
    assert to_numpy(valid)[0, :6].tolist() == [True] * 5 + [False]
    assert to_numpy(idx)[0, 6:].tolist() == list(range(6))


def test_arrival_table_edge_bins_and_window_edge():
    # JAX's edge-bin test: out-of-range neighbours are masked, so the taps
    # remove exactly what they carry; a peak just past the window spawns
    # no rising-edge tap
    t = 64
    e = np.zeros((1, t, 1), np.float32)
    e[0, 0, 0], e[0, t - 1, 0] = 1.0, 0.8
    idx, g3, valid = st._arrival_table(_t(e), t, 4)
    res = st._remove_taps(_t(e), idx, valid)
    removed = float(e.sum() - res.sum())
    kept = float(torch.where(valid, g3.sum(dim=(-1, -2)), 0.0).sum())
    assert removed == pytest.approx(1.8, rel=1e-6)
    assert kept == pytest.approx(removed, rel=1e-6)
    e = np.zeros((1, 512, 1), np.float32)
    e[0, 199, 0], e[0, 200, 0] = 0.6, 1.0
    assert not bool(st._arrival_table(_t(e), 200, 4)[2].any())


def test_match_and_remove_taps_match_jax():
    rng = np.random.default_rng(7)
    n_l, a, t, k = 3, 8, 300, 2
    idx_c = rng.integers(0, t, (n_l, a))
    idx_p = np.clip(idx_c + rng.integers(-80, 80, (n_l, a)), 0, t - 1)
    idx_p[:, ::2] = rng.integers(0, t, (n_l, (a + 1) // 2))
    val_c = rng.uniform(size=(n_l, a)) > 0.25
    val_p = rng.uniform(size=(n_l, a)) > 0.25
    val_p[2] = False                                # nothing to glide from
    g3_p = rng.exponential(size=(n_l, a, 3, k)).astype(np.float32)
    for bins in (64.0, 10.0):
        got = st._match_arrivals(_t(idx_c), _t(val_c), _t(idx_p),
                                 _t(g3_p), _t(val_p), bins)
        want = _jax_match(_j(idx_c.astype(np.int32)), _j(val_c),
                          _j(idx_p.astype(np.int32)), _j(g3_p), _j(val_p),
                          bins)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    assert bool(got[2].any()) and not bool(got[4][2].any())
    ir = rng.exponential(size=(n_l, t, k)).astype(np.float32)
    idx_c[0, 0], idx_c[1, 0] = 0, t - 1
    val_c[:, 0] = True
    np.testing.assert_array_equal(
        to_numpy(st._remove_taps(_t(ir), _t(idx_c), _t(val_c))),
        np.asarray(_jax_remove(_j(ir), _j(idx_c.astype(np.int32)),
                               _j(val_c))))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_band_windows_match_jax(k):
    x = np.random.default_rng(k).normal(size=762).astype(np.float32)
    got = to_numpy(st._band_windows(_t(x), k))
    want = np.asarray(jst._band_windows(_j(x), k))
    assert got.shape == want.shape == (k, 762)
    if k == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(x).max())
        np.testing.assert_allclose(got.sum(0), x, atol=1e-5)


# ---- the history window -----------------------------------------------------


def test_window_scalars_and_device_window_match_jax():
    total, n, wd = 1000, 64, 230
    dry = np.arange(1, total + 1, dtype=np.float32)
    for loop in (False, True):
        for i in (0, 1, 3, 14, 15, 16, 40, 10 ** 6 + 3):
            for stop_at in (None, 5 * n, (i + 1) * n - 10):
                got = st.window_scalars(i, n, wd, total, loop, stop_at)
                assert got == jst.window_scalars(i, n, wd, total, loop,
                                                 stop_at)
                np.testing.assert_array_equal(
                    to_numpy(st._device_window(_t(dry), wd, *got, loop)),
                    np.asarray(jst._device_window(
                        _j(dry), wd, *(jnp.asarray(v, jnp.int32)
                                       for v in got), loop)))


@pytest.mark.parametrize("loop", [False, True])
def test_dry_history_window_far_into_a_stream(loop):
    # chunk ~10^6 of 4,800-sample chunks: (i + 1) * n is past 2^32, where
    # an int32 device position would have wrapped
    dry = np.random.default_rng(2).normal(size=7001).astype(np.float32)
    n, early = 4800, 60
    for i in (0, 1, 10 ** 6, 10 ** 6 + 7):
        assert (i + 1) * n < 2 ** 31 or i >= 10 ** 6
        got = to_numpy(st.dry_history_window(_t(dry), i, n, early, loop))
        want = np.asarray(jst.dry_history_window(_j(dry), i, n, early, loop))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (n + early + 2,)
    # loop: the history before the stream began is silence
    w0 = to_numpy(st.dry_history_window(_t(dry), 0, 64, 32, True))
    assert (w0[:34] == 0).all() and np.array_equal(w0[34:], dry[:64])
    if loop:
        assert np.abs(got).max() > 0


# ---- tap synthesis ----------------------------------------------------------


def _tap_inputs(rng, shape, k, n, early, glide=64.0):
    wd = n + early + 2
    dry = rng.normal(size=(k, wd) if k > 1 else (wd,)).astype(np.float32)
    tau0 = rng.uniform(1, early, shape).astype(np.float32)
    tau1 = (tau0 + rng.uniform(-glide, glide, shape)).astype(np.float32)
    tau1 = np.clip(tau1, 0, wd - 3)
    g_shape = shape + (3,) if len(shape) == 2 else shape
    g0 = np.abs(rng.normal(size=g_shape)).astype(np.float32)
    g1 = np.abs(rng.normal(size=g_shape)).astype(np.float32)
    val = rng.uniform(size=shape[:2]) > 0.3
    return dry, tau0, tau1, g0, g1, val


def _tap_limit(dry, g0, g1, rel):
    return rel * float(np.abs(dry).max()) * float(
        np.abs(g0).sum() + np.abs(g1).sum())


@pytest.mark.parametrize("form", ["scalar", "banded", "binaural"])
def test_tap_chunk_matches_jax(form):
    rng = np.random.default_rng({"scalar": 0, "banded": 1,
                                 "binaural": 2}[form])
    n, early = 400, 500
    if form == "binaural":
        args = _tap_inputs(rng, (2, 24, 3, 1), 1, n, early, glide=80.0)
    else:
        args = _tap_inputs(rng, (2, 12), 4 if form == "banded" else 1, n,
                           early)
    eager = np.asarray(jst._tap_chunk(*(_j(a) for a in args), n))
    got = to_numpy(st._tap_chunk(*(_t(a) for a in args), n))
    assert got.shape == eager.shape == (2, n) and np.abs(eager).max() > 0.1
    dry, _, _, g0, g1, _ = args
    np.testing.assert_allclose(got, eager, rtol=0,
                               atol=_tap_limit(dry, g0, g1, 1e-5))
    jitted = np.asarray(jax.jit(lambda *x: jst._tap_chunk(*x, n))(
        *(_j(a) for a in args)))
    np.testing.assert_allclose(got, jitted, rtol=0,
                               atol=_tap_limit(dry, g0, g1, 1e-5))


def test_tap_chunk_static_integer_delays_are_exact_reads():
    # tau0 == tau1 integer: every read is a dry sample, so the taps are the
    # removed bins' convolution; one tap alone equals JAX's bit for bit
    rng = np.random.default_rng(4)
    n, early = 256, 300
    wd = n + early + 2
    dry = rng.normal(size=wd).astype(np.float32)
    tau = np.asarray([[117.0]], np.float32)
    g = np.asarray([[[0.5, 2.0, 0.25]]], np.float32)
    args = (dry, tau, tau, g, g, np.ones((1, 1), bool))
    got = to_numpy(st._tap_chunk(*(_t(a) for a in args), n))[0]
    s = np.arange(n)
    want = sum(g[0, 0, d + 1] * dry[wd - n + s - 117 - d]
               for d in (-1, 0, 1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        to_numpy(st._tap_chunk(*(_t(a) for a in args), n)),
        np.asarray(jst._tap_chunk(*(_j(a) for a in args), n)))


def test_tap_chunk_glide_rate_is_doppler():
    # JAX's test and bounds: a tap whose delay shrinks by 20 bins across
    # the chunk reads 1 + 20 / n dry samples per output sample. The
    # frequency comes from the zero crossings' interpolated times (a count
    # of crossings resolves only sr / 2n = 5 Hz, the size of the shift)
    sr, n, f0, early = 8000, 800, 400.0, 200
    dry = _t(np.sin(2 * np.pi * f0 * np.arange(4 * n) / sr
                    ).astype(np.float32))
    window = st.dry_history_window(dry, 2, n, early, loop=False)
    g = torch.tensor([[[0.0, 1.0, 0.0]]])
    y = to_numpy(st._tap_chunk(window, torch.tensor([[150.0]]),
                               torch.tensor([[130.0]]), g, g,
                               torch.tensor([[True]]), n))[0]
    at = np.flatnonzero(np.diff(np.signbit(y)))
    at = at + y[at] / (y[at] - y[at + 1])
    f_meas = (len(at) - 1) * sr / (2.0 * (at[-1] - at[0]))
    assert f_meas == pytest.approx(f0 * (1.0 + 20.0 / n), rel=0.02)
    assert abs(f_meas - f0) > 5.0


# ---- the chunk steps --------------------------------------------------------


def _carry_from_jax(c):
    return convert.arrival_carry_from_arrays(c, device="cpu")


@pytest.mark.parametrize("k", [1, 2])
def test_per_arrival_parts_matches_jax(k):
    # a previous IR with arrivals that move, one that vanishes and a new
    # one: the carry, the residual crossfade and the taps
    rng = np.random.default_rng(10 + k)
    n, t = 256, 700
    early = 400
    wd = n + early + 2
    prev = np.zeros((1, t, k), np.float32)
    cur = np.zeros((1, t, k), np.float32)
    for b, v in ((100, 1.0), (180, 0.6), (260, 0.4), (330, 0.3)):
        prev[0, b] = v * rng.uniform(0.5, 1.0, k)
    for b, v in ((104, 1.0), (176, 0.6), (300, 0.5)):
        cur[0, b] = v * rng.uniform(0.5, 1.0, k)
    tail = rng.exponential(size=(1, t - early, k)).astype(np.float32) * 1e-2
    prev[:, early:] += tail
    cur[:, early:] += tail[:, ::-1]
    window = (rng.normal(size=wd) * 0.5).astype(np.float32)
    jt = jst._arrival_table(_j(prev), early, 6)
    carry = jst.ArrivalCarry(jst._remove_taps(_j(prev), jt[0], jt[2]), *jt)
    want = _jax_parts(_j(window[-n:]), _j(window), carry, _j(cur), False,
                      n, k)
    got = st._per_arrival_parts(_t(window[-n:]), _t(window),
                                _carry_from_jax(carry), _t(cur), False, n,
                                k)
    np.testing.assert_allclose(to_numpy(got[0]), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6 * float(
                                   np.abs(want[0]).max()))
    np.testing.assert_allclose(to_numpy(got[1]), np.asarray(want[1]),
                               rtol=0, atol=1e-5 * np.abs(window).max())
    assert np.abs(np.asarray(want[1])).max() > 0.1
    for g, w in zip(got[2].tensors(), want[2]):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    # the first chunk reads its own products as the previous ones
    first = st._per_arrival_parts(_t(window[-n:]), _t(window),
                                  _carry_from_jax(carry), _t(cur), True, n,
                                  k)
    want1 = _jax_parts(_j(window[-n:]), _j(window), carry, _j(cur), True,
                       n, k)
    np.testing.assert_allclose(to_numpy(first[1]), np.asarray(want1[1]),
                               rtol=0, atol=1e-5 * np.abs(window).max())


def test_vanished_arrival_fades_out_instead_of_clicking():
    # JAX's test: an arrival valid in prev but absent from cur was removed
    # from the previous chunk's pushed tail, so it fades out as a tap
    n, t, tau, g = 256, 400, 100, 1.0
    prev_ir = torch.zeros(1, t, 1)
    prev_ir[0, tau, 0] = g
    early = 300
    wd = n + early + 2
    dry_window = torch.from_numpy(
        np.random.default_rng(0).normal(size=wd).astype(np.float32))
    idx_p, g3_p, val_p = st._arrival_table(prev_ir, early, st._ARRIVAL_TAPS)
    carry = st.ArrivalCarry(st._remove_taps(prev_ir, idx_p, val_p), idx_p,
                            g3_p, val_p)
    _, taps, _ = st._per_arrival_parts(dry_window[-n:], dry_window, carry,
                                       torch.zeros(1, t, 1), False, n, 1)
    s = np.arange(n)
    dw = to_numpy(dry_window)
    dw = np.where(np.abs(dw) > 1e-4, dw, 0.0)            # the input gate
    want = (1.0 - s / n) * dw[wd - n + s - tau] * g
    np.testing.assert_allclose(to_numpy(taps)[0], want, atol=1e-5)
    assert float(carry.res.sum()) == 0.0


def _capture(rng, t, k, peaks):
    """A [3, T, K] spatial capture (W, W + X, W + Y) of hits at ``peaks``
    (bin, energy, bearing), plus a diffuse tail."""
    w = np.zeros((1, t, k), np.float32)
    x = np.zeros_like(w)
    y = np.zeros_like(w)
    for b, e, th in peaks:
        band = e * rng.uniform(0.5, 1.0, k)
        w[0, b] += band
        x[0, b] += band * np.cos(th)
        y[0, b] += band * np.sin(th)
    tail = rng.exponential(size=(1, t, k)) * 1e-3
    w += tail
    th = rng.uniform(-np.pi, np.pi, (1, t, k))
    x += 0.3 * tail * np.cos(th)
    y += 0.3 * tail * np.sin(th)
    return np.concatenate([w, w + x, w + y]).astype(np.float32)


@pytest.mark.parametrize("k", [1, 4])
def test_per_arrival_binaural_matches_jax(k):
    rng = np.random.default_rng(20 + k)
    n, t, early, sr = 256, 900, 500, 8000
    wd = n + early + 2
    prev = _capture(rng, t, k, ((120, 1.0, 0.4), (210, 0.5, -1.2),
                                (330, 0.3, 2.5)))
    cur = _capture(rng, t, k, ((123, 1.0, 0.45), (206, 0.5, -1.1),
                               (400, 0.4, 3.0)))
    window = (rng.normal(size=wd) * 0.5).astype(np.float32)
    c = jnp.float32(343.0)
    # the previous chunk's products: JAX's first chunk on `prev`
    _, _, carry = _jax_binaural(
        _j(window[-n:]), _j(window),
        jst.init_arrival_carry(t, 2, k, binaural=True), _j(prev),
        jnp.float32(0.2), jnp.float32(0.2), True, n, sr, 0.0875, 0.6, c,
        True)
    want = _jax_binaural(
        _j(window[-n:]), _j(window), carry, _j(cur), jnp.float32(0.2),
        jnp.float32(0.5), False, n, sr, 0.0875, 0.6, c, True)
    got = st._per_arrival_binaural(
        _t(window[-n:]), _t(window), _carry_from_jax(carry), _t(cur),
        torch.tensor(0.2), 0.5, False, n, sr, 0.0875, 0.6,
        torch.tensor(343.0), True)
    _decoded_close(to_numpy(got[2].res), np.asarray(want[2].res))
    for f in ("idx", "val", "g3", "x3", "y3"):
        np.testing.assert_array_equal(to_numpy(getattr(got[2], f)),
                                      np.asarray(getattr(want[2], f)))
    w_taps = np.asarray(want[1])
    assert w_taps.shape == (2, n) and not np.allclose(w_taps[0], w_taps[1])
    np.testing.assert_allclose(to_numpy(got[1]), w_taps, rtol=0,
                               atol=1e-5 * np.abs(window).max())
    np.testing.assert_allclose(to_numpy(got[0]), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5 * np.abs(
                                   np.asarray(want[0])).max())


# ---- the shared-rate feed ---------------------------------------------------


def test_warp_chunk_matches_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    dry = rng.normal(size=3000).astype(np.float32)
    for loop in (False, True):
        for base, frac, rate, n in ((0, 0.0, 1.0, 256), (17, 0.3125, 0.93,
                                                          400),
                                    (2500, 0.7, 1.07, 700),
                                    (2990, 0.1, 1.2, 64),
                                    (3001, 0.0, 1.0, 64)):
            want = np.asarray(jst.warp_chunk(
                _j(dry), jnp.asarray(base, jnp.int32),
                jnp.asarray(frac, jnp.float32),
                jnp.asarray(rate, jnp.float32), n, loop=loop))
            got = to_numpy(st.warp_chunk(_t(dry), base, frac, rate, n,
                                         loop=loop))
            np.testing.assert_array_equal(got, want)
    # rate 1 is the identity; past the end, silence
    a = to_numpy(st.warp_chunk(_t(dry), 128, 0.0, 1.0, 128))
    np.testing.assert_array_equal(a, dry[128:256])
    assert not to_numpy(st.warp_chunk(_t(dry), 3000, 0.0, 1.0, 64)).any()
    # an absolute position past 2^24 (unrepresentable in float32) reads
    # the right samples through the int base
    big = np.zeros(2 ** 24 + 128, np.float32)
    seg = rng.normal(size=66).astype(np.float32)
    big[2 ** 24 + 3:2 ** 24 + 69] = seg
    out = to_numpy(st.warp_chunk(_t(big), 2 ** 24 + 3, 0.25, 1.0, 64))
    np.testing.assert_allclose(out, seg[:-2] * 0.75 + seg[1:-1] * 0.25,
                               rtol=1e-6)


class _Poses:
    """A source moving back and forth along a line: poses of either
    package (JAX ``TraceParams`` or the port's)."""

    def __init__(self, make):
        self.make = make

    def __call__(self, i):
        x = 4.0 + 3.0 * np.sin(0.21 * i) + 0.01 * i
        return self.make(np.float32([x, 1.0]), np.float32([0.0, -0.5]))


@pytest.mark.parametrize("loop", [False, True])
def test_doppler_feed_matches_jax_over_100_chunks(loop):
    dry = np.random.default_rng(6).normal(size=1500).astype(np.float32)
    n, sr, steps = 64, 8000, 100
    jp = _Poses(lambda s, l: jart.TraceParams.make(s, l))
    pp = _Poses(lambda s, l: art.TraceParams.make(s, l, device="cpu"))
    jf = jst.DopplerFeed(_j(dry), jp, n, sr, steps, loop)
    pf = st.DopplerFeed(_t(dry), pp, n, sr, steps, loop)
    rates = []
    for i in range(steps):
        want = np.asarray(jf.chunk(i))
        got = to_numpy(pf.chunk(i))
        assert (pf.pos, pf.rate) == (jf.pos, jf.rate), i
        np.testing.assert_array_equal(got, want)
        rates.append(pf.rate)
    assert min(rates) < 0.99 < 1.01 < max(rates)
    if not loop:
        assert not got.any()                     # past the clip's end


# ---- streams against JAX ----------------------------------------------------


def _config(n_bands=1, rays=512):
    cfg = art.smoll_room_config(ray_count=rays, n_bands=n_bands)
    return dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, sample_rate=8000, reverb_duration=0.2,
        chunk_duration=0.05))


@pytest.fixture(scope="module")
def rooms_by_bands():
    out = {}
    for k in (1, 4):
        room = jart.rooms.smoll_room(n_bands=k)
        out[k] = (room, convert.scene_from_arrays(room.scene, device="cpu"))
    return out


def _moving(eng, room, n, sr, v=(3.0, -1.0)):
    def poses(i):
        return eng.params(np.float32(room.source)
                          + np.float32(v) * np.float32(i * n / sr),
                          room.listener)
    return poses


def _pair(rooms_by_bands, n_bands, binaural, key=0, **kw):
    """(JAX streamer, port streamer fed JAX's draws, JAX poses, port
    poses, cfg)."""
    room, scene = rooms_by_bands[n_bands]
    cfg = _config(n_bands)
    k = jax.random.PRNGKey(key)
    js = jart.Streamer(room.scene, cfg, k, binaural=binaural, **kw)
    ps = art.Streamer(scene, cfg, binaural=binaural, uniforms_fn=lambda i: (
        jax_chunk_uniforms(k, i, 1, cfg.sim.max_bounces,
                           cfg.sim.ray_count)), **kw)
    n, sr = cfg.audio.chunk_samples, cfg.audio.sample_rate
    return (js, ps, _moving(jart.Engine(room.scene, cfg), room, n, sr),
            _moving(art.Engine(scene, cfg), room, n, sr), cfg)


@pytest.mark.parametrize("n_bands, binaural", [(1, False), (4, False),
                                               (1, True), (4, True)])
def test_per_arrival_stream_matches_jax(rooms_by_bands, n_bands, binaural):
    js, ps, jp, pp, cfg = _pair(rooms_by_bands, n_bands, binaural,
                                head_radius=0.15)
    dry = noise_burst(0.12, cfg.audio.sample_rate, seed=1)
    facing = (lambda i: 0.3 - 0.2 * i) if binaural else None
    seen_j, seen_p = [], []
    # copies: the port's state is updated in place
    want = np.asarray(js.stream_clip(
        _j(dry), jp, facing_fn=facing, doppler="per_arrival",
        on_chunk=lambda i, s: seen_j.append([np.asarray(x) for x in (
            s.arrival.idx, s.arrival.res, s.prev_ir)])))
    got = to_numpy(ps.stream_clip(
        _t(dry), pp, facing_fn=facing, doppler="per_arrival",
        on_chunk=lambda i, s: seen_p.append([to_numpy(x).copy() for x in (
            s.arrival.idx, s.arrival.res, s.prev_ir)])))
    n, t = cfg.audio.chunk_samples, cfg.audio.ir_length
    n_steps = -(-len(dry) // n) + -(-t // n)
    assert got.shape == want.shape == (2 if binaural else 1, n_steps * n)
    assert len(seen_p) == len(seen_j) == n_steps
    for (gi, gr, g_ir), (wi, wr, w_ir) in zip(seen_p, seen_j):
        np.testing.assert_array_equal(gi, wi)
        if binaural:
            _decoded_close(gr, wr)
        else:
            # the same tap bins leave the same mask: the residuals differ
            # only where the traced IRs do
            assert (np.abs(gr - wr) <= np.abs(g_ir - w_ir)).all()
            np.testing.assert_allclose(g_ir, w_ir, rtol=1e-4,
                                       atol=1e-6 * np.abs(w_ir).max())
    _stream_close(got, want)
    # the taps moved: the per-arrival stream is not the plain one
    plain = np.asarray(jart.Streamer(js.scene, js.config, js.key,
                                     binaural=binaural, head_radius=0.15)
                       .stream_clip(_j(dry), jp, facing_fn=facing))
    assert not np.allclose(want, plain, rtol=STREAM_RTOL,
                           atol=1e-4 * np.abs(plain).max())


@pytest.mark.parametrize("binaural", [False, True])
def test_per_arrival_state_from_jax_continues_its_stream(rooms_by_bands,
                                                         binaural):
    # JAX streams chunks 0-2; its state, carried across by convert,
    # continues in the port equal to JAX's chunks 3-5
    js, ps, jp, pp, cfg = _pair(rooms_by_bands, 1, binaural)
    n, sr = cfg.audio.chunk_samples, cfg.audio.sample_rate
    dry = noise_burst(0.3, sr, seed=2)
    total = len(dry)
    wd = n + js.arrival_early + 2
    fac = (lambda i: 0.2 * i) if binaural else (lambda i: 0.0)

    def window(i, mod):
        return (mod(dry),) + st.window_scalars(i, n, wd, total, False) \
            + (False,)

    for i in range(3):
        js.process(_j(dry[i * n:(i + 1) * n]), jp(i), facing=fac(i),
                   window=window(i, _j))
    state = convert.stream_state_from_arrays(js.state, device="cpu")
    assert state.arrival is not None and state.chunk_index == 3
    assert (state.arrival.x3 is not None) == binaural
    np.testing.assert_array_equal(to_numpy(state.arrival.idx),
                                  np.asarray(js.state.arrival.idx))
    ps.state = state
    for i in range(3, 6):
        want = np.asarray(js.process(_j(dry[i * n:(i + 1) * n]), jp(i),
                                     facing=fac(i), window=window(i, _j)))
        got = to_numpy(ps.process(_t(dry[i * n:(i + 1) * n]), pp(i),
                                  facing=fac(i), window=window(i, _t)))
        _stream_close(got, want)
        np.testing.assert_array_equal(to_numpy(ps.state.arrival.idx),
                                      np.asarray(js.state.arrival.idx))


def test_doppler_stream_matches_jax(rooms_by_bands):
    js, ps, jp, pp, cfg = _pair(rooms_by_bands, 1, False)
    dry = noise_burst(0.15, cfg.audio.sample_rate, seed=5)
    want = np.asarray(js.stream_clip(_j(dry), jp, doppler=True))
    got = to_numpy(ps.stream_clip(_t(dry), pp, doppler=True))
    _stream_close(got, want)
    plain = np.asarray(jart.Streamer(js.scene, js.config, js.key)
                       .stream_clip(_j(dry), jp))
    assert not np.allclose(want, plain, rtol=STREAM_RTOL,
                           atol=1e-4 * np.abs(plain).max())


def test_reset_and_stop_controls_match_jax(rooms_by_bands):
    # R before chunk 2 zeroes the carry (the taps fade in afresh); Space at
    # chunk 3 silences the dry and flushes: the taps keep reading the
    # history before the stop
    js, ps, jp, pp, cfg = _pair(rooms_by_bands, 1, False)
    dry = noise_burst(0.25, cfg.audio.sample_rate, seed=7)
    ctrl = lambda i: {"reset_ir": i == 2, "stop": i == 3}    # noqa: E731
    want = np.asarray(js.stream_clip(_j(dry), jp, doppler="per_arrival",
                                     control_fn=ctrl))
    got = to_numpy(ps.stream_clip(_t(dry), pp, doppler="per_arrival",
                                  control_fn=ctrl))
    n, t = cfg.audio.chunk_samples, cfg.audio.ir_length
    assert got.shape == want.shape == (1, (3 + -(-t // n)) * n)
    _stream_close(got, want)
    assert np.abs(got[0, 3 * n:4 * n]).max() > 0     # the flush rings on
    ps.reset_ir()
    assert ps.state.arrival is not None
    assert not any(bool(x.any()) for x in ps.state.arrival.tensors())
    assert float(ps.state.prev_ir.abs().sum()) == 0


# ---- physics, port only (JAX's tests and bounds) ----------------------------


def _free_field_room(src_x, n_bands=1, wall_h=2.0):
    """JAX's fixture: listener at the origin, source on +x, one short
    mirror wall at x = 6 (absorption 0, specular, opaque): two early
    arrivals, the direct sound and the wall echo."""
    from realisticaudioraytracing2d_tpu_torch.models.materials import \
        AudioMaterial
    from realisticaudioraytracing2d_tpu_torch.models.scene import (
        SceneBuilder, Transform2D)
    mirror = AudioMaterial(band_absorption=(0.0,) * n_bands, scattering=0.0,
                           transmission=0.0, ior=1.0)
    b = SceneBuilder(n_bands=n_bands)
    b.add_box(mirror, Transform2D(position=(6.5, 0.0)), size=(1.0, wall_h))
    return (b.build(device="cpu"), np.float32([src_x, 0.0]),
            np.float32([0.0, 0.0]))


def _free_cfg(reverb=0.2, rays=512, radius=None):
    cfg = art.smoll_room_config(ray_count=rays)
    if radius is not None:
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
            cfg.sim, listener_radius=radius))
    return dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, sample_rate=8000, reverb_duration=reverb,
        chunk_duration=0.1))


@pytest.mark.parametrize("n_bands", [1, 8])
def test_static_scene_per_arrival_matches_plain_stream(n_bands):
    # nothing moves: the taps carry their exact windows, so tap + residual
    # reproduce the plain stream (chunk 0 exactly; later chunks up to the
    # Monte-Carlo noise the taps read as sub-bin motion)
    scene, src, lis = _free_field_room(2.0, n_bands)
    cfg = _free_cfg()
    p = art.Engine(scene, cfg).params(src, lis)
    n = cfg.audio.chunk_samples
    dry = _t(np.random.default_rng(3 + n_bands).normal(
        size=int(0.4 * cfg.audio.sample_rate)).astype(np.float32) * 0.3)
    plain = to_numpy(art.Streamer(scene, cfg, seed=0, frames_per_chunk=4)
                     .stream_clip(dry, lambda i: p, loop=False))
    pa = to_numpy(art.Streamer(scene, cfg, seed=0, frames_per_chunk=4)
                  .stream_clip(dry, lambda i: p, loop=False,
                               doppler="per_arrival"))
    assert pa.shape == plain.shape
    scale = np.abs(plain).max()
    if n_bands == 1:
        np.testing.assert_allclose(pa[:, :n], plain[:, :n],
                                   atol=1e-4 * scale)
    den = np.linalg.norm(plain)
    assert np.linalg.norm(pa - plain) / den < (0.05 if n_bands == 1
                                               else 0.06)
    assert np.dot(pa.ravel(), plain.ravel()) / (np.linalg.norm(pa)
                                                * den) > 0.995


@pytest.mark.parametrize("binaural", [False, True])
def test_moving_source_direct_and_echo_shift_opposite_ways(binaural):
    # the source approaches the listener and recedes from the wall: the
    # direct sound shifts up by v / c and the echo down; both lines rise
    # out of the local spectral floor (binaural: in both ears, the right
    # ear louder and earlier, the head facing +y)
    cfg = _free_cfg(reverb=0.15, rays=2048, radius=0.05)
    sr, n = cfg.audio.sample_rate, cfg.audio.chunk_samples
    v, c, f0, total = 2.0, 343.0, 1000.0, 10
    dry = _t(np.sin(2 * np.pi * f0 * np.arange((total + 4) * n) / sr
                    ).astype(np.float32))
    scene, _, lis = _free_field_room(3.0)
    eng = art.Engine(scene, cfg)

    def poses(i):
        return eng.params(np.float32([3.0 - v * (i * n / sr), 0.0]), lis)

    wet = to_numpy(art.Streamer(scene, cfg, seed=0, frames_per_chunk=4,
                                binaural=binaural)
                   .stream_clip(dry, poses, loop=False, total_chunks=total,
                                doppler="per_arrival",
                                facing_fn=lambda i: np.pi / 2))
    seg = wet[:, 2 * n:total * n]
    freqs = np.fft.rfftfreq(seg.shape[-1], 1.0 / sr)
    f_up, f_dn = f0 * (1.0 + v / c), f0 * (1.0 - v / c)
    for ear in range(seg.shape[0]):
        spec = np.abs(np.fft.rfft(seg[ear] * np.hanning(seg.shape[-1])))

        def band(lo, hi):
            m = (freqs >= lo) & (freqs <= hi)
            return spec[m], freqs[m]

        up_s, up_f = band(f0 + 1.0, f0 + 15.0)
        dn_s, dn_f = band(f0 - 15.0, f0 - 1.0)
        floor = max(band(f0 - 40, f0 - 25)[0].max(),
                    band(f0 + 25, f0 + 40)[0].max())
        assert up_s.max() > (8.0 if binaural else 10.0) * floor
        assert dn_s.max() > (3.0 if binaural else 4.0) * floor
        if not binaural:
            assert abs(up_f[np.argmax(up_s)] - f_up) < 2.2
            assert abs(dn_f[np.argmax(dn_s)] - f_dn) < 2.2
    if binaural:
        spec = np.fft.rfft(seg, axis=-1)
        spec[:, (freqs < f0 - 20) | (freqs > f0 + 20)] = 0.0
        lines = np.fft.irfft(spec, seg.shape[-1], axis=-1)
        rms = np.sqrt((lines ** 2).mean(axis=-1))
        assert 2.0 < rms[1] / rms[0] < 7.0           # the ILD


def test_doppler_feed_physics():
    # static poses: rate exactly 1, the stream equals the plain one bit
    # for bit; a source receding at 0.1 c lowers a 400 Hz tone to ~360 Hz;
    # a pose table of exactly n_steps entries is enough
    scene, src, lis = _free_field_room(2.0)
    cfg = dataclasses.replace(_free_cfg(), audio=dataclasses.replace(
        _free_cfg().audio, chunk_duration=0.05))
    sr, n = cfg.audio.sample_rate, cfg.audio.chunk_samples
    eng = art.Engine(scene, cfg)
    p = eng.params(src, lis)
    noise = _t(noise_burst(0.15, sr, seed=5))
    plain = art.Streamer(scene, cfg, seed=0).stream_clip(noise, lambda i: p)
    dopp = art.Streamer(scene, cfg, seed=0).stream_clip(noise, lambda i: p,
                                                       doppler=True)
    assert torch.equal(plain, dopp)
    f0, v = 400.0, 34.3
    tone = _t((np.sin(2 * np.pi * f0 * np.arange(int(0.6 * sr)) / sr)
               * 0.5).astype(np.float32))

    def receding(i):
        return eng.params(src + np.float32([v * cfg.audio.chunk_duration
                                            * i, 0.0]), lis)

    def peak_hz(wet):
        seg = to_numpy(wet)[0, int(0.1 * sr):int(0.5 * sr)]
        spec = np.abs(np.fft.rfft(seg * np.hanning(seg.size)))
        return np.argmax(spec) * sr / seg.size

    assert abs(peak_hz(art.Streamer(scene, cfg, seed=0).stream_clip(
        tone, receding)) - f0) < 12.0
    assert abs(peak_hz(art.Streamer(scene, cfg, seed=0).stream_clip(
        tone, receding, doppler=True)) - f0 * (1 - v / 343.0)) < 12.0
    n_steps = -(-noise.shape[-1] // n) + -(-cfg.audio.ir_length // n)
    table = [eng.params(src + np.float32([0.01 * i, 0.0]), lis)
             for i in range(n_steps)]
    wet = art.Streamer(scene, cfg, seed=0).stream_clip(
        noise, lambda i: table[i], doppler=True)
    assert wet.shape[-1] == n_steps * n and bool(torch.isfinite(wet).all())


def test_carry_and_knobs():
    # init_arrival_carry's shapes, the lazy carry, the refusals of JAX
    cfg = _config()
    room = art.rooms.smoll_room(device="cpu")
    c = st.init_arrival_carry(100, 2, 3, 5, device="cpu")
    assert tuple(c.res.shape) == (2, 100, 3) and tuple(c.g3.shape) == (
        2, 5, 3, 3)
    assert c.idx.dtype == torch.int64 and not bool(c.val.any())
    assert c.x3 is None and len(c.tensors()) == 4
    b = st.init_arrival_carry(100, 2, 1, 4, binaural=True, device="cpu")
    assert tuple(b.idx.shape) == (1, 4) and tuple(b.x3.shape) == (1, 4, 3, 1)
    s = st.init_stream(100, 10, arrival_taps=3, device="cpu")
    assert tuple(s.arrival.idx.shape) == (1, 3)
    with pytest.raises(ValueError, match="arrival_taps"):
        art.Streamer(room.scene, cfg, arrival_taps=0)
    streamer = art.Streamer(room.scene, cfg, arrival_window_s=0.05)
    assert streamer.arrival_early == 400 and streamer.state.arrival is None
    p = art.Engine(room.scene, cfg).params(room.source, room.listener)
    n = cfg.audio.chunk_samples
    with pytest.raises(ValueError, match="arrival carry"):
        st.stream_chunk(room.scene, p, streamer.state, torch.zeros(n),
                        seed=0, n_rays=64, max_bounces=3, sample_rate=8000,
                        dry_full=torch.zeros(4 * n), win_start=0,
                        win_prefix=0, win_cut=10, arrival_early=400)
    dry = torch.zeros(4 * n)
    streamer.process(dry[:n], p, window=(dry, *st.window_scalars(
        0, n, n + 402, 4 * n, False), False))
    assert streamer.state.arrival is not None
    assert streamer.state.chunk_index == 1
