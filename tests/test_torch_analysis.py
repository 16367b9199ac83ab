"""PyTorch port: the room-acoustics metrics (``analysis.py``) and the
decay-curve plot, after tests/test_analysis.py.

The same IRs, made from a seed with numpy (or traced once by the port),
go through the JAX module and the port. Tolerances: the time axis
``arange(T) / sample_rate`` is equal bit for bit (both divide); the EDC
and the least-squares sums run in another summation order (XLA's
reductions against torch's), so EDC levels agree within 1e-4 dB, the
decay times within rtol 1e-3, the energy ratios within rtol 1e-5 and
times within 1e-6 s. What is NaN (a decay that never spans its window,
the truncation guard) is NaN on both sides, exactly. The analytic
oracles of the JAX tests (an exponential decay's T60, C50/D50 of a
numpy sum) hold on the port within the JAX tests' limits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CPU, to_numpy

from realisticaudioraytracing2d_tpu import analysis as jan
from realisticaudioraytracing2d_tpu.utils import viz as jviz
from realisticaudioraytracing2d_tpu_torch import analysis as an
from realisticaudioraytracing2d_tpu_torch.utils import viz

SR = 48000


def exp_ir(t60: float, length: int, sr: int = SR, start: int = 0):
    """Energy IR decaying 60 dB in ``t60`` seconds, first arrival at bin
    ``start`` (numpy float32)."""
    t = np.arange(length, dtype=np.float64) / sr
    ir = 10.0 ** (-6.0 * t / t60)
    ir = np.roll(ir, start)
    ir[:start] = 0.0
    return ir.astype(np.float32)


def noisy_irs(seed=0, shape=(2, 3), length=6000, sr=8000):
    """Decaying Monte-Carlo-like energy IRs ``[*shape, T]``: an
    exponential envelope times uniform noise, from a numpy seed."""
    rng = np.random.default_rng(seed)
    t60 = rng.uniform(0.2, 0.9, shape)[..., None]
    t = np.arange(length) / sr
    env = 10.0 ** (-6.0 * t / t60)
    return (env * rng.random(shape + (length,))).astype(np.float32)


def both(fn_name, x, *args, **kw):
    """(port, JAX) results of one function on the same numpy input."""
    got = to_numpy(getattr(an, fn_name)(torch.from_numpy(x), *args, **kw))
    want = np.asarray(getattr(jan, fn_name)(jnp.asarray(x), *args, **kw))
    return got, want


def test_time_axis_divides_as_jax():
    got = to_numpy(an._seconds(72000, 48000, torch.zeros(1)))
    want = np.asarray(jnp.arange(72000, dtype=jnp.float32) / 48000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.arange(72000, dtype=np.float32) / np.float32(48000))


def test_edc_is_reverse_cumsum():
    got = to_numpy(an.schroeder_edc(torch.tensor([1.0, 0.5, 0.25, 0.0])))
    np.testing.assert_allclose(got, [1.75, 0.75, 0.25, 0.0], rtol=1e-6)


def test_edc_and_db_equal_jax():
    x = noisy_irs(1)
    got, want = both("schroeder_edc", x)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got, want = both("edc_db", x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)
    db = to_numpy(an.edc_db(torch.from_numpy(exp_ir(0.5, SR))))
    assert db[0] == pytest.approx(0.0, abs=1e-5)
    assert np.all(np.diff(db) <= 1e-6)


@pytest.mark.parametrize("t60", [0.3, 0.8, 1.5])
@pytest.mark.parametrize("fn", ["rt60_t20", "rt60_t30",
                                "early_decay_time"])
def test_decay_times_recover_exponential_as_jax(t60, fn):
    ir = exp_ir(t60, int(SR * t60))
    got, want = both(fn, ir, SR)
    assert float(got) == pytest.approx(t60, rel=0.01)
    assert float(got) == pytest.approx(float(want), rel=1e-3)


def test_decay_time_nan_pattern_equals_jax():
    # a batch that holds every case: decays that span each window, a
    # 10 ms IR of a 1 s decay (never reaches -25 dB), a truncated slow
    # decay (the tail guard), an all-zero IR and one lone bin
    n = 4800
    rows = [exp_ir(0.3, n), exp_ir(1.0, SR // 100).tolist() + [0.0] * (
        n - SR // 100), exp_ir(3.0, n), np.zeros(n), np.eye(1, n, 7)[0]]
    x = np.stack([np.asarray(r, np.float32) for r in rows])
    x = np.concatenate([x, noisy_irs(2, (3,), n, SR)])
    for fn in ("rt60_t20", "rt60_t30", "early_decay_time"):
        got, want = both(fn, x, SR)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).any() and np.isfinite(got).any(), fn
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-3)
    assert np.isnan(float(an.rt60_t20(torch.from_numpy(
        exp_ir(1.0, SR // 100)), SR)))


def test_clarity_definition_against_numpy_oracle_and_jax():
    ir = exp_ir(0.6, SR)
    split = int(round(50e-3 * SR))     # direct arrival at bin 0
    early, late = ir[:split].astype(np.float64).sum(), \
        ir[split:].astype(np.float64).sum()
    c50, c50_j = both("clarity", ir, SR, 50.0)
    d50, d50_j = both("definition", ir, SR, 50.0)
    assert float(c50) == pytest.approx(10 * np.log10(early / late),
                                       abs=1e-3)
    assert float(d50) == pytest.approx(early / (early + late), abs=1e-5)
    assert float(c50) == pytest.approx(float(c50_j), abs=1e-4)
    assert float(d50) == pytest.approx(float(d50_j), rel=1e-5)
    x = noisy_irs(3)
    for fn, args in (("clarity", (8000, 80.0)), ("definition", (8000,)),
                     ("centre_time", (8000,))):
        got, want = both(fn, x, *args)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_split_measured_from_direct_arrival():
    a = torch.from_numpy(exp_ir(0.6, SR))
    b = torch.from_numpy(exp_ir(0.6, SR, start=480))    # +10 ms
    for fn in (an.clarity, an.definition):
        assert float(fn(a, SR)) == pytest.approx(float(fn(b, SR)), rel=1e-3)


def test_centre_time_oracle():
    ir = np.zeros(1000, np.float32)
    ir[100] = 2.0
    ir[500] = 1.0
    ts, ts_j = both("centre_time", ir, SR)
    assert float(ts) == pytest.approx((2 * 100 + 1 * 500) / 3 / SR,
                                      rel=1e-5)
    assert float(ts) == pytest.approx(float(ts_j), rel=1e-6)


def test_direct_arrival_ignores_weak_precursor_as_jax():
    ir = np.zeros(1000, np.float32)
    ir[50] = 1e-5     # stray low-energy deposit
    ir[200] = 1.0     # the real direct sound
    assert int(an.direct_arrival_bin(torch.from_numpy(ir))) == 200
    t = float(an.direct_arrival_time(torch.from_numpy(ir), SR))
    assert t == pytest.approx(200 / SR)
    x = np.concatenate([noisy_irs(4, (4,), 1000), np.zeros((1, 1000),
                                                           np.float32)])
    x[:, :37] = 0.0
    got, want = both("direct_arrival_bin", x)
    np.testing.assert_array_equal(got, want)
    got, want = both("direct_arrival_time", x, SR)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [{}, {"t_start_s": 0.02},
                                    {"t_start_s": 0.01, "t_end_s": 0.2,
                                     "max_lag_ms": 0.5}])
def test_iacc_equals_jax(window):
    rng = np.random.default_rng(6)
    left = rng.standard_normal((2, 1600)).astype(np.float32)
    right = (0.6 * np.roll(left, 3, axis=-1)
             + 0.4 * rng.standard_normal((2, 1600))).astype(np.float32)
    got = to_numpy(an.iacc(torch.from_numpy(left), torch.from_numpy(right),
                           8000, **window))
    want = np.asarray(jan.iacc(jnp.asarray(left), jnp.asarray(right), 8000,
                               **window))
    assert got.shape == (2,) and (got > 0.3).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    same = to_numpy(an.iacc(torch.from_numpy(left), torch.from_numpy(left),
                            8000, **window))
    np.testing.assert_allclose(same, 1.0, rtol=1e-5)


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = np.isfinite(w)
        rtol = 1e-3 if k in ("rt60_t20_s", "rt60_t30_s", "edt_s") else 1e-5
        np.testing.assert_allclose(g[ok], w[ok], rtol=rtol, atol=1e-5,
                                   err_msg=k)


def test_analyze_ir_shapes_and_values_equal_jax():
    ir1 = exp_ir(0.4, SR // 2)
    out1 = an.analyze_ir(torch.from_numpy(ir1), SR)
    assert out1["rt60_t20_s"].shape == ()
    ir2 = np.stack([ir1, ir1 * 0.5], axis=-1)               # [T, K=2]
    assert an.analyze_ir(ir2, SR, device=CPU)["d50"].shape == (2,)
    ir3 = np.stack([ir2, ir2])                              # [L=2, T, K=2]
    assert an.analyze_ir(ir3, SR, device=CPU)["c80_db"].shape == (2, 2)
    scaled = an.analyze_ir(torch.from_numpy(ir1 * 37.0), SR)
    assert scaled["rt60_t30_s"] == pytest.approx(float(out1["rt60_t30_s"]),
                                                 rel=1e-5)
    x = np.moveaxis(noisy_irs(5, (2, 3), 4000, SR), -1, 1)  # [L, T, K]
    for ir in (x, x[0], x[0, :, 0], ir1):
        _assert_metrics_equal(an.analyze_ir(torch.from_numpy(ir), SR),
                              jan.analyze_ir(jnp.asarray(ir), SR))
    with pytest.raises(ValueError, match="expected"):
        an.analyze_ir(torch.zeros(1, 2, 3, 4), SR)


def test_analyze_traced_smoll_room():
    import realisticaudioraytracing2d_tpu_torch as art
    room = art.rooms.smoll_room(device=CPU)
    cfg = art.smoll_room_config(ray_count=2000)
    eng = art.Engine(room.scene, cfg)
    state = eng.trace_frames(eng.params(room.source, room.listener),
                             seed=0, n_frames=4)
    ir = state.normalized()
    out = an.analyze_ir(ir, cfg.audio.sample_rate)
    rt = float(out["rt60_t20_s"][0, 0])
    assert 0.01 < rt < cfg.audio.reverb_duration
    assert 0.0 <= float(out["d50"][0, 0]) <= 1.0
    dist = float(np.linalg.norm(room.source - room.listener))
    assert float(out["direct_distance_m"][0, 0]) == pytest.approx(
        dist, rel=0.25)
    _assert_metrics_equal(out, jan.analyze_ir(jnp.asarray(to_numpy(ir)),
                                              cfg.audio.sample_rate))


def test_analyze_dataset_matches_per_ir_and_jax():
    t60s = [0.3, 0.7]
    irs = np.stack([exp_ir(t, 8000, sr=8000) for t in t60s])
    irs = irs[:, None, :, None]                       # [rooms, 1, T, 1]
    out = an.analyze_dataset(torch.from_numpy(irs), 8000)
    assert out["rt60_t20_s"].shape == (2, 1, 1)
    for i, t in enumerate(t60s):
        assert out["rt60_t20_s"][i, 0, 0] == pytest.approx(t, rel=0.01)
        single = an.analyze_ir(irs[i], 8000, device=CPU)
        assert out["c50_db"][i, 0, 0] == pytest.approx(
            float(single["c50_db"][0, 0]), abs=1e-4)
    x = np.moveaxis(noisy_irs(7, (3, 2, 2), 3000), -1, 2)  # [N, L, T, K]
    _assert_metrics_equal(an.analyze_dataset(x, 8000, device=CPU),
                          jan.analyze_dataset(x, 8000))


def test_decay_curve_image_equals_jax():
    ir = np.moveaxis(noisy_irs(8, (3,), 5000), 0, -1)        # [T, K=3]
    for a in (ir, ir[:, 0]):
        got = viz.decay_curve_image(torch.from_numpy(a))
        want = jviz.decay_curve_image(a)
        assert got.shape == want.shape == (256, 1024, 3)
        assert got.any()
        # the dB curve rounds to a pixel row: a level on a row boundary
        # may land one row over after another summation order
        assert (got != want).any(-1).mean() < 1e-3
