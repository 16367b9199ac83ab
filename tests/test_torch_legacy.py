"""PyTorch port: the legacy frequency-binned pipeline (``ops/legacy.py``) and
``ops/ir.py::muffle_band_energies`` against the JAX package, on JAX's own
hits of a SmollRoom trace (1,024 rays x 5 bounces, one and two listeners)
converted with ``convert.hits_from_arrays``, so both see the same records.

Tolerances: the muffle is ``exp`` of a float32 product, whose last bit the
two libraries round differently: rtol 2e-6 per element. The scattered
spectro-IR sums up to a few hundred such values per bin in the same
order: rtol 1e-5 (atol 1e-9 for empty bins). The time-domain render goes
through the two libraries' FFTs: 1e-5 of the peak."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import to_numpy, to_torch

from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.ops import ir as jax_ir
from realisticaudioraytracing2d_tpu.ops import legacy as jax_legacy
from realisticaudioraytracing2d_tpu.ops import trace as jax_trace
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch.ops import ir as irm
from realisticaudioraytracing2d_tpu_torch.ops import legacy
from realisticaudioraytracing2d_tpu_torch.ops.trace import Hits

SR, T_BINS, W = 8000, 64, 32


@pytest.fixture(scope="module", params=[1, 2])
def hits_pair(request):
    room = jax_rooms.smoll_room()
    lis = np.stack([room.listener, room.listener + [1.5, 0.5]])[:request.param]
    p = jax_trace.TraceParams.make(room.source, lis, 0.5, 343.0, 1.0)
    hj = jax_trace.trace_hits_only(room.scene, p, jax.random.PRNGKey(0),
                                   n_rays=1024, max_bounces=5)
    return hj, convert.hits_from_arrays(hj, device="cpu")


def _one_hit(delay, energy):
    shape = (1, 1, 1, 1)
    return Hits(delay=torch.full(shape, delay),
                energy=torch.full(shape + (1,), energy),
                valid=torch.ones(shape, dtype=torch.bool))


def test_muffle_band_energies_match_jax():
    gen = np.random.default_rng(3)
    energy = gen.uniform(0, 2, (5, 7)).astype(np.float32)
    muffle = gen.uniform(-1, 1, (5, 7)).astype(np.float32)
    for n_bands, scale in ((128, 5.0), (6, 2.5)):
        want = np.asarray(jax_ir.muffle_band_energies(energy, muffle, n_bands,
                                                      scale))
        got = irm.muffle_band_energies(to_torch(energy), to_torch(muffle),
                                       n_bands, scale)
        assert tuple(got.shape) == (5, 7, n_bands)
        np.testing.assert_allclose(to_numpy(got), want, rtol=2e-6)


def test_scatter_hits_legacy_matches_jax(hits_pair):
    hj, ht = hits_pair
    want = np.asarray(jax_legacy.scatter_hits_legacy(hj, SR, T_BINS, W))
    got = legacy.scatter_hits_legacy(ht, SR, T_BINS, W)
    assert tuple(got.shape) == want.shape == (hj.valid.shape[-1], T_BINS, W)
    assert want.sum() > 0
    np.testing.assert_array_equal(to_numpy(got) != 0, want != 0)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(
        to_numpy(legacy.hit_muffle_factors(ht)),
        np.asarray(jax_legacy.hit_muffle_factors(hj)))


def test_accumulate_legacy_and_render_match_jax(hits_pair):
    hj, ht = hits_pair
    n_l = hj.valid.shape[-1]
    sj = jax_legacy.LegacyIRState.zeros(T_BINS, n_l, W)
    st = legacy.LegacyIRState.zeros(T_BINS, n_l, W, device="cpu")
    for _ in range(2):
        sj = jax_legacy.accumulate_legacy(sj, hj, SR)
        st = legacy.accumulate_legacy(st, ht, SR)
    assert st.frames == 2 == int(sj.frames)
    np.testing.assert_allclose(to_numpy(st.normalized()),
                               np.asarray(sj.normalized()), rtol=1e-5,
                               atol=1e-9)
    conv = convert.legacy_state_from_arrays(sj, device="cpu")
    assert conv.frames == 2 and tuple(conv.sum.shape) == (n_l, T_BINS, W)
    want = np.asarray(jax_legacy.legacy_ir_to_time_domain(
        sj.normalized(), SR, T_BINS * W, W))
    got = to_numpy(legacy.legacy_ir_to_time_domain(conv.normalized(), SR,
                                                   T_BINS * W, W))
    assert got.shape == want.shape == (n_l, T_BINS * W)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_scatter_legacy_oracle_and_bounds():
    # one hit: energy 2.0, delay 0.5 s at SR=1000, window 4 -> time bin 125
    ir = to_numpy(legacy.scatter_hits_legacy(_one_hit(0.5, 2.0), 1000, 200,
                                             4, 5.0))
    assert ir.shape == (1, 200, 4)
    want = 2.0 * np.exp(-(1.0 - 2.0) * np.arange(4) * 5.0 / 4)
    np.testing.assert_allclose(ir[0, 125], want, rtol=1e-5)
    assert np.abs(ir[0]).sum() == pytest.approx(np.abs(want).sum())
    for delay in (10.0, -1.0):      # out of range: dropped
        assert float(legacy.scatter_hits_legacy(_one_hit(delay, 1.0), 1000,
                                                8, 4).sum()) == 0.0


def test_legacy_to_time_domain_lands_at_the_hit():
    st = legacy.accumulate_legacy(
        legacy.LegacyIRState.zeros(T_BINS, 1, W, device="cpu"),
        _one_hit(0.1, 1.0), SR)               # time bin floor(800/32) = 25
    td = to_numpy(legacy.legacy_ir_to_time_domain(st.normalized(), SR,
                                                  T_BINS * W, W))
    assert td.shape == (1, T_BINS * W)
    assert np.abs(td[0][780:880]).sum() > 0.5 * np.abs(td[0]).sum()
