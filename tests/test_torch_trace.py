"""PyTorch port: the plain trace vs the JAX oracle trace, fed JAX's own
uniforms (``ops/rng.py::bounce_uniforms``), on SmollRoom at 1024 rays x 5
bounces with L in {1, 2} listeners and K in {1, 4} bands.

Tolerances: the two libraries' float32 sin/cos/asin differ by an ulp on a
few percent of inputs (emission and diffuse directions), so a razor-edge
hit may flip: valid masks must agree on >= 99.5% of entries. Where both
are valid, delays and energies agree to rtol 1e-5 on >= 99% of entries
and to 1e-4 everywhere; the largest gaps are grazing listener-circle
captures, where ``sqrt(r^2 - d^2)`` magnifies an ulp of direction. The
debug paths (``n_debug``) follow the same rays: ``alive`` equal on >= 99.5%
of the entries, and where both are alive positions to atol 2e-3 m (an ulp
of direction over a 40 m room) and energies to rtol 1e-5, on all but at
most one of the 32 rays (a razor-edge wall hit diverts a ray for good)."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import to_numpy, to_torch

from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
from realisticaudioraytracing2d_tpu.ops import trace as jax_trace
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch.ops import trace as tt

R, B = 1024, 5


def _agree(got, want, mask):
    rel = np.abs(got[mask] - want[mask]) / np.abs(want[mask])
    assert np.mean(rel <= 1e-5) >= 0.99, np.quantile(rel, 0.99)
    assert rel.max() <= 1e-4, rel.max()


@pytest.mark.parametrize("n_listeners", [1, 2])
@pytest.mark.parametrize("n_bands", [1, 4])
def test_trace_matches_jax_with_jax_uniforms(n_listeners, n_bands):
    room = jax_rooms.smoll_room(n_bands=n_bands)
    lis = np.stack([room.listener, room.listener + [1.5, 0.5]])[:n_listeners]
    p = jax_trace.TraceParams.make(room.source, lis, 0.5, 343.0, 1.0)
    key = jax.random.PRNGKey(3)
    hj, _ = jax_trace.trace(room.scene, p, key, n_rays=R, max_bounces=B)
    emit, u = jax_rng.bounce_uniforms(key, B, R)
    ht, dbg = tt.trace(convert.scene_from_arrays(room.scene, device="cpu"),
                       convert.params_from_arrays(p, device="cpu"),
                       to_torch(emit), to_torch(u))
    assert dbg is None
    assert tuple(ht.delay.shape) == (B, 2, R, n_listeners)
    assert tuple(ht.energy.shape) == (B, 2, R, n_listeners, n_bands)
    vj, vt = np.asarray(hj.valid), to_numpy(ht.valid)
    assert vj.sum() > 500
    assert (vj != vt).mean() <= 5e-3
    both = vj & vt
    _agree(to_numpy(ht.delay), np.asarray(hj.delay), both)
    _agree(to_numpy(ht.energy), np.asarray(hj.energy),
           np.broadcast_to(both[..., None], hj.energy.shape))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_debug_paths_match_jax(use_kernels):
    """``trace(n_debug)`` against JAX's ``trace`` on JAX's uniforms; with
    ``use_kernels`` against JAX's ``use_pallas`` (Pallas kernels in
    interpret mode), the plain sweeps taking K1/K2's place on the CPU."""
    d = 32
    room = jax_rooms.smoll_room()
    p = jax_trace.TraceParams.make(room.source, room.listener, 0.5, 343.0,
                                   1.0)
    key = jax.random.PRNGKey(4)
    hj, dj = jax_trace.trace(room.scene, p, key, n_rays=R, max_bounces=B,
                             n_debug=d, use_pallas=use_kernels)
    emit, u = jax_rng.bounce_uniforms(key, B, R)
    ht, dt = tt.trace(convert.scene_from_arrays(room.scene, device="cpu"),
                      convert.params_from_arrays(p, device="cpu"),
                      to_torch(emit), to_torch(u), n_debug=d,
                      use_kernels=use_kernels)
    assert tuple(dt.pos.shape) == (B + 1, d, 2) == dj.pos.shape
    assert tuple(dt.energy.shape) == (B + 1, d) == tuple(dt.alive.shape)
    assert dt.alive.dtype == torch.bool and bool(dt.alive[0].all())
    aj, at = np.asarray(dj.alive), to_numpy(dt.alive)
    assert aj[1:].sum() > d and (aj != at).mean() <= 5e-3
    np.testing.assert_array_equal(to_numpy(dt.pos[0]), np.asarray(dj.pos[0]))
    # a segment is comparable while both rays were alive at its start; a
    # razor-edge wall hit (a distance within an ulp of EPS) sends a ray
    # another way for good, so at most one ray of the 32 may differ
    both = aj & at
    seg = np.concatenate([both[:1], both[:-1]])
    pos_ok = np.abs(to_numpy(dt.pos) - np.asarray(dj.pos)).max(-1) <= 2e-3
    en_ok = np.isclose(to_numpy(dt.energy), np.asarray(dj.energy), rtol=1e-5,
                       atol=0.0)
    same_ray = (pos_ok | ~seg).all(0) & (en_ok | ~both).all(0)
    assert same_ray.sum() >= d - 1, np.flatnonzero(~same_ray)
    assert (np.asarray(hj.valid) != to_numpy(ht.valid)).mean() <= 5e-3


@pytest.mark.parametrize("n_rays", [15000, 1024])
def test_emission_angles_equal_the_jax_ones(n_rays):
    """Emission angles ``(i + u) / R * 2pi`` (JAX's ``_emit`` expression)
    are bit-identical, also for a ray count that is not a power of two."""
    u = np.random.default_rng(5).random(n_rays, dtype=np.float32)
    want = (jax.numpy.arange(n_rays, dtype=jax.numpy.float32) + u) \
        / n_rays * (2.0 * jax_trace.PI)
    got = tt.emission_angle(n_rays, to_torch(u))
    assert np.array_equal(to_numpy(got), np.asarray(want))


def test_trace_hits_only_and_unported_features_raise():
    room = jax_rooms.smoll_room()
    scene = convert.scene_from_arrays(room.scene, device="cpu")
    p = tt.TraceParams.make(room.source, room.listener, device="cpu")
    emit, u = torch.rand(64), torch.rand(3, 64, 3)
    hits = tt.trace_hits_only(scene, p, emit, u)
    assert tuple(hits.valid.shape) == (3, 2, 64, 1)
    with pytest.raises(ValueError):
        tt.trace(scene, p, emit, torch.rand(3, 32, 3))
    # patterns are traced (tests/test_torch_directivity.py); their shapes
    # are checked: an odd coefficient count, one row per listener
    with pytest.raises(ValueError, match="directivity"):
        tt.trace(scene, p._replace(directivity=torch.ones(2)), emit, u)
    with pytest.raises(ValueError, match="mic_directivity"):
        tt.trace(scene, p._replace(mic_directivity=torch.ones(2, 3)), emit,
                 u)
    # the transmission surrogate runs (the differentiable path's branch,
    # diff.py) and, with every transmission 0, is the hard trace bit for
    # bit, with and without the sweeps of use_kernels
    opaque = scene._replace(transmission=torch.zeros_like(
        scene.transmission))
    for kernels in (False, True):
        hard = tt.trace_hits_only(opaque, p, emit, u, use_kernels=kernels)
        surr = tt.trace_hits_only(opaque, p, emit, u, use_kernels=kernels,
                                  transmission_surrogate=True)
        assert all(torch.equal(a, b) for a, b in zip(hard, surr))
    with pytest.raises(ValueError, match="n_debug"):
        tt.trace(scene, p, emit, u, n_debug=65)
    _, dbg = tt.trace(scene, p, emit, u, n_debug=4)
    assert tuple(dbg.pos.shape) == (4, 4, 2)
