"""PyTorch port: geometry primitives and random numbers vs JAX.

Geometry: the same float32 fuzz inputs (numpy, seeded) through both
packages. Functions built only from +, -, *, / and sqrt round the same in
both and must agree to 1e-6 relative (XLA may contract a multiply-add
that torch rounds twice, one ulp). Functions with sin/cos agree to 1e-5:
the two libraries' float32 sin/cos differ by an ulp on ~5% of inputs.
``hlsl_random`` is integer arithmetic and must be bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_numpy, to_torch

from realisticaudioraytracing2d_tpu.ops import geometry as jg
from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
from realisticaudioraytracing2d_tpu_torch.ops import geometry as g
from realisticaudioraytracing2d_tpu_torch.ops import rng as trng


def _rays(rng_np, n):
    o = rng_np.uniform(-10, 10, (n, 2)).astype(np.float32)
    ang = rng_np.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    return o, d


def _close(got, want, rtol, atol=1e-6):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_pairwise_segment_fuzz_matches_jax(rng):
    o, d = _rays(rng, 256)
    a = rng.uniform(-10, 10, (48, 2)).astype(np.float32)
    b = rng.uniform(-10, 10, (48, 2)).astype(np.float32)
    b[-4:] = a[-4:]                              # degenerate padding walls
    got = g.pairwise_ray_segment_t(*map(to_torch, (o, d, a, b)))
    want = jg.pairwise_ray_segment_t(*map(jnp.asarray, (o, d, a, b)))
    _close(got, want, rtol=1e-6)
    assert bool(torch.all(got[:, -4:] == g.INF))
    # the single-pair form agrees with the pairwise one
    single = g.ray_segment_intersect(to_torch(o)[:, None], to_torch(d)[:, None],
                                     to_torch(a)[None], to_torch(b)[None])
    np.testing.assert_allclose(to_numpy(single), to_numpy(got), rtol=1e-4,
                               atol=1e-4)


def test_circle_refract_reflect_normalize_match_jax(rng):
    o, d = _rays(rng, 512)
    c = rng.uniform(-10, 10, (512, 2)).astype(np.float32)
    r = np.float32(3.0)
    _close(g.ray_circle_intersect(to_torch(o), to_torch(d), to_torch(c),
                                  torch.tensor(r)),
           jg.ray_circle_intersect(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(c), jnp.asarray(r)), rtol=1e-6)
    n = d[::-1].copy()
    eta = rng.uniform(0.2, 3.0, 512).astype(np.float32)
    t, ok = g.refract(to_torch(d), to_torch(n), to_torch(eta))
    jt, jok = jg.refract(jnp.asarray(d), jnp.asarray(n), jnp.asarray(eta))
    np.testing.assert_array_equal(to_numpy(ok), np.asarray(jok))
    _close(t, jt, rtol=1e-6)
    _close(g.reflect(to_torch(d), to_torch(n)),
           jg.reflect(jnp.asarray(d), jnp.asarray(n)), rtol=1e-6)
    v = o.copy()
    v[:3] = 0.0                                   # zero vectors stay zero
    _close(g.normalize(to_torch(v)), jg.normalize(jnp.asarray(v)), rtol=1e-6)
    ang = rng.uniform(-4, 4, 512).astype(np.float32)
    _close(g.rotate(to_torch(o), to_torch(ang)),
           jg.rotate(jnp.asarray(o), jnp.asarray(ang)), rtol=1e-5, atol=1e-5)


def test_nearest_hit_keeps_first_index_among_ties():
    t = torch.tensor([[5.0, 2.0, 2.0, 7.0],
                      [g.INF, g.INF, g.INF, g.INF],
                      [3.0, 3.0, 3.0, 3.0],
                      [9.0, 8.0, 1.0, 1.0]])
    closest, idx = g.nearest_hit(t)
    np.testing.assert_array_equal(to_numpy(idx), [1, -1, 0, 2])
    jc, ji = jg.nearest_hit(jnp.asarray(to_numpy(t)))
    np.testing.assert_array_equal(to_numpy(idx), np.asarray(ji))
    np.testing.assert_array_equal(to_numpy(closest), np.asarray(jc))
    assert idx.dtype == torch.int32


def test_nearest_hit_nan_row_takes_jax_argmin_index(rng):
    """A row whose minimum is NaN gets the index of its first NaN, as
    ``jnp.argmin`` gives; ties, misses and ordinary rows keep their
    results, and no index leaves ``[-1, W)``."""
    nan = float("nan")
    rows = np.array([[3.0, nan, 1.0, 1e30],
                     [nan, 2.0, nan, 0.5],
                     [4.0, 4.0, 4.0, nan],
                     [5.0, 2.0, 2.0, 7.0],
                     [g.INF, g.INF, g.INF, g.INF],
                     [g.INF, g.INF, nan, g.INF],
                     [9.0, 8.0, 1.0, 1.0]], np.float32)
    t = np.concatenate([rows, rng.uniform(0, 50, (64, 4))
                        .astype(np.float32)])
    closest, idx = g.nearest_hit(to_torch(t))
    jc, ji = jg.nearest_hit(jnp.asarray(t))
    np.testing.assert_array_equal(to_numpy(idx), np.asarray(ji))
    np.testing.assert_array_equal(to_numpy(closest), np.asarray(jc))
    np.testing.assert_array_equal(to_numpy(idx)[:7], [1, 0, 3, 1, -1, 2, 2])
    assert ((idx >= -1) & (idx < t.shape[-1])).all()


def test_hlsl_random_bit_exact(rng):
    state = rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64).astype(np.uint32)
    state[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    js, ts = jnp.asarray(state), torch.from_numpy(state.astype(np.int64))
    for _ in range(3):                            # chained steps
        jv, js = jax_rng.hlsl_random(js)
        tv, ts = trng.hlsl_random(ts)
        np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv))
        np.testing.assert_array_equal(to_numpy(ts).astype(np.uint32),
                                      np.asarray(js))
    frame = int(rng.integers(0, 5))
    np.testing.assert_array_equal(
        to_numpy(trng.ray_init_state(1000, frame, device="cpu")
                 ).astype(np.uint32),
        np.asarray(jax_rng.ray_init_state(1000, jnp.asarray(frame))))


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox-4x32-10."""
    words = trng.philox4x32(*(torch.tensor([c], dtype=torch.int64)
                             for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_philox_uniforms_layout_and_streams():
    emit, u = trng.philox_uniforms(1234, 3, 4, 100, device="cpu")
    assert emit.shape == (3, 100) and u.shape == (3, 4, 100, 3)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert emit.dtype == u.dtype == torch.float32
    e2, u2 = trng.philox_uniforms(1234, 3, 4, 100, device="cpu")
    assert torch.equal(emit, e2) and torch.equal(u, u2)
    # frame f of a 3-frame draw is frame f of a longer one: counters, not
    # a sequential stream
    e5, u5 = trng.philox_uniforms(1234, 5, 4, 100, device="cpu")
    assert torch.equal(u5[:3], u) and torch.equal(e5[:3], emit)
    e_other, _ = trng.philox_uniforms(1235, 3, 4, 100, device="cpu")
    assert not torch.equal(emit, e_other)
    # the uniforms look uniform: mean 0.5, var 1/12
    all_u = torch.cat([emit.ravel(), u.ravel()])
    assert abs(float(all_u.mean()) - 0.5) < 0.02
    assert abs(float(all_u.var()) - 1 / 12) < 0.01


def test_mix_seed_and_generator_draws():
    seeds = {trng.mix_seed(7, i) for i in range(1000)}
    assert len(seeds) == 1000
    assert trng.mix_seed(7, 3) == trng.mix_seed(7, 3) != trng.mix_seed(8, 3)
    assert trng.seed_key(2 ** 32 + 5) == (5, 1)
    gen = torch.Generator().manual_seed(0)
    emit, u = trng.bounce_uniforms(gen, 2, 3, 10, device="cpu")
    assert emit.shape == (2, 10) and u.shape == (2, 3, 10, 3)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(trng.bounce_uniforms(gen, 2, 3, 10, device="cpu")[1], u)
