"""PyTorch port: the rays x walls sweeps K1/K2 (``ops/cuda/trace_kernel.py``).

On the CPU the wrappers run their plain versions, which are held here
against the JAX package's Pallas kernels ``nearest_hit_pallas`` /
``occlusion_min_pallas`` in interpret mode, on the deliberately unaligned
700 rays x 37 walls case of ``tests/test_pallas.py``, and against the
port's own ``geometry`` functions (bit for bit). tests/test_torch_cuda.py
holds the CUDA kernel against the same plain versions on the card.

Tolerance against JAX: indices equal, distances rtol 5e-5 / atol 1e-4,
the limits of the JAX package's own Pallas-vs-jnp test (the fused kernel
may reorder float arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_numpy, to_torch

from realisticaudioraytracing2d_tpu.ops.pallas import trace_kernel as jax_tk
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.models.scene import Scene
from realisticaudioraytracing2d_tpu_torch.ops import geometry as g
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.ops import trace as tt
from realisticaudioraytracing2d_tpu_torch.ops.cuda import trace_kernel as tk


@pytest.fixture(scope="module")
def case():
    gen = np.random.default_rng(7)
    n, w = 700, 37  # deliberately unaligned sizes
    o = gen.uniform(-30, 30, (n, 2)).astype(np.float32)
    ang = gen.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    a = gen.uniform(-30, 30, (w, 2)).astype(np.float32)
    b = gen.uniform(-30, 30, (w, 2)).astype(np.float32)
    return o, d, a, b


def _scene(a, b) -> Scene:
    """A scene with only its geometry filled in (the sweeps read no more)."""
    a, b = to_torch(a), to_torch(b)
    w = a.shape[0]
    one = torch.ones(w)
    return Scene(a=a, b=b, normal=torch.zeros(w, 2), absorption=one[:, None],
                 scattering=one, transmission=one, ior=one,
                 mask=torch.ones(w, dtype=torch.bool))


def test_pack_walls_is_the_geometry_of_the_jax_table(case):
    _, _, a, b = case
    packed = tk.pack_walls(_scene(a, b))
    assert tuple(packed.shape) == (5, 37) and packed.is_contiguous()
    want = np.asarray(jax_tk.pack_walls(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(to_numpy(packed), want[:5, :37])


def test_nearest_hit_matches_jax_pallas_interpret(case):
    o, d, a, b = case
    t_j, idx_j = jax_tk.nearest_hit_pallas(
        jnp.asarray(o), jnp.asarray(d),
        jax_tk.pack_walls(jnp.asarray(a), jnp.asarray(b)), tile_r=256)
    t, idx = tk.nearest_hit(to_torch(o), to_torch(d),
                            tk.pack_walls(_scene(a, b)))
    assert idx.dtype == torch.int32 and (to_numpy(idx) >= 0).sum() > 300
    np.testing.assert_array_equal(to_numpy(idx), np.asarray(idx_j))
    np.testing.assert_allclose(to_numpy(t), np.asarray(t_j), rtol=5e-5,
                               atol=1e-4)


def test_occlusion_min_matches_jax_pallas_interpret(case):
    o, d, a, b = case
    o4, d4 = o.reshape(-1, 4, 2)[:100], d.reshape(-1, 4, 2)[:100]
    occ_j = jax_tk.occlusion_min_pallas(
        jnp.asarray(o4), jnp.asarray(d4),
        jax_tk.pack_walls(jnp.asarray(a), jnp.asarray(b)), tile_r=256)
    occ = tk.occlusion_min(to_torch(o4), to_torch(d4),
                           tk.pack_walls(_scene(a, b)))
    assert tuple(occ.shape) == (100, 4)
    np.testing.assert_allclose(to_numpy(occ), np.asarray(occ_j), rtol=5e-5,
                               atol=1e-4)


def test_plain_versions_are_the_geometry_functions_bit_for_bit(case):
    o, d, a, b = (to_torch(x) for x in case)
    walls = tk.pack_walls(_scene(*case[2:]))
    t = g.pairwise_ray_segment_t(o, d, a, b)
    closest, idx = g.nearest_hit(t)
    got_t, got_idx = tk.nearest_hit_plain(o, d, walls)
    assert torch.equal(got_t, closest) and torch.equal(got_idx, idx)
    assert torch.equal(tk.occlusion_min_plain(o, d, walls),
                       t.min(dim=-1).values)
    # a ray that misses every wall: distance INF, index -1
    far = torch.tensor([[1e4, 1e4]]), torch.tensor([[1.0, 0.0]])
    t_far, idx_far = tk.nearest_hit(*far, walls)
    assert float(t_far) == g.INF and int(idx_far) == -1


def test_cpu_wrappers_do_not_count_and_refuse_bad_shapes(case):
    o, d, a, b = (to_torch(x) for x in case)
    walls = tk.pack_walls(_scene(*case[2:]))
    before = tk.nearest_hit.launches, tk.occlusion_min.launches
    tk.nearest_hit(o, d, walls)
    tk.occlusion_min(o, d, walls)
    assert (tk.nearest_hit.launches, tk.occlusion_min.launches) == before
    with pytest.raises(ValueError, match=r"\[5, W\]"):
        tk.nearest_hit(o, d, walls[:4])
    with pytest.raises(ValueError, match=r"\[\.\.\., 2\]"):
        tk.occlusion_min(o, d[:10], walls)
    with pytest.raises(ValueError, match="float32"):
        tk.nearest_hit(o.double(), d.double(), walls)


@pytest.mark.parametrize("n_listeners", [1, 2])
def test_trace_with_kernels_equals_plain_trace(n_listeners):
    """On the CPU ``use_kernels=True`` runs the plain sweeps: the same bits
    as the plain trace, debug paths included."""
    room = rooms.smoll_room(n_bands=2, device="cpu")
    lis = np.stack([room.listener, room.listener + [1.5, 0.5]])[:n_listeners]
    p = tt.TraceParams.make(room.source, lis, device="cpu")
    emit, u = rng.philox_uniforms(4, 1, 4, 512, "cpu")
    h0, d0 = tt.trace(room.scene, p, emit[0], u[0], n_debug=16)
    h1, d1 = tt.trace(room.scene, p, emit[0], u[0], n_debug=16,
                      use_kernels=True)
    assert int(h0.valid.sum()) > 100
    for got, want in zip(tuple(h1) + tuple(d1), tuple(h0) + tuple(d0)):
        assert torch.equal(got, want)
    only = tt.trace_hits_only(room.scene, p, emit[0], u[0], use_kernels=True)
    assert torch.equal(only.energy, h0.energy)


def test_masked_and_limited_plain_versions(case):
    """``alive``: a masked ray gives (INF, -1) (K1) and INF (K2), the others
    what they gave unmasked; ``limit``: K2's minimum where it is below the
    limit, INF elsewhere; on the CPU the wrappers are these plain
    versions."""
    o, d, a, b = (to_torch(x) for x in case)
    walls = tk.pack_walls(_scene(*case[2:]))
    gen = np.random.default_rng(11)
    alive = torch.as_tensor(gen.uniform(size=o.shape[0]) > 0.3)
    limit = to_torch(gen.uniform(0, 60, o.shape[0]).astype(np.float32))
    t, idx = tk.nearest_hit_plain(o, d, walls)
    t_m, idx_m = tk.nearest_hit(o, d, walls, alive)
    assert torch.equal(t_m[alive], t[alive])
    assert torch.equal(idx_m[alive], idx[alive])
    assert bool((t_m[~alive] == g.INF).all() and (idx_m[~alive] == -1).all())
    m = tk.occlusion_min_plain(o, d, walls)
    m_l = tk.occlusion_min(o, d, walls, limit=limit)
    below = m < limit
    assert 50 < int(below.sum()) < o.shape[0] - 50
    assert torch.equal(m_l[below], m[below])
    assert bool((m_l[~below] == g.INF).all())
    m_ml = tk.occlusion_min(o, d, walls, alive, limit)
    assert torch.equal(m_ml, torch.where(alive, m_l, g.INF))
    # the comparison the callers make does not move: m >= limit
    assert torch.equal(m_ml >= limit, ~(alive & below))
    with pytest.raises(ValueError, match="alive must be"):
        tk.nearest_hit(o, d, walls, alive[:5])
    with pytest.raises(ValueError, match="limit must be torch.float32"):
        tk.occlusion_min(o, d, walls, limit=limit.double())


def test_trace_with_kernels_equals_plain_trace_on_a_city():
    """The masks on a city of 256 walls, two listeners: the same bits as
    the plain trace, hit records and debug paths."""
    room = rooms.city_scene(62, device="cpu")
    lis = np.stack([room.listener, room.source + [1.5, 0.5]])
    p = tt.TraceParams.make(room.source, lis, 2.0, 343.0, 100.0,
                            device="cpu")
    emit, u = rng.philox_uniforms(5, 1, 3, 384, "cpu")
    h0, d0 = tt.trace(room.scene, p, emit[0], u[0], n_debug=16)
    h1, d1 = tt.trace(room.scene, p, emit[0], u[0], n_debug=16,
                      use_kernels=True)
    assert int(h0.valid.sum()) > 10
    for got, want in zip(tuple(h1) + tuple(d1), tuple(h0) + tuple(d0)):
        assert torch.equal(got, want)
