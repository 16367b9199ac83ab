"""PyTorch port: the multi-source mixdown (BASELINE.json config #4)
against the JAX package on the CPU.

The S sources become S entries of the rooms-batched kernel K9 over one
shared scene; on the CPU that is its plain version. Tolerances: plain vs
JAX ``trace_sources_mixdown(backend="jnp")`` on JAX's per-source uniforms
(``jax.random.split(key, S)``): total energy to 1e-4 and per-bin L1 to
1%, the limits of test_torch_bounce_kernel.py. Sizes: <= 64 sources,
<= 1,024 rays, <= 5 bounces, 8 kHz, 2,048 bins."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import CPU, jax_source_uniforms, to_numpy

from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.ops.trace import \
    TraceParams as JaxTraceParams
from realisticaudioraytracing2d_tpu.parallel.multisource import \
    trace_sources_mixdown as jax_mixdown
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams
from realisticaudioraytracing2d_tpu_torch.parallel.multisource import \
    trace_sources_mixdown

SR, T = 8000, 2048
EARS = np.array([[-0.2, -3.68], [0.2, -3.68]], np.float32)


def _sources(n, seed=11):
    """Source positions of tests/test_parallel.py's 64-source mixdown."""
    g = np.random.default_rng(seed)
    return np.stack([g.uniform(-15, 15, n), g.uniform(-3, 8, n)],
                    -1).astype(np.float32)


def test_mixdown_plain_matches_jax_mixdown():
    key = jax.random.PRNGKey(21)
    n_src, n_rays, n_bounces = 4, 1024, 5
    sources = _sources(n_src)
    gains = np.array([1.0, 0.5, 2.0, 1.5], np.float32)
    room = jax_rooms.smoll_room()
    want = np.asarray(jax_mixdown(
        room.scene, JaxTraceParams.make(sources, EARS, 0.5, 343.0, gains),
        key, n_rays=n_rays, max_bounces=n_bounces, sample_rate=SR,
        ir_length=T, backend="jnp"))
    got = to_numpy(trace_sources_mixdown(
        rooms.smoll_room(device=CPU).scene,
        TraceParams.make(sources, EARS, input_gain=gains, device=CPU), 0,
        n_rays=n_rays, max_bounces=n_bounces, sample_rate=SR, ir_length=T,
        uniforms=jax_source_uniforms(key, n_src, n_bounces, n_rays)))
    assert got.shape == want.shape == (2, T, 1)
    assert (want != 0).sum() > 300
    assert abs(got.sum() - want.sum()) / want.sum() < 1e-4
    assert np.abs(got - want).sum() / np.abs(want).sum() < 1e-2


def test_mixdown_equals_the_sum_of_single_source_traces():
    room = rooms.smoll_room(device=CPU)
    n_src, n_rays, n_bounces = 3, 512, 5
    sources = _sources(n_src, seed=4)
    gains = torch.tensor([1.0, 3.0, 0.25])
    mix = trace_sources_mixdown(
        room.scene, TraceParams.make(sources, EARS, input_gain=gains,
                                     device=CPU), 8,
        n_rays=n_rays, max_bounces=n_bounces, sample_rate=SR, ir_length=T)
    singles = [bk.trace_frames_ir_plain(
        room.scene, TraceParams.make(sources[s], EARS, input_gain=gains[s],
                                     device=CPU),
        *rng.philox_uniforms(8, 1, n_bounces, n_rays, CPU, entry=s),
        sample_rate=SR, ir_length=T) for s in range(n_src)]
    assert torch.equal(mix, torch.stack(singles).sum(0))
    assert all(float(s.sum()) > 0 for s in singles)
    torch.testing.assert_close(mix, singles[0] + singles[1] + singles[2],
                               rtol=1e-6, atol=1e-12)


def test_64_sources_stereo_mixdown():
    # BASELINE config #4 at small size: 64 simultaneous sources sharing
    # one scene, batched trace + mixdown to a stereo listener
    room = rooms.smoll_room(device=CPU)
    params = TraceParams.make(_sources(64), EARS, device=CPU)
    ir = trace_sources_mixdown(room.scene, params, 0, n_rays=128,
                               max_bounces=4, sample_rate=SR, ir_length=T)
    assert tuple(ir.shape) == (2, T, 1)
    assert float(ir.sum()) > 0
    assert not torch.allclose(ir[0], ir[1])


def test_mixdown_refuses_what_it_does_not_take():
    room = rooms.smoll_room(device=CPU)
    params = TraceParams.make(_sources(2), EARS, device=CPU)
    kw = dict(n_rays=16, max_bounces=1, sample_rate=SR, ir_length=64)
    with pytest.raises(ValueError, match="backend"):
        trace_sources_mixdown(room.scene, params, 0, backend="jnp", **kw)
    # per-source patterns need one row per source
    with pytest.raises(ValueError, match="directivity"):
        trace_sources_mixdown(
            room.scene, params._replace(directivity=torch.ones(3, 3)), 0,
            **kw)


@pytest.mark.parametrize("path", ["trace_frames_ir_mega", "engine"])
def test_single_source_paths_refuse_a_batch_of_sources(path):
    # TraceParams.make takes [S, 2] for the mixdown; a single-source path
    # handed such a batch says so instead of failing further down
    import realisticaudioraytracing2d_tpu_torch as art
    room = rooms.smoll_room(device=CPU)
    params = TraceParams.make(_sources(3), EARS, device=CPU)
    with pytest.raises(ValueError, match=r"one source \[2\]"):
        if path == "engine":
            art.Engine(room.scene, art.smoll_room_config(ray_count=16)
                       ).trace_frames(params, seed=0, n_frames=1)
        else:
            bk.trace_frames_ir_mega(room.scene, params, 0, 1, n_rays=16,
                                    max_bounces=1, sample_rate=SR,
                                    ir_length=64)
