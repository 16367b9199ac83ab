"""PyTorch port: ``diff.localize_source`` against the JAX package on the
CPU, at the JAX tests' fixture (``tests/test_diff.py``: a 4 x 4 m
shoebox, 64-256 rays, 4 bounces, 8 kHz, 512 bins).

* The first 8 steps of a 4-start localization from JAX's start draw, fed
  JAX's draws (the same key every step, as JAX's common random numbers):
  positions within 1e-4 and final losses within rtol 1e-3, the
  tolerances of JAX's ``test_localize_sharded_matches_unsharded`` (Adam
  amplifies the ulps of XLA's and torch's ``sin`` / ``cos``).
* Port-only twins of JAX's recovery tests with JAX's assertions: one
  listener, a hard-binned multi-frame target, an uncalibrated target
  (``gain_invariant``) and warm-started tracking, on the port's seeded
  Philox draws. The two-source localization runs on the card
  (``tests/test_torch_cuda.py``), past this file's CPU budget.
* The start draw (``mix_seed(seed, 0x10C8)`` into a CPU
  ``torch.Generator``: the same starts on any device) and ``mesh=``'s
  refusal of starts that do not divide evenly (``test_torch_parallel.py``
  holds the sharded fit against the unsharded one)."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import CPU, to_numpy, to_torch

from realisticaudioraytracing2d_tpu import diff as jd
from realisticaudioraytracing2d_tpu.models.materials import \
    AudioMaterial as JMat
from realisticaudioraytracing2d_tpu.models.rooms import \
    shoebox_room as jshoebox
from realisticaudioraytracing2d_tpu.ops import rng as jrng
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams as JParams
from realisticaudioraytracing2d_tpu_torch import convert, diff
from realisticaudioraytracing2d_tpu_torch.ops.rng import mix_seed
from realisticaudioraytracing2d_tpu_torch.parallel.mesh import make_mesh

SR = 8000
IR_LEN = 512
BOUNCES = 4


def _scene():
    scene = jshoebox(4.0, 4.0, wall_material=JMat(absorption=0.3,
                                                  scattering=0.4))
    return scene, convert.scene_from_arrays(scene, device=CPU)


def _params(source, listeners, radius=0.5):
    p = JParams.make(source=source, listeners=listeners,
                     listener_radius=radius)
    return p, convert.params_from_arrays(p, device=CPU)


def _target(scene, params, seed, n_rays, **kw):
    return diff.simulate_ir(scene, params, seed, n_rays=n_rays,
                            max_bounces=BOUNCES, sample_rate=SR,
                            ir_length=IR_LEN, soft=kw.pop("soft", True),
                            device=CPU, **kw)


def test_localize_first_steps_fed_jax_draws_match_jax():
    jscene, tscene = _scene()
    jp, tp = _params((-1.0, 0.4), (1.0, 0.3))
    key = jax.random.PRNGKey(0)
    target = jd.simulate_ir(jscene, jp, key, n_rays=64, max_bounces=BOUNCES,
                            sample_rate=SR, ir_length=IR_LEN, soft=True)
    bounds = jd.scene_bounds(jscene)
    starts = np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 0x10C8), (4, 1, 2), minval=bounds[0],
        maxval=bounds[1]))
    kw = dict(n_rays=64, max_bounces=BOUNCES, sample_rate=SR, steps=8)
    want = jd.localize_source(jscene, jp, target, key, starts=starts, **kw)
    emit, u = jrng.bounce_uniforms(key, BOUNCES, 64)
    draws = (to_torch(np.asarray(emit))[None], to_torch(np.asarray(u))[None])
    got = diff.localize_source(tscene, tp, to_torch(target), 0,
                               starts=starts, uniforms_fn=lambda i, j: draws,
                               device=CPU, **kw)
    assert tuple(got.positions.shape) == (4, 2)
    np.testing.assert_allclose(to_numpy(got.positions),
                               np.asarray(want.positions), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_numpy(got.losses), np.asarray(want.losses),
                               rtol=1e-3)
    assert int(torch.argmin(got.losses)) == int(np.argmin(want.losses))
    np.testing.assert_allclose(to_numpy(got.position),
                               np.asarray(want.position), atol=1e-4)


def test_localize_source_single_listener():
    """Twin of JAX's test: one microphone localizes the source."""
    _, scene = _scene()
    _, params = _params((-1.0, 0.4), (1.0, 0.3))
    target = _target(scene, params, 0, 256)
    result = diff.localize_source(scene, params, target, 0, n_rays=256,
                                  max_bounces=BOUNCES, sample_rate=SR,
                                  n_starts=6, steps=150, device=CPU)
    err = float(torch.linalg.norm(result.position - params.source))
    assert err < 0.15, (to_numpy(result.position), err,
                        to_numpy(result.positions), to_numpy(result.losses))


def test_localize_hard_binned_target():
    """Twin of JAX's test: the target is hard-binned and multi-frame (what
    ``trace --ir-out`` writes), the fit's forward the soft splat."""
    _, scene = _scene()
    _, params = _params((-1.0, 0.4), (1.0, 0.3))
    target = _target(scene, params, 0, 256, soft=False, frames=4)
    result = diff.localize_source(scene, params, target, 0, n_rays=256,
                                  max_bounces=BOUNCES, sample_rate=SR,
                                  n_starts=6, steps=150, device=CPU)
    err = float(torch.linalg.norm(result.position - params.source))
    assert err < 0.15, (to_numpy(result.position), err)


def test_localize_gain_invariant_handles_uncalibrated_target():
    """Twin of JAX's test: a target 7.3x too loud still localizes when
    the IR term projects out the optimal gain."""
    _, scene = _scene()
    _, params = _params((-1.0, 0.4), (1.0, 0.3))
    target = _target(scene, params, 0, 256)
    result = diff.localize_source(scene, params, 7.3 * target, 0,
                                  n_rays=256, max_bounces=BOUNCES,
                                  sample_rate=SR, n_starts=6, steps=150,
                                  gain_invariant=True, device=CPU)
    err = float(torch.linalg.norm(result.position - params.source))
    assert err < 0.15, (to_numpy(result.position), err)


def test_localize_warm_start_tracks_motion():
    """Twin of JAX's test: warm-started localization (``starts=``)
    follows a moving source chunk to chunk."""
    _, scene = _scene()
    _, params = _params((0.0, 0.0), (1.2, 0.8))
    path = np.array([[-1.0, -0.6], [-0.8, -0.35], [-0.6, -0.15]],
                    np.float32)
    prev = path[0] + np.array([0.15, -0.1], np.float32)
    errs = []
    for true_src in path:
        p = params._replace(source=torch.from_numpy(true_src))
        target = _target(scene, p, 0, 128)
        ring = prev[None, :] + 0.2 * np.array(
            [[0, 0], [1, 0], [-1, 0], [0, 1], [0, -1]], np.float32)
        result = diff.localize_source(
            scene, params, target, 0, n_rays=128, max_bounces=BOUNCES,
            sample_rate=SR, starts=ring, steps=40, sigma0=10.0,
            anneal_steps=15.0, device=CPU)
        prev = to_numpy(result.position)
        errs.append(float(np.linalg.norm(prev - true_src)))
    assert np.mean(errs) < 0.25, errs
    assert errs[-1] < 0.25, errs


def test_localize_starts_and_refusals():
    """The start draw: ``mix_seed(seed, 0x10C8)`` (or ``starts_seed``)
    into a CPU generator, uniform over the bounds; explicit starts take
    any of JAX's shapes; ``mesh=`` refuses starts that do not divide
    evenly over its axis."""
    _, scene = _scene()
    _, params = _params((-1.0, 0.4), (1.0, 0.3))
    target = _target(scene, params, 0, 64)
    # lr 0: one step leaves every start where it was drawn
    kw = dict(n_rays=16, max_bounces=2, sample_rate=SR, steps=1, lr=0.0,
              device=CPU)
    bounds = np.array([[-1.5, -1.0], [1.0, 1.5]], np.float32)
    res = diff.localize_source(scene, params, target, 5, n_starts=7,
                               bounds=bounds, **kw)
    gen = torch.Generator().manual_seed(mix_seed(5, 0x10C8))
    lo, hi = torch.from_numpy(bounds[0]), torch.from_numpy(bounds[1])
    want = torch.maximum(lo, torch.rand((7, 1, 2), generator=gen)
                         * (hi - lo) + lo)[:, 0]
    assert torch.equal(res.positions, want)
    assert tuple(res.losses.shape) == (7,) and torch.isfinite(
        res.losses).all()
    assert torch.equal(res.position, res.positions[int(torch.argmin(
        res.losses))])
    other = diff.localize_source(scene, params, target, 5, n_starts=7,
                                 bounds=bounds, starts_seed=9, **kw)
    assert not torch.equal(other.positions, res.positions)
    for starts, n in (([0.1, 0.2], 1), (np.zeros((3, 2)), 3)):
        assert diff.localize_source(scene, params, target, 0, starts=starts,
                                    **kw).positions.shape[0] == n
    with pytest.raises(ValueError, match="7 starts not divisible"):
        diff.localize_source(scene, params, target, 5, n_starts=7,
                             mesh=make_mesh((2,), ("rooms",),
                                            devices=[CPU] * 2), **kw)
