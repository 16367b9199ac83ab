"""PyTorch port: ``diff.py`` (material fitting, the soft splat, the
transmission surrogate) against the JAX package on the CPU, at the JAX
tests' fixtures (``tests/test_diff.py``: a 4 x 4 m shoebox, 64-256 rays,
4 bounces, 8 kHz, 512 bins), with JAX's draws handed to the port.

Tolerances, and why:

* ``infer_material_groups``, ``first_arrival_times``, ``scene_bounds``:
  equal (host numpy on both sides).
* ``MaterialParams.from_scene`` / ``constrained`` / ``apply_materials``:
  within 1 ulp (XLA's and torch's ``log`` / ``log1p`` / ``sigmoid``),
  padding rows bit for bit; ``_sigma_schedule`` within 1 ulp (``pow``).
* ``scatter_hits_soft`` on JAX's hits: bit for bit (the same deposits in
  the same order).
* Losses, ``edc``, ``gaussian_blur_time``: rtol 1e-6 of the largest value
  (float32 summation order: XLA's cumsum is a parallel scan, its
  convolution blocked; the port's blur sums in float64).
* ``simulate_ir`` fed JAX's uniforms (hard, soft, surrogate; 1 and 3
  frames): XLA's and torch's float32 ``sin`` / ``cos`` / ``asin`` round an
  ulp apart on a few percent of the rays (``tests/test_torch_trace.py``),
  also with ``jax.disable_jit()``, so the IRs are not bit-equal: total
  energy within rtol 1e-5, every bin within 2e-4 of the largest bin (the
  soft splat turns an ulp of delay into an ulp of ``frac`` times the
  sample rate). The surrogate with every transmission 0 equals the hard
  forward bit for bit.
* Gradients (``value_and_grad`` of a log-EDC loss through
  ``apply_materials`` -> ``simulate_ir``) for absorption, scattering,
  ior (soft) and transmission (surrogate): within rtol 1e-4 of
  ``jax.value_and_grad``, and the port's absorption gradient within 5e-2
  of its own central difference (JAX's check).
* The first 3 ``fit_materials`` steps fed JAX's per-step draws: losses
  within rtol 1e-3, fitted logits within 1e-4 (the tolerances of JAX's
  ``test_localize_sharded_matches_unsharded``: Adam amplifies an ulp).

The localization tests are in ``tests/test_torch_localize.py``. Twins of
JAX's recovery tests keep JAX's assertions; the transmission recovery and
the transmission gradient against finite differences over keys run on the
card (``tests/test_torch_cuda.py``), past this file's CPU budget."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CPU, to_numpy, to_torch

from realisticaudioraytracing2d_tpu import diff as jd
from realisticaudioraytracing2d_tpu.models.materials import \
    AudioMaterial as JMat
from realisticaudioraytracing2d_tpu.models.rooms import \
    shoebox_room as jshoebox
from realisticaudioraytracing2d_tpu.models.scene import \
    Transform2D as JTransform
from realisticaudioraytracing2d_tpu.ops import ir as jir
from realisticaudioraytracing2d_tpu.ops import rng as jrng
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams as JParams
from realisticaudioraytracing2d_tpu.ops.trace import \
    trace_hits_only as jtrace_hits
from realisticaudioraytracing2d_tpu_torch import convert, diff
from realisticaudioraytracing2d_tpu_torch.ops import ir as tir

SR = 8000
IR_LEN = 512
N_RAYS = 64
BOUNCES = 4


def _setup(absorption=0.3, scattering=0.4, obstacle=False):
    """JAX's ``tests/test_diff.py::_setup``: (JAX scene, JAX params)."""
    obstacles = None
    if obstacle:
        obstacles = [(JTransform((0.8, -0.8), 0.3, (0.6, 0.6)),
                      JMat(absorption=0.7, scattering=0.1))]
    scene = jshoebox(4.0, 4.0, wall_material=JMat(absorption=absorption,
                                                  scattering=scattering),
                     obstacles=obstacles)
    return scene, JParams.make(source=(-1.0, 0.0), listeners=(1.0, 0.3),
                               listener_radius=0.5)


def _setup_transmissive(transmission):
    """JAX's divider fixture (``_setup_transmissive``)."""
    scene = jshoebox(
        4.0, 4.0, wall_material=JMat(absorption=0.3, scattering=0.2),
        obstacles=[(JTransform((0.0, 0.0), 0.0, (0.2, 3.0)),
                    JMat(absorption=0.1, scattering=0.0,
                         transmission=transmission))])
    return scene, JParams.make(source=(-1.2, 0.0), listeners=(1.2, 0.2),
                               listener_radius=0.5)


def _setup_ior(ior):
    """JAX's ``test_fit_recovers_ior`` fixture: a transmissive slab."""
    scene = jshoebox(
        4.0, 4.0, wall_material=JMat(absorption=0.3, scattering=0.2),
        obstacles=[(JTransform((0.0, 0.0), 0.0, (1.0, 2.5)),
                    JMat(absorption=0.05, scattering=0.0, transmission=1.0,
                         ior=ior))])
    return scene, JParams.make(source=(-1.4, 0.0), listeners=(1.4, 0.1),
                               listener_radius=0.4)


def _port(scene, params):
    return (convert.scene_from_arrays(scene, device=CPU),
            convert.params_from_arrays(params, device=CPU))


def sim_uniforms(key, frames, n_rays=N_RAYS, bounces=BOUNCES):
    """The draws of JAX's ``simulate_ir(key, frames=F)``: the key itself
    for one frame, ``jax.random.split(key, F)`` for more, as the port's
    ``(emit[F, R], u[F, B, R, 3])``."""
    keys = [key] if frames == 1 else list(jax.random.split(key, frames))
    draws = [jrng.bounce_uniforms(k, bounces, n_rays) for k in keys]
    return (to_torch(np.stack([np.asarray(e) for e, _ in draws])),
            to_torch(np.stack([np.asarray(u) for _, u in draws])))


def _jsim(scene, params, key, **kw):
    kw.setdefault("n_rays", N_RAYS)
    return jd.simulate_ir(scene, params, key, max_bounces=BOUNCES,
                          sample_rate=SR, ir_length=IR_LEN, **kw)


def _tsim(scene, params, key, frames=1, n_rays=N_RAYS, **kw):
    return diff.simulate_ir(scene, params, n_rays=n_rays,
                            max_bounces=BOUNCES, sample_rate=SR,
                            ir_length=IR_LEN, frames=frames,
                            uniforms=sim_uniforms(key, frames, n_rays),
                            device=CPU, **kw)


def _ir_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert want.sum() > 0
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-5)
    assert np.abs(got - want).max() <= 2e-4 * want.max(), \
        np.abs(got - want).max() / want.max()


# -- host helpers, materials, losses -----------------------------------------

@pytest.mark.parametrize("fixture", ["obstacle", "divider"])
def test_infer_material_groups_equals_jax(fixture):
    scene, params = (_setup(obstacle=True) if fixture == "obstacle"
                     else _setup_transmissive(0.5))
    groups, n_groups = diff.infer_material_groups(_port(scene, params)[0])
    want, n_want = jd.infer_material_groups(scene)
    np.testing.assert_array_equal(groups, want)
    assert n_groups == n_want and groups.dtype == np.int32
    # twin of JAX's test: the walls share a group, the obstacle has its own
    if fixture == "obstacle":
        assert len(set(groups[np.asarray(scene.mask)].tolist())) == 2
        assert len(set(groups[:16].tolist())) == 1


def test_material_params_and_apply_materials_match_jax():
    scene, params = _setup(obstacle=True)
    tscene, _ = _port(scene, params)
    groups, n_groups = jd.infer_material_groups(scene)
    jmp = jd.MaterialParams.from_scene(scene, groups, n_groups)
    tmp = diff.MaterialParams.from_scene(tscene, groups, n_groups)
    assert tmp.n_groups == jmp.n_groups == n_groups
    for got, want in zip(tmp, jmp):
        np.testing.assert_array_max_ulp(to_numpy(got), np.asarray(want), 1)
    for got, want in zip(tmp.constrained(), jmp.constrained()):
        np.testing.assert_array_max_ulp(to_numpy(got), np.asarray(want), 1)
    # the same logits (JAX's, carried across) through both
    carried = convert.material_params_from_arrays(jmp, device=CPU)
    fields = ("absorption", "scattering", "transmission", "ior")
    out_j = jd.apply_materials(scene, groups, jmp, fields)
    out_t = diff.apply_materials(tscene, groups, carried, fields)
    pad = ~np.asarray(scene.mask)
    assert pad.any()
    for f in fields:
        got, want = to_numpy(getattr(out_t, f)), np.asarray(getattr(out_j, f))
        np.testing.assert_array_max_ulp(got, want, 1)
        np.testing.assert_array_equal(got[pad], np.asarray(
            getattr(scene, f))[pad])
        np.testing.assert_allclose(got, np.asarray(getattr(scene, f)),
                                   atol=2e-4)
    # fields not fitted and the geometry keep the scene's own tensors
    part = diff.apply_materials(tscene, groups, carried)
    assert part.a is tscene.a and part.ior is tscene.ior \
        and part.transmission is tscene.transmission


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    decay = np.exp(-np.arange(IR_LEN) / 80.0)[None, :, None]
    pred = (rng.random((2, IR_LEN, 2)) * decay).astype(np.float32)
    tgt = (rng.random((2, IR_LEN, 2)) * decay).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(tgt)
    assert sorted(diff._LOSSES) == sorted(jd._LOSSES)
    np.testing.assert_allclose(to_numpy(diff.edc(tp)),
                               np.asarray(jd.edc(pred)), rtol=1e-6)
    for name in diff._LOSSES:
        np.testing.assert_allclose(
            float(diff._LOSSES[name](tp, tt)),
            float(jd._LOSSES[name](pred, tgt)), rtol=1e-6, err_msg=name)
    for sigma in (0.1, 4.0, 24.0):
        for inv in (False, True):
            np.testing.assert_allclose(
                float(diff._blur_rel_l2(tp, tt, sigma, inv)),
                float(jd._blur_rel_l2(pred, tgt, jnp.float32(sigma), inv)),
                rtol=1e-5)


@pytest.mark.parametrize("args", [(100, 16.0, 1.0, 25.0),
                                  (200, 24.0, 1.0, 30.0),
                                  (40, 10.0, 1.0, 15.0)])
def test_sigma_schedule_matches_jax(args):
    got = to_numpy(diff._sigma_schedule(*args))
    want = np.asarray(jd._sigma_schedule(*args))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, 1)


@pytest.mark.parametrize("sigma", [0.1, 1.0, 4.0, 24.0])
def test_gaussian_blur_matches_jax(sigma):
    rng = np.random.default_rng(1)
    ir = rng.random((2, 300, 3)).astype(np.float32)
    got = to_numpy(diff.gaussian_blur_time(torch.from_numpy(ir), sigma))
    want = np.asarray(jd.gaussian_blur_time(ir, jnp.float32(sigma)))
    assert got.shape == want.shape == ir.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_blur_preserves_length_for_short_irs():
    """Twin of JAX's regression: T < 2 * radius + 1 keeps T bins."""
    ir = torch.zeros((1, 128, 1))
    ir[0, 60, 0] = 1.0
    out = diff.gaussian_blur_time(ir, 4.0)
    assert tuple(out.shape) == (1, 128, 1)
    assert int(torch.argmax(out[0, :, 0])) == 60
    np.testing.assert_allclose(float(out.sum()), 1.0, rtol=1e-5)


def test_first_arrivals_and_bounds_match_jax():
    scene, params = _setup()
    tscene, _ = _port(scene, params)
    ir = np.asarray(_jsim(scene, params, jax.random.PRNGKey(0), n_rays=256))
    ir2 = np.concatenate([ir, ir[:, ::-1]], axis=0)
    np.testing.assert_array_equal(diff.first_arrival_times(ir2, SR),
                                  jd.first_arrival_times(ir2, SR))
    np.testing.assert_array_equal(
        diff.first_arrival_times(torch.from_numpy(ir2.copy()), SR),
        jd.first_arrival_times(ir2, SR))
    for shrink in (0.0, 0.05, 0.1):
        np.testing.assert_array_equal(diff.scene_bounds(tscene, shrink),
                                      jd.scene_bounds(scene, shrink))
    lo, hi = diff.scene_bounds(tscene, shrink=0.0)
    assert np.all(lo <= -2.0) and np.all(hi >= 2.0)
    with pytest.raises(ValueError, match="all-zero"):
        diff.first_arrival_times(np.zeros((2, 100, 1)), 8000)


# -- the soft splat and the forward ----------------------------------------

def test_scatter_hits_soft_on_jax_hits_equals_jax():
    scene, params = _setup()
    hits = jtrace_hits(scene, params, jax.random.PRNGKey(2), n_rays=N_RAYS,
                       max_bounces=BOUNCES)
    th = convert.hits_from_arrays(hits, device=CPU)
    for n_bins in (IR_LEN, 200):   # 200: shares fall off the end
        want = np.asarray(jir.scatter_hits_soft(hits, SR, n_bins))
        got = to_numpy(tir.scatter_hits_soft(th, SR, n_bins))
        assert want.sum() > 0
        np.testing.assert_array_equal(got, want)


def test_soft_scatter_delay_gradient_matches_fd():
    """Twin of JAX's test: d(first moment)/d(delay scale) through the
    soft splat matches central differences; the hard scatter's is 0."""
    scene, params = _setup()
    hits = convert.hits_from_arrays(
        jtrace_hits(scene, params, jax.random.PRNGKey(2), n_rays=N_RAYS,
                    max_bounces=BOUNCES), device=CPU)

    def moment(scale, scatter):
        ir = scatter(hits._replace(delay=hits.delay * scale), SR, IR_LEN)
        t = torch.arange(IR_LEN, dtype=torch.float32)
        return torch.sum(ir.sum(dim=(0, 2)) * t)

    one = torch.tensor(1.0, requires_grad=True)
    moment(one, tir.scatter_hits_soft).backward()
    eps = 1e-4
    fd = (moment(torch.tensor(1.0 + eps), tir.scatter_hits_soft)
          - moment(torch.tensor(1.0 - eps), tir.scatter_hits_soft)) \
        / (2 * eps)
    assert abs(float(one.grad)) > 0
    np.testing.assert_allclose(float(one.grad), float(fd), rtol=1e-2)
    # floor carries no gradient: the hard IR does not depend on the scale
    assert not moment(torch.tensor(1.0, requires_grad=True),
                      tir.scatter_hits).requires_grad


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("surrogate", [False, True])
def test_simulate_ir_fed_jax_uniforms_matches_jax(frames, soft, surrogate):
    scene, params = _setup_transmissive(0.3)
    key = jax.random.PRNGKey(5)
    want = _jsim(scene, params, key, frames=frames, soft=soft,
                 transmission_surrogate=surrogate)
    got = _tsim(*_port(scene, params), key, frames=frames, soft=soft,
                transmission_surrogate=surrogate)
    _ir_close(to_numpy(got), want)


def test_simulate_ir_multiframe_is_the_mean_of_its_frames():
    """Twin of JAX's test: frames under checkpoint, summed in order and
    scaled by the float32 1 / F, equal the frames traced one by one."""
    scene, params = _port(*_setup())
    emit, u = sim_uniforms(jax.random.PRNGKey(1), 3)
    kw = dict(n_rays=N_RAYS, max_bounces=BOUNCES, sample_rate=SR,
              ir_length=IR_LEN, device=CPU)
    multi = diff.simulate_ir(scene, params, frames=3, uniforms=(emit, u),
                             **kw)
    one = [diff.simulate_ir(scene, params, uniforms=(emit[f:f + 1],
                                                     u[f:f + 1]), **kw)
           for f in range(3)]
    manual = (one[0] + one[1] + one[2]) * np.float32(1.0 / 3.0)
    assert torch.equal(multi, manual)
    # the seeded forward draws frames 0..F-1 of the Philox stream
    assert torch.equal(diff.simulate_ir(scene, params, 4, frames=3, **kw),
                       diff.simulate_ir(scene, params, 4, frames=3,
                                        remat=False, **kw))


def test_transmission_surrogate_identity_when_all_walls_opaque():
    """Twin of JAX's test: with every transmission 0 the surrogate forward
    is the hard forward bit for bit (q = 0, weight 1), here and in JAX."""
    scene, params = _setup_transmissive(0.0)
    key = jax.random.PRNGKey(0)
    tscene, tparams = _port(scene, params)
    a = _tsim(tscene, tparams, key)
    b = _tsim(tscene, tparams, key, transmission_surrogate=True)
    assert float(a.sum()) > 0 and torch.equal(a, b)
    np.testing.assert_array_equal(
        np.asarray(_jsim(scene, params, key)),
        np.asarray(_jsim(scene, params, key, transmission_surrogate=True)))


# -- gradients ---------------------------------------------------------------

_GRAD_CASES = {
    # field: (fixture, forward options, fitted fields)
    "absorption": (lambda: _setup(obstacle=True), {}, ("absorption",)),
    "scattering": (lambda: _setup(obstacle=True), {}, ("scattering",)),
    "ior": (lambda: _setup_ior(1.2), {"soft": True}, ("ior",)),
    "transmission": (lambda: _setup_transmissive(0.4),
                     {"transmission_surrogate": True}, ("transmission",)),
}


@pytest.mark.parametrize("field", sorted(_GRAD_CASES))
def test_value_and_grad_matches_jax(field):
    make, opts, fields = _GRAD_CASES[field]
    scene, params = make()
    tscene, tparams = _port(scene, params)
    groups, n_groups = jd.infer_material_groups(scene)
    jmp = jd.MaterialParams.from_scene(scene, groups, n_groups)
    key = jax.random.PRNGKey(11)
    target = np.asarray(_jsim(scene, params, jax.random.PRNGKey(12),
                              n_rays=256, **opts))

    def jloss(mp):
        sc = jd.apply_materials(scene, jnp.asarray(groups), mp, fields)
        return jd.log_edc_loss(_jsim(sc, params, key, **opts), target)

    jval, jgrad = jax.value_and_grad(jloss)(jmp)
    tmp = convert.material_params_from_arrays(jmp, device=CPU)
    tmp = diff.MaterialParams(*(x.requires_grad_(True) for x in tmp))
    sc = diff.apply_materials(tscene, groups, tmp, fields)
    tval = diff.log_edc_loss(_tsim(sc, tparams, key, **opts),
                             to_torch(target))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    g = getattr(tmp, field).grad
    want = np.asarray(getattr(jgrad, field))
    assert np.abs(want).max() > 0 and torch.isfinite(g).all()
    np.testing.assert_allclose(to_numpy(g), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_absorption_gradient_matches_central_difference():
    """Twin of JAX's ``test_gradient_matches_central_difference`` on the
    port (the same fixture, draws and rtol 5e-2)."""
    scene, params = _setup()
    tscene, tparams = _port(scene, params)
    groups, n_groups = jd.infer_material_groups(scene)
    mp0 = diff.MaterialParams.from_scene(tscene, groups, n_groups)
    key = jax.random.PRNGKey(0)

    def loss_at(delta):
        mp = mp0._replace(absorption=mp0.absorption + delta)
        return torch.sum(_tsim(diff.apply_materials(tscene, groups, mp),
                               tparams, key))

    delta = torch.zeros_like(mp0.absorption, requires_grad=True)
    loss_at(delta).backward()
    eps = 1e-3
    checked = 0
    with torch.no_grad():
        for gi in range(n_groups):
            e = torch.zeros_like(mp0.absorption)
            e[gi] = eps
            fd = float(loss_at(e) - loss_at(-e)) / (2 * eps)
            ad = float(delta.grad[gi].sum())
            if abs(fd) < 1e-7 and abs(ad) < 1e-7:
                continue  # a group no ray hits (padding)
            np.testing.assert_allclose(ad, fd, rtol=5e-2)
            checked += 1
    assert checked >= 1


def test_tangent_circle_gradient_finite():
    """Twin of JAX's regression: exact float32 tangency keeps the
    listener-circle distance's gradient finite."""
    from realisticaudioraytracing2d_tpu_torch.ops.geometry import \
        ray_circle_intersect
    o = torch.zeros(2, requires_grad=True)
    ray_circle_intersect(o, torch.tensor([1.0, 0.0]),
                         torch.tensor([5.0, 1.0]),
                         torch.tensor(1.0)).backward()
    assert torch.isfinite(o.grad).all()


@pytest.mark.parametrize("n_rays, sample_rate, ir_length, seed", [
    (64, SR, IR_LEN, 0), (256, SR, 2048, 0), (15000, 48000, 72000, 5)])
def test_scattering_gradient_finite_on_refractive_scene(n_rays, sample_rate,
                                                        ir_length, seed):
    """Twin of JAX's regression on SmollRoom (its transmissive slant wall
    takes the refraction path): every gradient is finite. At JAX's 512
    bins (64 ms) the first arrival (~63 ms) barely lands and the
    gradients are zero; at 2,048 bins and at the CLI's width (15,000 x 5,
    48 kHz, 72,000 bins; seed 5 has a ray at ``cost2 == 0`` in
    ``refract``, ``test_refract_gradient_finite_where_cost2_is_zero``)
    they must also be nonzero."""
    from realisticaudioraytracing2d_tpu_torch.models import rooms
    from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams
    room = rooms.smoll_room(device=CPU)
    params = TraceParams.make(room.source, room.listener,
                              listener_radius=room.listener_radius,
                              device=CPU)
    groups, n_groups = diff.infer_material_groups(room.scene)
    mp = diff.MaterialParams.from_scene(room.scene, groups, n_groups)
    mp = diff.MaterialParams(*(x.requires_grad_(True) for x in mp))
    sc = diff.apply_materials(room.scene, groups, mp,
                              ("absorption", "scattering"))
    bounces = 4 if n_rays < 15000 else 5
    pred = diff.simulate_ir(sc, params, seed, n_rays=n_rays,
                            max_bounces=bounces, sample_rate=sample_rate,
                            ir_length=ir_length, device=CPU)
    torch.sum(pred).backward()
    for leaf in (mp.absorption, mp.scattering):
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    if ir_length > IR_LEN:
        assert float(mp.scattering.grad.abs().sum()) > 0
        assert float(mp.absorption.grad.abs().sum()) > 0


def test_refract_gradient_finite_where_cost2_is_zero():
    """A direction exactly along the wall at eta = 1 gives ``cost2 == 0``:
    the JAX function's ``sqrt(|cost2|)`` has an inf backward there that
    its mask turns into NaN (JAX's SmollRoom gradient at 15,000 rays with
    ``PRNGKey(2)`` is NaN); the port's double ``where`` keeps it finite
    with the same forward values."""
    from realisticaudioraytracing2d_tpu.ops import geometry as jgeo
    from realisticaudioraytracing2d_tpu_torch.ops import geometry as tgeo
    n = np.array([[0.0, 1.0], [0.0, 1.0]], np.float32)
    d = np.array([[1.0, 0.0], [0.6, -0.8]], np.float32)
    eta = np.array([1.0, 0.9], np.float32)
    i = torch.from_numpy(d.copy()).requires_grad_(True)
    t, ok = tgeo.refract(i, torch.from_numpy(n), torch.from_numpy(eta))
    tj, okj = jgeo.refract(d, n, eta)
    np.testing.assert_array_equal(to_numpy(t), np.asarray(tj))
    np.testing.assert_array_equal(to_numpy(ok), np.asarray(okj))
    assert not bool(ok[0]) and bool(ok[1])
    torch.sum(t).backward()
    assert torch.isfinite(i.grad).all()
    gj = jax.grad(lambda x: jnp.sum(jgeo.refract(x, n, eta)[0]))(d)
    assert np.isnan(np.asarray(gj)[0]).any()
    np.testing.assert_allclose(to_numpy(i.grad)[1], np.asarray(gj)[1],
                               rtol=1e-6)


# -- fitting -----------------------------------------------------------------

def test_fit_first_steps_fed_jax_draws_match_jax():
    """Three Adam steps from the same start on JAX's per-step draws
    (``fold_in(key, i)``, two frames each): losses within rtol 1e-3,
    logits within 1e-4. Absorption only: a scattering gradient through a
    grazing listener capture is ill-conditioned
    (``test_grazing_capture_scattering_gradient``)."""
    true_scene, params = _setup(absorption=0.45)
    target = _jsim(true_scene, params, jax.random.PRNGKey(7), frames=2)
    start, _ = _setup(absorption=0.12)
    key = jax.random.PRNGKey(3)
    kw = dict(n_rays=N_RAYS, max_bounces=BOUNCES, sample_rate=SR, frames=2,
              fields=("absorption",), loss="edc+mse", steps=3, lr=0.1)
    want = jd.fit_materials(start, params, target, key, **kw)
    got = diff.fit_materials(
        *_port(start, params), to_torch(target), 3,
        uniforms_fn=lambda i, j: sim_uniforms(jax.random.fold_in(key, i), 2),
        device=CPU, **kw)
    np.testing.assert_allclose(to_numpy(got.losses),
                               np.asarray(want.losses), rtol=1e-3)
    for f in ("absorption", "scattering", "transmission", "ior"):
        np.testing.assert_allclose(to_numpy(getattr(got.params, f)),
                                   np.asarray(getattr(want.params, f)),
                                   atol=1e-4, err_msg=f)
    np.testing.assert_allclose(to_numpy(got.scene.absorption),
                               np.asarray(want.scene.absorption), atol=1e-4)


def test_grazing_capture_scattering_gradient():
    """A direct capture at (r^2 - d^2) / r^2 = 4e-5 (frame 1 of the fit's
    first draws above, bounce 2): d(t_lis)/d(direction) grows as 1 /
    sqrt(r^2 - d^2), so an ulp of ``sin`` / ``cos`` moves the scattering
    gradient by percents. Measured (``tests/torch_diff_divergences.py``):
    JAX jitted -2.7618, JAX with ``jax.disable_jit()`` -2.7576 (XLA's
    multiply-adds alone move it 1.5e-3), the port -2.6926. The port's lies within 5% of JAX's, the
    value within rtol 1e-6."""
    start, params = _setup(absorption=0.12)
    tscene, tparams = _port(start, params)
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 0),
                           2)[1]
    groups, n_groups = jd.infer_material_groups(start)
    jmp = jd.MaterialParams.from_scene(start, groups, n_groups)

    def jloss(mp):
        sc = jd.apply_materials(start, jnp.asarray(groups), mp,
                                ("scattering",))
        return jnp.sum(_jsim(sc, params, key))

    v_jit, g_jit = jax.value_and_grad(jloss)(jmp)
    tmp = diff.MaterialParams(*(
        x.requires_grad_(True)
        for x in convert.material_params_from_arrays(jmp, device=CPU)))
    tval = torch.sum(_tsim(diff.apply_materials(tscene, groups, tmp,
                                                ("scattering",)),
                           tparams, key))
    tval.backward()
    want, got = float(g_jit.scattering[0]), float(tmp.scattering.grad[0])
    assert abs(got - want) <= 5e-2 * abs(want), (got, want)
    np.testing.assert_allclose(float(tval.detach()), float(v_jit),
                               rtol=1e-6)


def test_fit_recovers_absorption():
    """Twin of JAX's test on the port, seeded Philox draws."""
    true_scene, params = _port(*_setup(absorption=0.45))
    target = diff.simulate_ir(true_scene, params, 7, n_rays=N_RAYS,
                              max_bounces=BOUNCES, sample_rate=SR,
                              ir_length=IR_LEN, frames=4, device=CPU)
    start_scene, _ = _port(*_setup(absorption=0.12))
    result = diff.fit_materials(
        start_scene, params, target, 0, n_rays=N_RAYS, max_bounces=BOUNCES,
        sample_rate=SR, frames=1, fields=("absorption",), loss="edc",
        steps=60, lr=0.1, device=CPU)
    losses = to_numpy(result.losses)
    assert losses[-10:].mean() < 0.65 * losses[:10].mean(), losses
    groups, _ = diff.infer_material_groups(start_scene)
    fitted = to_numpy(torch.sigmoid(result.params.absorption))
    assert abs(float(fitted[int(groups[0]), 0]) - 0.45) < 0.08, fitted


def test_fit_recovers_ior():
    """Twin of JAX's test (soft splat, blurred loss, common draws), fed
    JAX's draws of ``PRNGKey(0)``. The recovery depends on the draws: on
    the port's Philox streams the same 70 steps reach 0.5 within 0.1 for
    seeds 2-7 and stall near 1.70 for seeds 0 and 1 (JAX, keys 0-3: all
    recover; fed JAX's keys 0-3, so does the port;
    ``tests/torch_diff_divergences.py``)."""
    sr, ir_len, rays, bounces = 16000, 1024, 256, 6
    draws = sim_uniforms(jax.random.PRNGKey(0), 1, rays, bounces)
    true_scene, params = _port(*_setup_ior(0.5))
    target = diff.simulate_ir(true_scene, params, n_rays=rays,
                              max_bounces=bounces, sample_rate=sr,
                              ir_length=ir_len, soft=True, uniforms=draws,
                              device=CPU)
    start_scene, _ = _port(*_setup_ior(1.8))
    groups, _ = diff.infer_material_groups(start_scene)
    result = diff.fit_materials(
        start_scene, params, target, n_rays=rays, max_bounces=bounces,
        sample_rate=sr, fields=("ior",), loss="blur", soft=True,
        resample=False, steps=70, lr=0.1, uniforms_fn=lambda i, j: draws,
        device=CPU)
    fitted = float(to_numpy(result.params.constrained()[3])[int(groups[16])])
    assert abs(fitted - 0.5) < 0.1, fitted
    # non-fitted fields untouched
    assert torch.equal(result.scene.absorption, start_scene.absorption)


def test_fit_error_paths():
    """JAX's regression (a misspelled field) and an unknown loss raise
    before any trace."""
    scene, params = _port(*_setup())
    kw = dict(n_rays=8, max_bounces=2, sample_rate=SR, steps=1, device=CPU)
    with pytest.raises(ValueError, match="unknown material fields"):
        diff.fit_materials(scene, params, torch.zeros((1, IR_LEN, 1)), 0,
                           fields=("absorbtion",), **kw)
    with pytest.raises(ValueError, match="loss="):
        diff.fit_materials(scene, params, torch.zeros((1, IR_LEN, 1)), 0,
                           loss="l1", **kw)
