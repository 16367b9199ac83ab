"""Measure the differentiable slice's divergences between the JAX package
and the PyTorch port on the CPU (ROADMAP section 3, the differentiable
slice's entries).

Not a test (pytest does not collect it): it prints the numbers that
section cites, in about four minutes on one CPU core::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_diff_divergences.py

1. ``refract``'s NaN: SmollRoom's d(sum IR)/d(scattering) at the CLI's
   width (15,000 x 5, 48 kHz, 72,000 bins) for JAX keys 0-3 and the
   port's Philox seeds 0-5 (the port's ``refract`` takes a double
   ``where``; JAX's takes ``sqrt(|cost2|)``).
2. The grazing listener capture: the smallest (r^2 - d^2) / r^2 of a
   valid direct capture in the frame ``tests/test_torch_diff.py::
   test_grazing_capture_scattering_gradient`` uses, and the scattering
   gradient there from JAX jitted, JAX with ``jax.disable_jit()`` and the
   port.
3. The ior recovery of ``test_fit_recovers_ior`` (70 steps, common draws)
   on JAX keys 0-3, on the port fed those keys' draws, and on the port's
   Philox seeds 0-7.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_diff import (_port, _setup, _setup_ior, _tsim,  # noqa: E402
                             sim_uniforms)

from realisticaudioraytracing2d_tpu import diff as jd  # noqa: E402
from realisticaudioraytracing2d_tpu.models import rooms as jrooms  # noqa
from realisticaudioraytracing2d_tpu.ops.trace import \
    TraceParams as JParams  # noqa: E402
from realisticaudioraytracing2d_tpu_torch import diff  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops import geometry  # noqa
from realisticaudioraytracing2d_tpu_torch.ops import trace as tt  # noqa

FULL = dict(n_rays=15000, max_bounces=5, sample_rate=48000, ir_length=72000)
FIELDS = ("absorption", "scattering")


def refract_nan():
    room = jrooms.smoll_room()
    jp = JParams.make(room.source, room.listener,
                      listener_radius=room.listener_radius)
    groups, n = jd.infer_material_groups(room.scene)
    jmp = jd.MaterialParams.from_scene(room.scene, groups, n)
    for k in range(4):
        def obj(m, k=k):
            sc = jd.apply_materials(room.scene, jnp.asarray(groups), m,
                                    FIELDS)
            return jnp.sum(jd.simulate_ir(sc, jp, jax.random.PRNGKey(k),
                                          **FULL))
        g = np.asarray(jax.grad(obj)(jmp).scattering)
        print(f"[1] JAX PRNGKey({k}): d/d(scattering) {g}, NaN "
              f"{bool(np.isnan(g).any())}", flush=True)
    scene, params = _port(room.scene, jp)
    for seed in range(6):
        mp = diff.MaterialParams(*(
            x.requires_grad_(True)
            for x in diff.MaterialParams.from_scene(scene, groups, n)))
        torch.sum(diff.simulate_ir(
            diff.apply_materials(scene, groups, mp, FIELDS), params, seed,
            device="cpu", **FULL)).backward()
        g = mp.scattering.grad.numpy()
        print(f"[1] port Philox seed {seed}: d/d(scattering) {g}, NaN "
              f"{bool(np.isnan(g).any())}", flush=True)


def grazing():
    start, params = _setup(absorption=0.12)
    tscene, tparams = _port(start, params)
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 0),
                           2)[1]
    seen = []
    circle = tt.ray_circle_intersect

    def spy(o, d, c, r):
        lc = c - o
        tca = geometry.dot2(lc, d)
        seen.append(((r * r - (geometry.dot2(lc, lc) - tca * tca))
                     / (r * r)).detach())
        return circle(o, d, c, r)

    tt.ray_circle_intersect = spy
    emit, u = sim_uniforms(key, 1)
    hits = tt.trace_hits_only(tscene, tparams, emit[0], u[0])
    tt.ray_circle_intersect = circle
    rel = min(float(s[:, 0][hits.valid[b, 0, :, 0]].min())
              for b, s in enumerate(seen) if bool(hits.valid[b, 0].any()))
    groups, n = jd.infer_material_groups(start)
    jmp = jd.MaterialParams.from_scene(start, groups, n)

    def jloss(mp):
        sc = jd.apply_materials(start, jnp.asarray(groups), mp,
                                ("scattering",))
        return jnp.sum(jd.simulate_ir(sc, params, key, n_rays=64,
                                      max_bounces=4, sample_rate=8000,
                                      ir_length=512))

    g_jit = float(jax.grad(jloss)(jmp).scattering[0])
    with jax.disable_jit():
        g_eager = float(jax.grad(jloss)(jmp).scattering[0])
    tmp = diff.MaterialParams(*(
        x.requires_grad_(True)
        for x in diff.MaterialParams.from_scene(tscene, groups, n)))
    torch.sum(_tsim(diff.apply_materials(tscene, groups, tmp,
                                         ("scattering",)),
                    tparams, key)).backward()
    print(f"[2] smallest (r^2 - d^2) / r^2 of a direct capture: {rel:.3g}; "
          f"d/d(scattering) JAX jitted {g_jit:.5g}, JAX unjitted "
          f"{g_eager:.5g}, port {float(tmp.scattering.grad[0]):.5g}",
          flush=True)


def ior_recovery():
    sr, ir_len, rays, bounces = 16000, 1024, 256, 6
    kw = dict(n_rays=rays, max_bounces=bounces, sample_rate=sr,
              fields=("ior",), loss="blur", soft=True, resample=False,
              steps=70, lr=0.1)
    true_j, jp = _setup_ior(0.5)
    start_j, _ = _setup_ior(1.8)
    groups, _ = jd.infer_material_groups(start_j)
    g = int(groups[16])
    true_t, tp = _port(true_j, jp)
    start_t, _ = _port(start_j, jp)
    for k in range(4):
        key = jax.random.PRNGKey(k)
        target = jd.simulate_ir(true_j, jp, key, n_rays=rays,
                                max_bounces=bounces, sample_rate=sr,
                                ir_length=ir_len, soft=True)
        r = jd.fit_materials(start_j, jp, target, key, **kw)
        draws = sim_uniforms(key, 1, rays, bounces)
        t_target = diff.simulate_ir(true_t, tp, n_rays=rays,
                                    max_bounces=bounces, sample_rate=sr,
                                    ir_length=ir_len, soft=True,
                                    uniforms=draws, device="cpu")
        t = diff.fit_materials(start_t, tp, t_target,
                               uniforms_fn=lambda i, j: draws,
                               device="cpu", **kw)
        print(f"[3] PRNGKey({k}) draws: ior JAX "
              f"{float(np.asarray(r.params.constrained()[3])[g]):.4f}, "
              f"port {float(t.params.constrained()[3][g]):.4f}", flush=True)
    for seed in range(8):
        t_target = diff.simulate_ir(true_t, tp, seed, n_rays=rays,
                                    max_bounces=bounces, sample_rate=sr,
                                    ir_length=ir_len, soft=True,
                                    device="cpu")
        t = diff.fit_materials(start_t, tp, t_target, seed, device="cpu",
                               **kw)
        print(f"[3] port Philox seed {seed}: ior "
              f"{float(t.params.constrained()[3][g]):.4f}", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    refract_nan()
    grazing()
    ior_recovery()
