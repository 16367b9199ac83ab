"""PyTorch port: the inverse example twins (``examples/torch/
inverse_materials, locate_source, track_source,
obstacle_pose_negative``) on the CPU.

They reach no hand kernel: they differentiate the plain trace under
autograd, as ``cli fit`` / ``cli locate`` do. Each twin runs in a
subprocess with ``--device cpu`` at the tiny arguments of
``tests/test_examples.py`` (``obstacle_pose_negative.py``, which takes
none in JAX, at ``--steps 4 --grid 2``) and its claims (localization
error <= 0.15 m, tracking mean error <= 0.2 m) hold; its setup equals the
JAX example's construction exactly (rooms, materials, poses, the
trajectory, the blur schedule and the starts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_examples import (assert_array_equal, assert_params_equal,
                            assert_scene_equal, load_twin, run_twin)
from torch_parity import CPU

from realisticaudioraytracing2d_tpu import diff as jax_diff
from realisticaudioraytracing2d_tpu.models.materials import \
    AudioMaterial as JMaterial
from realisticaudioraytracing2d_tpu.models.rooms import \
    shoebox_room as jax_shoebox
from realisticaudioraytracing2d_tpu.models.scene import \
    SceneBuilder as JBuilder
from realisticaudioraytracing2d_tpu.models.scene import \
    Transform2D as JTransform
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams as JParams
from realisticaudioraytracing2d_tpu_torch import diff

INVERSE = ["inverse_materials.py", "locate_source.py", "track_source.py",
           "obstacle_pose_negative.py"]


@pytest.mark.parametrize("name", INVERSE)
def test_twin_runs_and_claims_hold(name, tmp_path):
    run_twin(name, tmp_path)


def _jax_two_group_room(sides_abs, topbot_abs):
    sides = JMaterial(absorption=sides_abs, scattering=0.5)
    topbot = JMaterial(absorption=topbot_abs, scattering=1.0)
    w, h, t = 6.0, 5.0, 1.0
    b = JBuilder()
    b.add_box(topbot, JTransform((0, h / 2 + t / 2), 0, (w + 2 * t, t)))
    b.add_box(topbot, JTransform((0, -h / 2 - t / 2), 0, (w + 2 * t, t)))
    b.add_box(sides, JTransform((-w / 2 - t / 2, 0), 0, (t, h)))
    b.add_box(sides, JTransform((w / 2 + t / 2, 0), 0, (t, h)))
    return b.build()


def test_inverse_materials_setup_matches_jax():
    su = load_twin("inverse_materials.py").setup(CPU)
    assert_scene_equal(su["true_scene"], _jax_two_group_room(0.507, 0.148))
    start = _jax_two_group_room(0.10, 0.60)
    assert_scene_equal(su["start_scene"], start)
    assert_params_equal(su["params"], JParams.make(
        source=(-1.8, 0.6), listeners=[(1.6, 1.2), (0.0, -1.6), (2.2, -0.4)],
        listener_radius=0.5))
    groups, n = diff.infer_material_groups(su["start_scene"])
    want, want_n = jax_diff.infer_material_groups(start)
    np.testing.assert_array_equal(groups, np.asarray(want))
    assert n == want_n and groups[0] != groups[8]


def _jax_shoebox():
    return jax_shoebox(4.0, 4.0, wall_material=JMaterial(absorption=0.3,
                                                         scattering=0.4))


def test_locate_source_setup_matches_jax():
    twin = load_twin("locate_source.py")
    scene, params = twin.setup(CPU)
    true_source = jnp.array([-1.0, 0.4])
    assert_scene_equal(scene, _jax_shoebox())
    assert_params_equal(params, JParams.make(
        source=true_source, listeners=(1.0, 0.3), listener_radius=0.5))
    assert_array_equal(twin.TRUE_SOURCE, true_source)


@pytest.mark.parametrize("chunks", [8, 12])
def test_track_source_setup_matches_jax(chunks):
    twin = load_twin("track_source.py")
    scene, params = twin.setup(CPU)
    assert_scene_equal(scene, _jax_shoebox())
    assert_params_equal(params, JParams.make(
        source=(0.0, 0.0), listeners=(1.2, 0.8), listener_radius=0.5))
    t = np.linspace(0.0, 1.0, chunks)
    path = np.stack([-1.3 + 2.2 * t, 1.1 * np.sin(np.pi * t) - 0.8], axis=1)
    assert_array_equal(twin.trajectory(chunks), path)


def test_obstacle_pose_setup_matches_jax():
    twin = load_twin("obstacle_pose_negative.py")

    def setup(center):
        wall = JMaterial(absorption=0.3, scattering=0.3)
        obst = JMaterial(absorption=0.6, scattering=0.1)
        return jax_shoebox(4.0, 4.0, wall_material=wall, obstacles=[
            (JTransform(center, 0.0, (0.8, 0.4)), obst)])

    for center in ((0.2, 0.3), (0.0, 0.0)):
        assert_scene_equal(twin.setup(center, CPU), setup(center))
    assert_params_equal(twin.trace_params(CPU), JParams.make(
        source=(-1.4, 0.2), listeners=[(1.4, -0.3), (1.2, 1.2), (-0.3, -1.4)],
        listener_radius=0.4))
    assert_array_equal(twin.sigmas(200), jnp.asarray(
        32.0 * 0.5 ** (np.arange(200) / 30) + 1.0, jnp.float32))
    # the 16 starts: jnp.linspace interpolates start * (1 - t) + stop * t
    # in float32 (as XLA compiles it), numpy's float32 linspace rounds the
    # float64 grid once: they part by up to 3 ulps at 0.3 (9e-8)
    gx, gy = jnp.meshgrid(jnp.linspace(-0.9, 0.9, 4),
                          jnp.linspace(-0.9, 0.9, 4))
    starts = twin.grid_starts(4)
    assert starts.dtype == np.float32
    np.testing.assert_allclose(starts, jnp.stack([gx.ravel(), gy.ravel()],
                                                 -1), rtol=0, atol=1e-7)
    groups, _ = diff.infer_material_groups(twin.setup((0.0, 0.0), CPU))
    want, _ = jax_diff.infer_material_groups(setup((0.0, 0.0)))
    np.testing.assert_array_equal(groups, np.asarray(want))
