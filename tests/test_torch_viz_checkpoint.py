"""PyTorch port: ``rasterize_ir``, the viz images and the IR checkpoints
against the JAX package.

The rasters are functions of float->int truncations (``x / W * T``) and a
row flip, so the images are compared EXACTLY with JAX's arrays on the same
IR. Checkpoints written by either package must load in the other (same
npz leaves and sidecar), and the port's loader must refuse what JAX's
refuses."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_numpy, to_torch

from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.ops import ir as jax_ir
from realisticaudioraytracing2d_tpu.ops import trace as jax_trace
from realisticaudioraytracing2d_tpu.utils import checkpoint as jax_ckpt
from realisticaudioraytracing2d_tpu.utils import viz as jax_viz
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch.ops import ir as irm
from realisticaudioraytracing2d_tpu_torch.utils import checkpoint as ckpt
from realisticaudioraytracing2d_tpu_torch.utils import viz
from realisticaudioraytracing2d_tpu_torch.utils.png import write_png


def _ir(t, k, seed=0):
    """A decaying random IR [T, K] with a silent lead-in."""
    gen = np.random.default_rng(seed)
    ir = gen.random((t, k)).astype(np.float32) ** 8 * 4e-3
    ir *= np.exp(-np.arange(t) / (t / 4.0))[:, None].astype(np.float32)
    ir[: t // 16] = 0.0
    return ir


@pytest.mark.parametrize("t,k,frames,width,height,gain", [
    (2048, 1, 3, 1024, 256, 1000.0),     # the CLI's texture
    (12000, 4, 1, 1000, 200, 250.0),     # banded, T not a multiple of W
    (700, 1, 0, 1024, 64, 1000.0),       # fewer bins than columns, 0 frames
])
def test_rasterize_ir_equals_jax(t, k, frames, width, height, gain):
    ir = _ir(t, k)
    arg = ir if k > 1 else ir[:, 0]
    want = np.asarray(jax_ir.rasterize_ir(jnp.asarray(arg),
                                          jnp.asarray(frames, jnp.int32),
                                          gain, width, height))
    got = irm.rasterize_ir(to_torch(arg), frames, gain, width, height)
    assert got.dtype == torch.float32 and want.sum() > 0
    np.testing.assert_array_equal(to_numpy(got), want)


def test_waveform_and_spectrogram_images_equal_jax():
    ir = _ir(4096, 6, seed=2)
    want = jax_viz.ir_waveform_image(jnp.asarray(ir), jnp.asarray(2), 500.0)
    got = viz.ir_waveform_image(to_torch(ir), 2, 500.0)
    assert got.shape == (256, 1024, 3) and got.sum() > 0
    np.testing.assert_array_equal(got, want)
    for gain in (None, 300.0):
        want = jax_viz.ir_spectrogram_image(ir, 2, gain=gain)
        got = viz.ir_spectrogram_image(to_torch(ir), 2, gain=gain)
        assert got.shape == (256, 1024, 3) and got.max() > 0
        np.testing.assert_array_equal(got, want)


def test_render_scene_and_trajectory_equal_jax(tmp_path):
    room = jax_rooms.smoll_room()
    p = jax_trace.TraceParams.make(room.source, room.listener, 0.5, 343.0,
                                   1.0)
    _, dbg = jax_trace.trace(room.scene, p, jax.random.PRNGKey(1),
                             n_rays=256, max_bounces=4, n_debug=12)
    scene = convert.scene_from_arrays(room.scene, device="cpu")
    paths = convert.debug_paths_from_arrays(dbg, device="cpu")
    assert tuple(paths.pos.shape) == (5, 12, 2) and paths.alive.dtype == \
        torch.bool
    want = jax_viz.render_scene(room.scene, room.source, room.listener, 0.5,
                                dbg, draw_normals=True)
    got = viz.render_scene(scene, to_torch(room.source), room.listener, 0.5,
                           paths, draw_normals=True)
    assert got.shape == (600, 800, 3) and (got.sum(-1) > 0).mean() > 0.01
    np.testing.assert_array_equal(got, want)
    true_path = np.array([[-18.0, 9.0], [-10.0, 4.0], [-2.0, 1.0]])
    est_path = true_path + [[0.3, -0.2]]
    np.testing.assert_array_equal(
        viz.render_trajectory(scene, true_path, to_torch(est_path),
                              room.listener),
        jax_viz.render_trajectory(room.scene, true_path, est_path,
                                  room.listener))
    out = tmp_path / "scene.png"
    viz.save_image(str(out), got)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError, match="channel count"):
        write_png(str(out), np.zeros((4, 4, 2), np.uint8))


def test_checkpoints_round_trip_between_the_packages(tmp_path):
    gen = np.random.default_rng(5)
    total = gen.random((2, 64, 3)).astype(np.float32)
    # the port writes, JAX loads
    ours = str(tmp_path / "ir_ours")
    ckpt.save_ir_state(ours, irm.IRState(sum=to_torch(total), frames=7),
                       meta={"seed": 3})
    loaded_j = jax_ckpt.load_ir_state(ours)
    np.testing.assert_array_equal(np.asarray(loaded_j.sum), total)
    assert int(loaded_j.frames) == 7
    # JAX writes, the port loads
    theirs = str(tmp_path / "ir_theirs.npz")
    jax_ckpt.save_ir_state(theirs, jax_ir.IRState(
        sum=jnp.asarray(total), frames=jnp.asarray(9, jnp.int32)),
        meta={"seed": 4})
    loaded = ckpt.load_ir_state(theirs, device="cpu")
    assert loaded.frames == 9 and loaded.sum.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(loaded.sum), total)
    # the sidecars agree field by field (but for the meta each was given)
    side_ours, side_theirs = ckpt.read_sidecar(ours), \
        jax_ckpt.read_sidecar(theirs)
    assert side_ours.pop("meta") == {"seed": 3}
    assert side_theirs.pop("meta") == {"seed": 4}
    assert side_ours == side_theirs
    assert side_ours["treedef"] == ckpt.IRSTATE_TREEDEF
    assert ckpt.latest_checkpoint(str(tmp_path)) == theirs
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_load_ir_state_error_branches(tmp_path):
    state = irm.IRState(sum=torch.ones(1, 8, 1), frames=2)
    path = str(tmp_path / "ir.npz")
    ckpt.save_ir_state(path, state)
    side = ckpt.read_sidecar(path)

    def rewrite(**changes):
        with open(path + ".json", "w") as f:
            json.dump({**side, **changes}, f)

    rewrite(kind="SweepResult")
    with pytest.raises(ValueError, match="not an IRState"):
        ckpt.load_ir_state(path, device="cpu")
    rewrite(shapes=[[8, 1], []])
    with pytest.raises(ValueError, match="does not look like"):
        ckpt.load_ir_state(path, device="cpu")
    rewrite(shapes=[[1, 9, 1], []])
    with pytest.raises(ValueError, match="has shape"):
        ckpt.load_ir_state(path, device="cpu")
    # a format-1 sidecar ({treedef, n_leaves, meta}) still resumes
    with open(path + ".json", "w") as f:
        json.dump({"treedef": side["treedef"], "n_leaves": 2, "meta": {}}, f)
    old = ckpt.load_ir_state(path, device="cpu")
    assert old.frames == 2 and torch.equal(old.sum, state.sum)
    with open(path + ".json", "w") as f:
        json.dump({"treedef": "x", "n_leaves": 3, "meta": {}}, f)
    with pytest.raises(ValueError, match="format-1"):
        ckpt.load_ir_state(path, device="cpu")
    np.savez(path, leaf_0=np.ones((8, 1), np.float32),
             leaf_1=np.asarray(2, np.int32))
    with open(path + ".json", "w") as f:
        json.dump({"treedef": "x", "n_leaves": 2, "meta": {}}, f)
    with pytest.raises(ValueError, match="format-1 leaves"):
        ckpt.load_ir_state(path, device="cpu")
    bare = str(tmp_path / "bare.npz")
    np.savez(bare, leaf_0=np.ones((1, 8, 1), np.float32))
    with pytest.raises(ValueError, match="no sidecar"):
        ckpt.load_ir_state(bare, device="cpu")
