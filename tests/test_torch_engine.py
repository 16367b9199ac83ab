"""PyTorch port: engine routing, trace_accumulate + bake vs JAX, and the
rule that no module of the port imports JAX.

Tolerances: the trace is fed JAX's uniforms, so the IRs agree as in
test_torch_bounce_kernel.py (energy 1e-4, L1 1%); the bake of one and the
same IR agrees to the FFT tolerance of test_torch_convolve.py."""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_parity import jax_frame_uniforms, to_numpy, to_torch

import realisticaudioraytracing2d_tpu as jart
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import convert

PORT_DIR = Path(art.__file__).resolve().parent


@pytest.fixture(scope="module")
def small():
    cfg = art.smoll_room_config(ray_count=1024)
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, sample_rate=8000, reverb_duration=0.256))
    room = jart.rooms.smoll_room()
    return room, cfg


def test_trace_accumulate_and_bake_match_jax(small, rng):
    room, cfg = small
    key = jax.random.PRNGKey(2)
    jeng = jart.Engine(room.scene, cfg)
    jp = jeng.params(room.source, room.listener)
    jst = jart.trace_accumulate(room.scene, jp, jeng.fresh_ir(), key,
                                n_rays=1024, max_bounces=5, sample_rate=8000,
                                n_frames=2, backend="jnp")
    eng = art.Engine(convert.scene_from_arrays(room.scene, device="cpu"), cfg)
    p = eng.params(room.source, room.listener)
    st = eng.trace_frames(p, n_frames=2,
                          uniforms=jax_frame_uniforms(key, 2, 5, 1024))
    assert st.frames == 2 and tuple(st.sum.shape) == (1, 2048, 1)
    got, want = to_numpy(st.sum), np.asarray(jst.sum)
    assert abs(got.sum() - want.sum()) / want.sum() < 1e-4
    assert np.abs(got - want).sum() / np.abs(want).sum() < 1e-2

    dry = rng.uniform(-1, 1, 900).astype(np.float32)
    jst_port = convert.ir_state_from_arrays(jst, device="cpu")
    for normalize in (True, False):
        wet = to_numpy(art.bake_audio(to_torch(dry), jst_port,
                                      normalize=normalize))
        jwet = np.asarray(jart.bake_audio(jax.numpy.asarray(dry), jst,
                                          normalize=normalize))
        np.testing.assert_allclose(wet, jwet, rtol=1e-5,
                                   atol=1e-5 * np.abs(jwet).max())
    assert eng.bake(to_torch(dry), st).shape == (900 + 2048,)


def test_seeded_routing_plain_equals_auto_on_cpu(small):
    room, cfg = small
    eng = art.Engine(convert.scene_from_arrays(room.scene, device="cpu"), cfg)
    p = eng.params(room.source, room.listener)
    auto = eng.trace_frames(p, seed=9, n_frames=2)
    plain = eng.trace_frames(p, seed=9, n_frames=2, backend="plain")
    assert torch.equal(auto.sum, plain.sum) and float(auto.sum.sum()) > 0
    other = eng.trace_frames(p, seed=10, n_frames=2)
    assert not torch.equal(auto.sum, other.sum)
    # accumulation adds onto an existing state
    twice = eng.trace_frames(p, seed=9, n_frames=2, state=auto)
    assert twice.frames == 4
    torch.testing.assert_close(twice.sum, 2 * auto.sum)
    with pytest.raises(ValueError, match="backend"):
        eng.trace_frames(p, backend="jnp")
    with pytest.raises(ValueError, match="uniforms"):
        eng.trace_frames(p, n_frames=2, uniforms=(torch.rand(1, 1024),
                                                  torch.rand(1, 5, 1024, 3)))


def test_engine_state_lives_on_the_scene_device(small):
    _, cfg = small
    room = art.rooms.smoll_room(device="cpu")
    eng = art.Engine(room.scene, cfg, n_listeners=2)
    st = eng.fresh_ir()
    assert tuple(st.sum.shape) == (2, 2048, 1) and st.frames == 0
    p = eng.params(room.source, np.stack([room.listener] * 2))
    assert p.listeners.shape == (2, 2) and p.source.device == st.sum.device


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted(PORT_DIR.rglob("*.py"))
    assert len(files) >= 15
    # the modules of the spatial and binaural slice are among them
    assert {"spatial.py", "analysis.py", "streaming.py", "cli.py"} <= {
        f.name for f in files}
    smoke = PORT_DIR.parent / "chip_smoke.py"
    for path in files + ([smoke] if smoke.exists() else []):
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "optax",
                                "realisticaudioraytracing2d_tpu"), \
                f"{path.name} imports {mod}"
    assert (PORT_DIR / "csrc" / "bounce_kernel.cu").exists()
