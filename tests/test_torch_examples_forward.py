"""PyTorch port: the forward example twins (``examples/torch/demo,
quad_mic, speaker_array, spatial_doa, occlusion_walkby, dataset_sweep``)
on the CPU, and the coverage of the JAX examples by the twins.

Each twin runs in a subprocess with ``--device cpu`` at the tiny
arguments of ``tests/test_examples.py`` and its claims (the JAX twin's
asserts and thresholds, unchanged) hold; its setup equals the JAX
example's construction exactly (scenes, poses, aims, dry signals). The
coverage test holds ``examples/torch/`` to the JAX examples, the pinned
substrings to ``tests/test_examples.py::CASES`` and every twin's imports
to torch, numpy and the port.
"""

import ast
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_examples import (ADDED_ARGS, ROOT, TWIN_DIR, TWINS,
                            assert_array_equal, assert_config_equal,
                            assert_params_equal, assert_scene_equal,
                            load_jax_cases, load_twin, run_twin)
from torch_parity import CPU

import realisticaudioraytracing2d_tpu as jart
from realisticaudioraytracing2d_tpu.models.materials import \
    AudioMaterial as JMaterial
from realisticaudioraytracing2d_tpu.models.rooms import \
    shoebox_room as jax_shoebox
from realisticaudioraytracing2d_tpu.models.scene import \
    SceneBuilder as JBuilder
from realisticaudioraytracing2d_tpu.ops import air as jax_air
from realisticaudioraytracing2d_tpu.ops import directivity as jax_dv
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams as JParams
from realisticaudioraytracing2d_tpu.utils import audio_io as jax_audio

FORWARD = ["demo.py", "quad_mic.py", "speaker_array.py", "spatial_doa.py",
           "occlusion_walkby.py", "dataset_sweep.py"]


@pytest.mark.parametrize("name", FORWARD)
def test_twin_runs_and_claims_hold(name, tmp_path):
    run_twin(name, tmp_path)


# -- setups against the JAX examples' constructions --------------------------

def test_demo_setup_matches_jax():
    su = load_twin("demo.py").setup(CPU)
    room = jart.rooms.smoll_room()
    cfg = jart.smoll_room_config(ray_count=4096)
    eng = jart.Engine(room.scene, cfg)
    assert_scene_equal(su["room"].scene, room.scene)
    assert_config_equal(su["cfg"], cfg)
    assert_params_equal(su["params"], eng.params(room.source, room.listener))
    for i in (0, 1, 7, 23):
        pos = room.listener + np.array(
            [2.0 * i * cfg.audio.chunk_duration, 0.0], np.float32)
        assert_params_equal(su["moving"](i), eng.params(room.source, pos))
    sr = cfg.audio.sample_rate
    assert_array_equal(su["dry"], jax_audio.click_clip(
        1.0, sr, click_times=(0.1, 0.5)))
    assert_array_equal(su["dry2"], jax_audio.noise_burst(0.8, sr, seed=2))
    assert_scene_equal(su["box"], jax_shoebox(
        4.0, 4.0, wall_material=JMaterial(absorption=0.3, scattering=0.4)))
    assert_params_equal(su["p_box"], JParams.make(
        source=(-1.0, 0.4), listeners=(1.0, 0.3), listener_radius=0.5))
    room_b = jart.rooms.smoll_room(n_bands=8)
    cfg_b = jart.smoll_room_config(ray_count=2048, n_bands=8)
    eng_b = jart.Engine(room_b.scene, cfg_b)
    assert_scene_equal(su["room_b"].scene, room_b.scene)
    assert_config_equal(su["cfg_b"], cfg_b)
    assert_params_equal(su["params_b"],
                        eng_b.params(room_b.source, room_b.listener))
    assert_params_equal(su["params_card"], eng_b.params(
        room_b.source, room_b.listener, directivity=jax_dv.cardioid(0.0)))


@pytest.mark.parametrize("g", [2, 3])
def test_quad_mic_setup_matches_jax(g):
    su = load_twin("quad_mic.py").setup(CPU, g)
    room = jart.rooms.smoll_room()
    cfg = jart.smoll_room_config(ray_count=4096)
    center = np.asarray(room.listener, np.float32)
    axis_off = (np.arange(g, dtype=np.float32) - (g - 1) / 2.0)
    offsets = np.stack(np.meshgrid(axis_off, axis_off),
                       axis=-1).reshape(-1, 2)
    mics = center[None, :] + offsets
    eng = jart.Engine(room.scene, cfg, n_listeners=g * g)
    assert_scene_equal(su["room"].scene, room.scene)
    assert_config_equal(su["cfg"], cfg)
    assert_array_equal(su["mics"], mics)
    assert su["eng"].n_listeners == g * g
    assert_params_equal(su["params"], eng.params(room.source, mics))
    assert_array_equal(su["dry"], jax_audio.click_clip(
        1.0, cfg.audio.sample_rate, click_times=(0.1, 0.5)))


@pytest.mark.parametrize("S", [4, 8])
def test_speaker_array_setup_matches_jax(S):
    su = load_twin("speaker_array.py").setup(CPU, S)
    m = JMaterial(absorption=0.35, scattering=0.4, transmission=0.0,
                  ior=1.0)
    b = JBuilder(n_bands=1)
    b.add_box(m, size=(16.0, 12.0))
    ys = np.linspace(-1.4, 1.4, S)
    sources = jnp.asarray(np.stack([np.full(S, -5.0), ys], axis=1),
                          jnp.float32)
    listeners = jnp.asarray([[5.0, 0.0], [-7.0, 0.0]], jnp.float32)
    aims = jnp.stack([jnp.asarray(jax_dv.cardioid(
        float(np.arctan2(0.0 - y, 5.0 - (-5.0))))) for y in ys]).astype(
            jnp.float32)
    p = jart.TraceParams.make(sources, listeners, 0.5, 343.0, 1.0)
    assert_scene_equal(su["scene"], b.build())
    assert_array_equal(su["sources"], sources)
    assert_params_equal(su["params"], p)
    assert_params_equal(su["params"]._replace(directivity=su["aims"]),
                        p._replace(directivity=aims))


def test_spatial_doa_setup_matches_jax():
    twin = load_twin("spatial_doa.py")
    scene, p = twin.setup(CPU)
    m = JMaterial(absorption=0.3, scattering=0.0, transmission=0.0, ior=1.0)
    b = JBuilder(n_bands=1)
    b.add_segment((-6.0, -4.0), (6.0, -4.0), (0.0, 1.0), m)
    b.add_segment((6.0, -4.0), (6.0, 4.0), (-1.0, 0.0), m)
    b.add_segment((6.0, 4.0), (-6.0, 4.0), (0.0, -1.0), m)
    b.add_segment((-6.0, 4.0), (-6.0, -4.0), (1.0, 0.0), m)
    src = np.float32([-2.5, 1.0])
    mic = np.float32([2.0, -1.5])
    assert_scene_equal(scene, b.build())
    assert_params_equal(p, JParams.make(src, mic, listener_radius=0.3))
    images = {
        "direct": src,
        "floor (y=-4)": np.float32([src[0], -8.0 - src[1]]),
        "right (x=+6)": np.float32([12.0 - src[0], src[1]]),
        "ceiling (y=+4)": np.float32([src[0], 8.0 - src[1]]),
        "left (x=-6)": np.float32([-12.0 - src[0], src[1]]),
    }
    expected = []
    for name, pos in images.items():
        d = pos - mic
        expected.append((name, np.hypot(*d) / 343.0,
                         np.arctan2(d[1], d[0])))
    expected.sort(key=lambda e: e[1])
    assert twin.expected_arrivals() == expected


def test_occlusion_walkby_setup_matches_jax():
    su = load_twin("occlusion_walkby.py").setup(CPU)
    opaque = JMaterial(absorption=0.8, scattering=0.6, transmission=0.0,
                       ior=1.0)
    b = JBuilder(n_bands=1)
    b.add_segment((0.0, -3.0), (0.0, 3.0), (1.0, 0.0), opaque)
    cfg = jart.smoll_room_config(ray_count=4000)
    cfg = dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, max_bounces=4),
        audio=dataclasses.replace(cfg.audio, sample_rate=16000,
                                  reverb_duration=0.25))
    assert_scene_equal(su["scene"], b.build())
    assert_config_equal(su["cfg"], cfg)
    source = np.asarray([-6.0, 0.0], np.float32)
    for i in range(24):
        y = -8.0 + 16.0 * i / (24 - 1)
        assert_params_equal(su["poses"](i), jart.TraceParams.make(
            source, np.asarray([4.0, y], np.float32), listener_radius=0.5))
    assert_array_equal(su["dry"], jax_audio.noise_burst(
        24 * cfg.audio.chunk_duration, 16000, seed=7))
    assert_array_equal(su["air_alpha"], jnp.asarray(jax_air.iso9613_alpha(
        jax_air.band_frequencies(1)), jnp.float32))


# -- coverage ----------------------------------------------------------------

def test_twins_are_the_jax_examples_by_name():
    have = {f for f in os.listdir(TWIN_DIR) if f.endswith(".py")}
    jax_examples = {f for f in os.listdir(os.path.join(ROOT, "examples"))
                    if f.endswith(".py")}
    assert have == jax_examples - {"sweep_mxu_microbench.py"}
    assert have == set(TWINS)


def test_twins_pin_the_jax_cases():
    cases = load_jax_cases()
    assert set(cases) == set(TWINS)
    for name, (args, claims) in cases.items():
        t_args, t_claims = TWINS[name]
        added = ADDED_ARGS.get(name, [])
        assert t_args[:len(t_args) - len(added)] == args, name
        assert t_args[len(t_args) - len(added):] == added, name
        assert set(claims) <= set(t_claims), name


def test_twins_import_no_jax():
    for name in sorted(TWINS):
        tree = ast.parse(open(os.path.join(TWIN_DIR, name)).read())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                mods.add(node.module or "")
        roots = {m.split(".")[0] for m in mods}
        assert not roots & {"jax", "jaxlib", "optax",
                            "realisticaudioraytracing2d_tpu"}, (name, roots)
        assert "torch" in roots and "main" in {
            n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


@pytest.mark.skipif(torch.cuda.is_available(), reason="runs where no CUDA "
                    "device is: --device cuda must raise, not fall back")
@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_on_cuda_without_a_card_raises(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises((AssertionError, RuntimeError)):
        load_twin(name).main(["--device", "cuda"])
