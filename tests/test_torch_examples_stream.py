"""PyTorch port: the streaming example twins (``examples/torch/
doppler_walkby, binaural_walkby, live_steering``) on the CPU.

Each twin runs in a subprocess with ``--device cpu`` at the tiny
arguments of ``tests/test_examples.py`` and its claims (the JAX twin's
asserts and thresholds, unchanged: Doppler lines within 2.2 / 2.5 Hz,
the ILD and ITD windows, fed == explicit byte for byte) hold; its setup
equals the JAX example's construction exactly (scenes, configs, the
pose trajectory, the dry signal, the steering feed and its explicit
trajectory).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
from torch_examples import (assert_array_equal, assert_config_equal,
                            assert_params_equal, assert_scene_equal,
                            load_twin, run_twin)
from torch_parity import CPU

import realisticaudioraytracing2d_tpu as jart
from realisticaudioraytracing2d_tpu.models.materials import \
    AudioMaterial as JMaterial
from realisticaudioraytracing2d_tpu.models.scene import \
    SceneBuilder as JBuilder
from realisticaudioraytracing2d_tpu.models.scene import \
    Transform2D as JTransform
from realisticaudioraytracing2d_tpu.posefeed import PoseFeed as JPoseFeed
from realisticaudioraytracing2d_tpu.utils import audio_io as jax_audio
from realisticaudioraytracing2d_tpu_torch.posefeed import PoseFeed

STREAM = ["doppler_walkby.py", "binaural_walkby.py", "live_steering.py"]


@pytest.mark.parametrize("name", STREAM)
def test_twin_runs_and_claims_hold(name, tmp_path):
    run_twin(name, tmp_path)


def _walkby_jax(rays, chunks, name=None):
    """The construction both JAX walk-by examples share: the mirror
    behind the source, the config, the poses and the dry sine."""
    mirror = JMaterial(absorption=0.0, scattering=0.0, transmission=0.0,
                       ior=1.0)
    b = JBuilder()
    b.add_box(mirror, JTransform(position=(6.5, 0.0)), size=(1.0, 2.0),
              name=name)
    scene = b.build()
    cfg = jart.smoll_room_config(ray_count=rays)
    cfg = dataclasses.replace(
        cfg,
        sim=dataclasses.replace(cfg.sim, listener_radius=0.05),
        audio=dataclasses.replace(cfg.audio, sample_rate=8000,
                                  reverb_duration=0.15, chunk_duration=0.1))
    eng = jart.Engine(scene, cfg)
    n = cfg.audio.chunk_samples
    listener = np.asarray([0.0, 0.0], np.float32)

    def poses(i):
        x = 3.0 - 2.0 * (i * n / 8000)
        return eng.params(np.asarray([x, 0.0], np.float32), listener)

    t_all = np.arange((chunks + 4) * n) / 8000
    dry = jnp.asarray(np.sin(2 * np.pi * 1000.0 * t_all).astype(np.float32))
    return scene, cfg, poses, dry


@pytest.mark.parametrize("name,mirror", [("doppler_walkby.py", None),
                                         ("binaural_walkby.py", "mirror")])
@pytest.mark.parametrize("rays,chunks", [(1024, 8), (2048, 10)])
def test_walkby_setup_matches_jax(name, mirror, rays, chunks):
    su = load_twin(name).setup(CPU, rays, chunks)
    scene, cfg, poses, dry = _walkby_jax(rays, chunks, mirror)
    assert_scene_equal(su["scene"], scene)
    assert_config_equal(su["cfg"], cfg)
    for i in range(chunks + 1):
        assert_params_equal(su["poses"](i), poses(i))
    assert_array_equal(su["dry"], dry)


def test_live_steering_setup_and_feed_match_jax(tmp_path):
    twin = load_twin("live_steering.py")
    su = twin.setup(CPU, 512, 8000)
    room = jart.rooms.smoll_room()
    cfg = jart.smoll_room_config(ray_count=512)
    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, sample_rate=8000,
                                       reverb_duration=0.2))
    eng = jart.Engine(room.scene, cfg)
    src = np.asarray(room.source, np.float32)
    base = eng.params(src, room.listener)
    lines = [
        {"chunk": 1, "source": [float(src[0] + 1.5), float(src[1])]},
        {"chunk": 2, "obstacle": "Wall (4)",
         "position": [-9.0, 5.0], "angle": 0.4},
        {"chunk": 4, "command": "reset_ir"},
        {"chunk": 6, "command": "stop"},
    ]
    moved_scene = room.builder.move_collider(room.scene, "Wall (4)",
                                             position=(-9.0, 5.0),
                                             angle=0.4)
    moved_params = base._replace(source=src + np.float32([1.5, 0.0]))

    def ctrl(i):
        if i == 4:
            return {"reset_ir": True}
        if i == 6:
            return {"stop": True}
        return {}

    assert_scene_equal(su["room"].scene, room.scene)
    assert_config_equal(su["cfg"], cfg)
    assert_params_equal(su["base"], base)
    assert su["lines"] == lines
    assert_array_equal(su["dry"], jax_audio.noise_burst(1.0, 8000, seed=1))
    # the explicit trajectory, and the feed through both packages' PoseFeed
    path = str(tmp_path / "steering.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(line) + "\n" for line in lines)
    feed = PoseFeed.open(path).bind_scene(su["room"].builder)
    jfeed = JPoseFeed.open(path).bind_scene(room.builder)
    try:
        for i in range(8):
            want_p = moved_params if i >= 1 else base
            want_s = moved_scene if i >= 2 else room.scene
            assert_params_equal(su["params_fn"](i), want_p)
            assert_scene_equal(su["scene_fn"](i), want_s)
            assert twin.explicit_control(i) == ctrl(i)
            assert_params_equal(feed.params(su["base"], i),
                                jfeed.params(base, i))
            assert_scene_equal(feed.scene(su["room"].scene, i),
                               jfeed.scene(room.scene, i))
            assert feed.control(i) == jfeed.control(i)
            assert_params_equal(feed.params(su["base"], i), want_p)
    finally:
        feed.close()
        jfeed.close()
