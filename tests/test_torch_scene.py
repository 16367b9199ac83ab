"""PyTorch port: scenes, rooms and the JAX->torch converters.

The builders flatten colliders in numpy exactly as the JAX package does,
so every array must equal the JAX one bit for bit (no tolerance)."""

import numpy as np
import pytest
import torch
from torch_parity import to_numpy

from realisticaudioraytracing2d_tpu import streaming as jax_streaming
from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.ops import ir as jax_ir
from realisticaudioraytracing2d_tpu.ops.trace import \
    TraceParams as JaxTraceParams
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.models.materials import \
    MATERIAL_INTERIOR
from realisticaudioraytracing2d_tpu_torch.models.scene import (Scene,
                                                               Transform2D)
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.streaming import init_stream


def assert_scene_equal(port: Scene, ref) -> None:
    for f in Scene._fields:
        got, want = to_numpy(getattr(port, f)), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("name", ["smoll_room", "big_room", "sample_scene"])
@pytest.mark.parametrize("n_bands", [1, 4])
def test_reference_rooms_bit_equal(name, n_bands):
    port = getattr(rooms, name)(n_bands=n_bands, device="cpu")
    ref = getattr(jax_rooms, name)(n_bands=n_bands)
    assert_scene_equal(port.scene, ref.scene)
    np.testing.assert_array_equal(port.source, ref.source)
    np.testing.assert_array_equal(port.listener, ref.listener)
    assert port.listener_radius == ref.listener_radius


def test_shoebox_room_bit_equal():
    obstacles = [(Transform2D((1.0, 2.0), 0.3, (3.0, 1.0)), MATERIAL_INTERIOR)]
    port = rooms.shoebox_room(20.0, 12.0, obstacles=obstacles, pad_to=32,
                              device="cpu")
    ref = jax_rooms.shoebox_room(20.0, 12.0, obstacles=obstacles, pad_to=32)
    assert_scene_equal(port, ref)


def test_pad_to_matches_jax_and_padding_is_inert():
    port = rooms.smoll_room(n_bands=3, device="cpu").scene.pad_to(40)
    ref = jax_rooms.smoll_room(n_bands=3).scene.pad_to(40)
    assert_scene_equal(port, ref)
    pad = ~port.mask
    assert bool(torch.all(port.absorption[pad] == 1.0))
    assert bool(torch.all(port.ior[pad] == 1.0))
    assert bool(torch.all(port.a[pad] == port.b[pad]))
    with pytest.raises(ValueError):
        port.pad_to(8)


def test_concat_matches_jax():
    box = rooms.shoebox_room(6.0, 4.0, device="cpu")
    port = rooms.smoll_room(device="cpu").scene.concat(box, pad_to=64)
    ref = jax_rooms.smoll_room().scene.concat(jax_rooms.shoebox_room(6.0, 4.0),
                                              pad_to=64)
    assert_scene_equal(port, ref)
    assert port.n_walls == 64 and int(port.n_valid) == 20 + 16
    with pytest.raises(ValueError):
        port.concat(rooms.smoll_room(n_bands=2, device="cpu").scene)


def test_move_collider_matches_jax_and_keeps_wall_count():
    port, ref = rooms.smoll_room(device="cpu"), jax_rooms.smoll_room()
    moved = port.builder.move_collider(port.scene, "Wall (4)",
                                       position=(-9.0, 6.0), angle=0.7)
    want = ref.builder.move_collider(ref.scene, "Wall (4)",
                                     position=(-9.0, 6.0), angle=0.7)
    assert_scene_equal(moved, want)
    assert moved.n_walls == port.scene.n_walls
    # the source scene is untouched
    assert_scene_equal(port.scene, ref.scene)
    with pytest.raises(KeyError):
        port.builder.move_collider(port.scene, "no such wall")


def test_convert_round_trip():
    ref = jax_rooms.big_room(n_bands=2)
    assert_scene_equal(convert.scene_from_arrays(ref.scene, device="cpu"),
                       ref.scene)
    assert_scene_equal(convert.scene_from_arrays(ref.scene, device="cpu"),
                       rooms.big_room(n_bands=2, device="cpu").scene)

    jp = JaxTraceParams.make(ref.source, np.stack([ref.listener] * 2), 0.5,
                             343.0, 100.0)
    p = convert.params_from_arrays(jp, device="cpu")
    for f in ("source", "listeners", "listener_radius", "speed_of_sound",
              "input_gain"):
        np.testing.assert_array_equal(to_numpy(getattr(p, f)),
                                      np.asarray(getattr(jp, f)))
    assert p.directivity is None and p.mic_directivity is None

    st = jax_ir.IRState.zeros(16, 2, 3)
    st = st._replace(sum=st.sum + 0.25, frames=st.frames + 3)
    ps = convert.ir_state_from_arrays(st, device="cpu")
    np.testing.assert_array_equal(to_numpy(ps.sum), np.asarray(st.sum))
    assert ps.frames == 3

    ss = jax_streaming.init_stream(32, 8, n_listeners=2)
    pss = convert.stream_state_from_arrays(ss, device="cpu")
    assert tuple(pss.prev_ir.shape) == (2, 32, 1)
    assert pss.ring.size == 32 + 2 * 8 and pss.ring.read_head == 0
    assert pss.chunk_index == 0


def test_scene_to_device_keeps_values():
    s = rooms.smoll_room(device="cpu").scene
    moved = s.to("cpu")
    assert moved.device.type == "cpu"
    assert_scene_equal(moved, jax_rooms.smoll_room().scene)


def test_builder_shapes_match_jax():
    from realisticaudioraytracing2d_tpu.models.scene import \
        SceneBuilder as JaxSceneBuilder
    from realisticaudioraytracing2d_tpu_torch.models.materials import \
        MATERIAL_BORDER
    from realisticaudioraytracing2d_tpu_torch.models.scene import \
        SceneBuilder
    tf = Transform2D((1.0, -2.0), 0.4, (2.0, -1.5))     # mirrored winding
    tri = np.array([[0.0, 0.0], [3.0, 0.0], [0.0, 2.0]])
    builders = []
    for cls in (SceneBuilder, JaxSceneBuilder):
        b = cls(n_bands=2)
        b.add_circle(MATERIAL_BORDER, tf, radius=1.5, resolution=12,
                     name="pillar")
        b.add_polygon([tri, tri[::-1] + 5.0], MATERIAL_INTERIOR, tf)
        b.add_loop(tri * 2.0, MATERIAL_BORDER)
        b.add_segment((0.0, 0.0), (1.0, 1.0), (0.0, 1.0), MATERIAL_INTERIOR)
        builders.append(b)
    assert len(builders[0]) == len(builders[1]) == 12 + 6 + 3 + 1
    assert_scene_equal(builders[0].build(pad_to=24, device="cpu"),
                       builders[1].build(pad_to=24))
    port = builders[0]
    assert [c.kind for c in port.colliders] == ["circle", "polygon", "loop",
                                                "segment"]
    assert port.find_collider("pillar").count == 12
    with pytest.raises(ValueError):
        port.move_collider(port.build(device="cpu"), 3, position=(0.0, 0.0))
    with pytest.raises(ValueError):
        SceneBuilder().build(device="cpu")


def test_wav_round_trip_reads_like_jax(tmp_path):
    from realisticaudioraytracing2d_tpu.utils import audio_io as jax_audio
    from realisticaudioraytracing2d_tpu_torch.utils import audio_io
    x = np.stack([audio_io.click_clip(0.01, 8000, (0.001, 0.005)),
                  audio_io.noise_burst(0.01, 8000, seed=2)], axis=-1)
    path = str(tmp_path / "clip.wav")
    audio_io.write_wav(path, x, 8000)
    got, rate = audio_io.read_wav(path)
    want, jrate = jax_audio.read_wav(path)
    assert rate == jrate == 8000 and got.shape == (80, 2)
    np.testing.assert_array_equal(got, want)
    # PCM16 writes x * 32767 truncated and reads / 32768: two quanta at most
    np.testing.assert_allclose(got, np.clip(x, -1, 1), atol=2 / 32767)


_DEFAULT_DEVICE_BUILDERS = {
    "smoll_room": lambda: rooms.smoll_room(),
    "random_rooms": lambda: rooms.random_rooms(1),
    "SceneBuilder.build":
        lambda: rooms.smoll_room(device="cpu").builder.build(),
    "TraceParams.make": lambda: art.TraceParams.make((0.0, 0.0), (1.0, 1.0)),
    "IRState.zeros": lambda: art.IRState.zeros(16),
    "RingBuffer.zeros": lambda: art.RingBuffer.zeros(16),
    "init_stream": lambda: init_stream(16, 8),
    "philox_uniforms": lambda: rng.philox_uniforms(0, 1, 1, 4),
    "scene_from_arrays": lambda: convert.scene_from_arrays(
        jax_rooms.smoll_room().scene),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_BUILDERS))
def test_builders_default_to_the_card(name):
    """A builder called without a device builds on the card: on a
    CPU-only torch it raises, and never returns a CPU tensor."""
    if torch.cuda.is_available():
        pytest.skip("checks a CPU-only torch; this one has a card")
    assert art.DEFAULT_DEVICE == "cuda"
    with pytest.raises((AssertionError, RuntimeError),
                       match="(?i)cuda|nvidia"):
        _DEFAULT_DEVICE_BUILDERS[name]()
