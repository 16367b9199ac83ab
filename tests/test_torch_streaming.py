"""PyTorch port: the plain-mode stream.

* RingBuffer contract (add-then-zero, overlap-add, wraparound), as the
  JAX package's tests state it;
* the port's ``Streamer.stream_clip``, fed JAX's per-chunk draws through
  ``uniforms_fn``, equals JAX's ``Streamer.stream_clip`` on the CPU;
* a static scene whose every chunk has the same IR streams exactly the
  offline bake (a crossfade between equal IRs is the identity);
* a stereo stream equals the two per-ear mono streams;
* the binaural stream (one head, two ears, the head turning), fed JAX's
  per-chunk draws, equals JAX's binaural ``stream_clip``, also when it
  continues from a JAX ``StreamState`` carried across by ``convert``;
  with a degenerate head (radius 0, shadow 0) both ears equal the mono
  stream; a head turned away from the source pans to the far ear.

The stream tolerances are those of tests/test_streaming.py (rtol 2e-3,
atol 2e-5): chunked and whole-clip FFTs round differently, and the
binaural decode's float32 target bins may round one spacing over
(tests/test_torch_spatial.py). The degenerate head holds to the JAX
test's limit, 2e-6 of the mono stream's peak."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_chunk_uniforms, to_numpy, to_torch

import realisticaudioraytracing2d_tpu as jart
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch.ops import rng
from realisticaudioraytracing2d_tpu_torch.streaming import (RingBuffer,
                                                            dry_chunk,
                                                            init_stream,
                                                            stream_chunk)
from realisticaudioraytracing2d_tpu_torch.utils.audio_io import noise_burst

STREAM_TOL = dict(rtol=2e-3, atol=2e-5)


def test_ring_buffer_push_drain_roundtrip():
    rb = RingBuffer.zeros(16, 1, device="cpu")
    rb.push(torch.arange(1.0, 5.0)[None, :], 0)
    np.testing.assert_allclose(to_numpy(rb.drain(4))[0], [1, 2, 3, 4])
    np.testing.assert_allclose(to_numpy(rb.drain(4))[0], np.zeros(4))
    assert rb.read_head == 8


def test_ring_buffer_overlap_add():
    rb = RingBuffer.zeros(8, 1, device="cpu")
    rb.push(torch.ones(1, 4), 0).push(torch.ones(1, 4), 2)
    np.testing.assert_allclose(to_numpy(rb.drain(6))[0], [1, 1, 2, 2, 1, 1])


def test_ring_buffer_wraparound_matches_jax():
    rb = RingBuffer.zeros(8, 2, device="cpu")
    rb.push(torch.ones(2, 6), 5)                 # wraps 5,6,7,0,1,2
    jrb = jart.RingBuffer.zeros(8, 2).push(jnp.ones((2, 6)), jnp.asarray(5))
    np.testing.assert_array_equal(to_numpy(rb.data), np.asarray(jrb.data))
    rb.read_head = 6
    out = rb.drain(4)                            # reads 6,7,0,1 and zeroes
    np.testing.assert_allclose(to_numpy(out)[0], [1, 1, 1, 1])
    np.testing.assert_allclose(to_numpy(rb.data)[0], [0, 0, 1, 0, 0, 1, 0, 0])
    assert rb.read_head == 2
    with pytest.raises(ValueError):
        rb.push(torch.ones(2, 9), 0)


@pytest.fixture(scope="module")
def setup():
    room = jart.rooms.smoll_room()
    cfg = art.smoll_room_config(ray_count=512)
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, reverb_duration=0.2, chunk_duration=0.05))
    return room, cfg, convert.scene_from_arrays(room.scene, device="cpu")


def test_stream_clip_matches_jax_stream(setup):
    room, cfg, scene = setup
    dry = noise_burst(0.12, cfg.audio.sample_rate, seed=1)
    key = jax.random.PRNGKey(0)
    jp = jart.Engine(room.scene, cfg).params(room.source, room.listener)
    want = np.asarray(jart.Streamer(room.scene, cfg, key).stream_clip(
        jnp.asarray(dry), lambda i: jp))
    p = art.Engine(scene, cfg).params(room.source, room.listener)
    streamer = art.Streamer(scene, cfg, uniforms_fn=lambda i: (
        jax_chunk_uniforms(key, i, 1, cfg.sim.max_bounces,
                           cfg.sim.ray_count)))
    seen = []
    got = to_numpy(streamer.stream_clip(
        to_torch(dry), lambda i: p, on_chunk=lambda i, s: seen.append(i)))
    n, t = cfg.audio.chunk_samples, cfg.audio.ir_length
    n_steps = -(-len(dry) // n) + -(-t // n)
    assert got.shape == want.shape == (1, n_steps * n)
    assert seen == list(range(n_steps))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **STREAM_TOL)


def test_static_scene_stream_equals_bake(setup):
    room, cfg, scene = setup
    dry = to_torch(noise_burst(0.18, cfg.audio.sample_rate, seed=3))
    b, r = cfg.sim.max_bounces, cfg.sim.ray_count
    fixed = rng.philox_uniforms(5, 1, b, r, device="cpu")
    eng = art.Engine(scene, cfg)
    p = eng.params(room.source, room.listener)
    wet = art.Streamer(scene, cfg, uniforms_fn=lambda i: fixed).stream_clip(
        dry, lambda i: p)
    bake = eng.bake(dry, eng.trace_frames(p, uniforms=fixed),
                    normalize=False)
    got, want = to_numpy(wet)[0], to_numpy(bake)
    # the stream runs whole chunks past the bake's N + T samples: silence
    assert len(got) >= len(want) and np.abs(want).max() > 0
    np.testing.assert_allclose(got[:len(want)], want, **STREAM_TOL)
    np.testing.assert_allclose(got[len(want):], 0.0, atol=2e-5)


def test_stereo_equals_per_ear_mono_streams(setup):
    room, cfg, scene = setup
    dry = to_torch(noise_burst(0.1, cfg.audio.sample_rate, seed=4))
    ears = np.stack([room.listener - [0.1, 0], room.listener + [0.1, 0]])
    eng = art.Engine(scene, cfg)
    stereo = art.Streamer(scene, cfg, seed=7, n_listeners=2).stream_clip(
        dry, lambda i: eng.params(room.source, ears))
    for e in range(2):
        mono = art.Streamer(scene, cfg, seed=7).stream_clip(
            dry, lambda i: eng.params(room.source, ears[e]))
        np.testing.assert_allclose(to_numpy(stereo[e]), to_numpy(mono[0]),
                                   rtol=1e-5, atol=1e-7)


def test_loop_controls_and_moving_obstacle(setup):
    room, cfg, scene = setup
    n = cfg.audio.chunk_samples
    dry = to_torch(noise_burst(0.08, cfg.audio.sample_rate, seed=5))
    eng = art.Engine(scene, cfg)
    p = eng.params(room.source, room.listener)
    looped = art.Streamer(scene, cfg).stream_clip(dry, lambda i: p,
                                                  loop=True, total_chunks=5)
    assert looped.shape == (1, 5 * n)
    with pytest.raises(ValueError):
        art.Streamer(scene, cfg).stream_clip(dry, lambda i: p, loop=True)
    # stop at chunk 1: dry goes silent, the tail flushes, the stream ends
    stopped = art.Streamer(scene, cfg).stream_clip(
        dry, lambda i: p, control_fn=lambda i: {"stop": i == 1})
    tail = -(-cfg.audio.ir_length // n)
    assert stopped.shape == (1, (1 + tail) * n)
    # reset_ir zeroes the crossfade's previous IR
    s = art.Streamer(scene, cfg)
    s.stream_clip(dry, lambda i: p, total_chunks=2,
                  control_fn=lambda i: {"reset_ir": i == 1})
    s.reset_ir()
    assert float(s.state.prev_ir.abs().sum()) == 0.0
    # a moved obstacle keeps the padded wall count and changes the sound
    port_room = art.rooms.smoll_room(device="cpu")
    moved = port_room.builder.move_collider(port_room.scene, "Wall (4)",
                                            position=(-5.0, 2.0))
    a = art.Streamer(scene, cfg, seed=1).stream_clip(
        dry, lambda i: p, total_chunks=3)
    b = art.Streamer(scene, cfg, seed=1).stream_clip(
        dry, lambda i: p, scene_fn=lambda i: moved, total_chunks=3)
    assert a.shape == b.shape and not torch.equal(a, b)


def test_unported_stream_modes_raise(setup):
    room, cfg, scene = setup
    # diffraction, air, binaural and Doppler are ported; the refusals that
    # stay are JAX's own
    with pytest.raises(ValueError, match="one head listener"):
        art.Streamer(scene, cfg, binaural=True, n_listeners=2)
    s = art.Streamer(scene, cfg, diffraction=1, air_alpha=[0.1],
                     binaural=True)
    assert s.n_listeners == 2 and tuple(s.state.prev_ir.shape) == (
        2, cfg.audio.ir_length, 1)
    assert s.state.prev_facing is not None
    # the binaural chunk step checks its channel counts, as JAX's does
    p = art.TraceParams.make(room.source, room.listener, device="cpu")
    for n_l, pp in ((1, p), (2, art.TraceParams.make(
            room.source, [room.listener, room.listener], device="cpu"))):
        state = init_stream(cfg.audio.ir_length, cfg.audio.chunk_samples,
                            n_listeners=n_l, device="cpu")
        with pytest.raises(ValueError, match="binaural"):
            stream_chunk(scene, pp, state,
                         torch.zeros(cfg.audio.chunk_samples), seed=0,
                         n_rays=64, max_bounces=3,
                         sample_rate=cfg.audio.sample_rate,
                         binaural_facing=0.0)


def _bearing(room):
    src = np.asarray(room.source, np.float32)
    lis = np.asarray(room.listener, np.float32).reshape(-1)[:2]
    return float(np.arctan2(src[1] - lis[1], src[0] - lis[0]))


def test_binaural_stream_clip_matches_jax_stream(setup):
    room, cfg, scene = setup
    dry = noise_burst(0.12, cfg.audio.sample_rate, seed=6)
    # the key of the mono stream's test: at 512 rays a razor-edge hit
    # that XLA's fused multiply-adds bin one over (ROADMAP section 3)
    # moves a deposit by a bin in the chunks of some keys (key 2: chunks
    # 2 and 6), in the mono and the spatial trace alike
    key = jax.random.PRNGKey(0)
    turn = lambda i: _bearing(room) - 0.4 * i          # noqa: E731
    jp = jart.Engine(room.scene, cfg).params(room.source, room.listener)
    jstream = jart.Streamer(room.scene, cfg, key, binaural=True,
                            head_radius=0.2)
    want = np.asarray(jstream.stream_clip(jnp.asarray(dry), lambda i: jp,
                                          facing_fn=turn))
    p = art.Engine(scene, cfg).params(room.source, room.listener)
    draws = lambda i: jax_chunk_uniforms(            # noqa: E731
        key, i, 1, cfg.sim.max_bounces, cfg.sim.ray_count)
    streamer = art.Streamer(scene, cfg, uniforms_fn=draws, binaural=True,
                            head_radius=0.2)
    got = to_numpy(streamer.stream_clip(to_torch(dry), lambda i: p,
                                        facing_fn=turn))
    n, t = cfg.audio.chunk_samples, cfg.audio.ir_length
    n_steps = -(-len(dry) // n) + -(-t // n)
    assert got.shape == want.shape == (2, n_steps * n)
    assert np.abs(want).max() > 0 and not np.allclose(want[0], want[1])
    np.testing.assert_allclose(got, want, **STREAM_TOL)
    assert float(streamer.state.prev_facing) == pytest.approx(
        turn(n_steps - 1), abs=1e-6)
    # a JAX binaural state carried across continues the JAX stream
    state = convert.stream_state_from_arrays(jstream.state, device="cpu")
    np.testing.assert_array_equal(to_numpy(state.prev_facing),
                                  np.asarray(jstream.state.prev_facing))
    streamer.state = state
    piece = to_torch(dry[:n])
    got = to_numpy(streamer.process(piece, p, facing=turn(n_steps)))
    # JAX's chunk n_steps, the same draws
    streamer_j = jstream
    want = np.asarray(streamer_j.process(jnp.asarray(dry[:n]), jp,
                                         facing=turn(n_steps)))
    np.testing.assert_allclose(got, want, **STREAM_TOL)


def test_binaural_stream_degenerate_head_equals_mono(setup):
    # radius 0 and shadow 0: no ITD, unit gains, no decorrelation, so
    # each ear is W, which on the CPU is the mono IR bit for bit
    room, cfg, scene = setup
    dry = to_torch(noise_burst(0.15, cfg.audio.sample_rate, seed=2))
    p = art.Engine(scene, cfg).params(room.source, room.listener)
    mono = to_numpy(art.Streamer(scene, cfg, seed=3).stream_clip(
        dry, lambda i: p))[0]
    both = to_numpy(art.Streamer(scene, cfg, seed=3, binaural=True,
                                 head_radius=0.0, shadow=0.0).stream_clip(
        dry, lambda i: p, facing_fn=lambda i: 0.3 * i))
    assert both.shape[0] == 2
    scale = np.abs(mono).max()
    assert scale > 0
    np.testing.assert_allclose(both[0], mono, atol=2e-6 * scale)
    np.testing.assert_allclose(both[1], mono, atol=2e-6 * scale)


def test_binaural_stream_head_turn_pans(setup):
    # facing the source: near-symmetric ears; the source on the left
    # ear's side (head turned -90 deg from it): the left ear much louder
    room, cfg, scene = setup
    dry = to_torch(noise_burst(0.3, cfg.audio.sample_rate, seed=4))
    p = art.Engine(scene, cfg).params(room.source, room.listener)

    def run(facing):
        s = art.Streamer(scene, cfg, seed=1, binaural=True, shadow=0.9)
        return to_numpy(s.stream_clip(dry, lambda i: p,
                                      facing_fn=lambda i: facing))

    toward = run(_bearing(room))
    left_of = run(_bearing(room) - np.pi / 2)
    e = lambda x: float((x ** 2).sum())                  # noqa: E731
    ratio_toward = e(toward[0]) / e(toward[1])
    ratio_left = e(left_of[0]) / e(left_of[1])
    assert ratio_left > 1.5, ratio_left
    assert ratio_left > 1.5 * ratio_toward, (ratio_left, ratio_toward)


def test_dry_chunk_and_init_stream():
    dry = torch.arange(10.0)
    np.testing.assert_array_equal(to_numpy(dry_chunk(dry, 2, 4, False)),
                                  [8, 9, 0, 0])
    np.testing.assert_array_equal(to_numpy(dry_chunk(dry, 2, 4, True)),
                                  [8, 9, 0, 1])
    np.testing.assert_array_equal(to_numpy(dry_chunk(dry, 5, 4, False)),
                                  [0, 0, 0, 0])
    st = init_stream(100, 10, n_listeners=2, n_bands=3, device="cpu")
    assert tuple(st.prev_ir.shape) == (2, 100, 3)
    assert st.ring.size == 120 and st.chunk_index == 0
    assert st.prev_facing is None
    st = init_stream(100, 10, n_listeners=2, binaural=True, device="cpu")
    assert st.prev_facing is not None and float(st.prev_facing) == 0.0
