"""PyTorch port: the live pipeline (``live.py``), a sim-clock producer
thread and an audio-clock consumer thread around the native ring, the
``AudioManager`` contract (``AudioManager.cs:45-69``) driven
producer/consumer-style.

* In integrity mode the audio thread's drains equal the port's own
  ``Streamer.stream_clip`` on the same seed within 1e-6 (the producer
  overlap-adds each wet chunk and then its taps, the stream's order of
  additions, so they agree bit for bit here): mono, binaural with a
  turning head, shared-rate Doppler, per-arrival Doppler (mono and
  binaural), and with ``control_fn`` reset/stop and a ``scene_fn`` moving
  a wall.
* Fed JAX's per-chunk draws (``uniforms_fn``), the port's player equals
  JAX's ``LivePlayer`` on the same key within the stream tests'
  ``STREAM_TOL`` (rtol 2e-3, atol 2e-5; tests/test_torch_streaming.py):
  mono with reset/stop and a moved wall, binaural, shared-rate Doppler
  and per-arrival Doppler.
* The settings the player shares with ``Streamer`` (one head listener,
  ``arrival_taps``, the early window), checked on both alike.
* After tests/test_live.py: the DSP cadence, backpressure with a tight
  ring, the ring-size floor, underruns counted in realtime mode, the sink
  receiving every buffer and pacing with silence, ``record=False``, and
  ``cli live --play``'s message without ALSA. Threaded runs are held to
  their own invariants only: two runs' underruns and peak lead depend on
  thread scheduling (ROADMAP section 3), so no test compares them.

512 rays, 48 kHz, 0.05 s chunks (2,400 samples) and a 0.1 s IR, as
tests/test_live.py."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CPU, jax_chunk_uniforms, to_numpy

import realisticaudioraytracing2d_tpu as jart
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu.live import LivePlayer as JLivePlayer
from realisticaudioraytracing2d_tpu_torch import cli, native
from realisticaudioraytracing2d_tpu_torch.live import LivePlayer

STREAM_TOL = dict(rtol=2e-3, atol=2e-5)


@pytest.fixture(scope="module")
def live_cfg():
    room = art.rooms.smoll_room(device=CPU)
    cfg = art.smoll_room_config(ray_count=512)
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, reverb_duration=0.1, chunk_duration=0.05))
    params = art.TraceParams.make(room.source, room.listener, device=CPU)
    return room, cfg, params


def _noise(n_samples, seed):
    return (np.random.default_rng(seed).normal(size=n_samples)
            .astype(np.float32) * 0.3)


def _mode(room, cfg, params, mode):
    """(player kwargs, run kwargs) of a live mode, the run's kwargs also
    ``stream_clip``'s: the source drifts where Doppler is on."""
    n, sr = cfg.audio.chunk_samples, cfg.audio.sample_rate
    src = np.float32(room.source)
    lis = np.float32(room.listener).reshape(-1)[:2]
    away = (src - lis) / np.linalg.norm(src - lis)

    def receding(i):       # 0.1 c away from the listener
        return params._replace(source=torch.as_tensor(
            src + away * np.float32(34.3 * n / sr * i)))

    moved = room.builder.move_collider(room.scene, "Wall (4)",
                                       position=(-9.0, 5.0), angle=0.2)
    return {
        "mono": ({}, dict(params_fn=lambda i: params)),
        "binaural": (dict(binaural=True),
                     dict(params_fn=lambda i: params,
                          facing_fn=lambda i: 0.3 * i)),
        "doppler": ({}, dict(params_fn=receding, doppler=True)),
        "per_arrival": ({}, dict(params_fn=receding,
                                 doppler="per_arrival")),
        "per_arrival_binaural": (
            dict(binaural=True),
            dict(params_fn=receding, doppler="per_arrival",
                 facing_fn=lambda i: 0.2 - 0.1 * i)),
        "controls_and_wall": (
            {}, dict(params_fn=lambda i: params,
                     control_fn=lambda i: {"reset_ir": i == 2,
                                           "stop": i == 4},
                     scene_fn=lambda i: moved if i >= 1 else room.scene)),
    }[mode]


@pytest.mark.parametrize("mode", ["mono", "binaural", "doppler",
                                  "per_arrival", "per_arrival_binaural",
                                  "controls_and_wall"])
def test_live_integrity_mode_equals_the_stream(live_cfg, mode):
    room, cfg, params = live_cfg
    n = cfg.audio.chunk_samples
    total = 7
    dry = torch.as_tensor(_noise(3 * n, 2))
    player_kw, run_kw = _mode(room, cfg, params, mode)
    seen = []
    rep = LivePlayer(room.scene, cfg, seed=1, device=CPU, **player_kw).run(
        dry, total_chunks=total, loop=False, realtime=False,
        on_chunk=lambda i, ir: seen.append((i, ir.clone())), **run_kw)
    want = to_numpy(art.Streamer(room.scene, cfg, seed=1, **player_kw)
                    .stream_clip(dry, loop=False, total_chunks=total,
                                 **run_kw))
    chunks = total if mode != "controls_and_wall" else 4 + 2
    n_out = 2 if player_kw.get("binaural") else 1
    assert rep.chunks == chunks and rep.underruns == 0
    assert rep.late_samples == 0
    assert rep.audio.shape == want.shape == (n_out, chunks * n)
    assert rep.callbacks == -(-chunks * n // 1024)
    assert [i for i, _ in seen] == list(range(chunks))
    assert rep.step_ms.shape == (chunks,) and (rep.step_ms > 0).all()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(rep.audio, want, rtol=0, atol=1e-6)
    if n_out == 2:
        assert not np.allclose(rep.audio[0], rep.audio[1])


@pytest.mark.parametrize("mode", ["controls_and_wall", "binaural",
                                  "doppler", "per_arrival"])
def test_live_fed_jax_draws_equals_jax_live(live_cfg, mode):
    room, cfg, params = live_cfg
    n = cfg.audio.chunk_samples
    total = 6
    key = jax.random.PRNGKey(0)
    dry = _noise(3 * n, 3)
    player_kw, run_kw = _mode(room, cfg, params, mode)
    jroom = jart.rooms.smoll_room()
    jmoved = jroom.builder.move_collider(jroom.scene, "Wall (4)",
                                         position=(-9.0, 5.0), angle=0.2)
    jparams = jart.TraceParams.make(jroom.source, jroom.listener, 0.5,
                                    343.0, 1.0)
    jrun = dict(run_kw)
    jrun["params_fn"] = lambda i: jparams._replace(source=jnp.asarray(
        to_numpy(run_kw["params_fn"](i).source)))
    if "scene_fn" in run_kw:
        jrun["scene_fn"] = lambda i: jmoved if i >= 1 else jroom.scene
    want = JLivePlayer(jroom.scene, cfg, key, **player_kw).run(
        jnp.asarray(dry), total_chunks=total, loop=False, **jrun)
    got = LivePlayer(room.scene, cfg, device=CPU, uniforms_fn=lambda i: (
        jax_chunk_uniforms(key, i, 1, cfg.sim.max_bounces,
                           cfg.sim.ray_count)), **player_kw).run(
        torch.as_tensor(dry), total_chunks=total, loop=False, **run_kw)
    assert got.chunks == want.chunks and got.audio.shape == want.audio.shape
    assert np.abs(want.audio).max() > 0
    np.testing.assert_allclose(got.audio, want.audio, **STREAM_TOL)


def test_live_dsp_buffer_cadence(live_cfg):
    room, cfg, params = live_cfg
    n = cfg.audio.chunk_samples
    dry = torch.as_tensor(_noise(2 * n, 2))
    rep = LivePlayer(room.scene, cfg, device=CPU, dsp_buffer=1000).run(
        dry, total_chunks=4, loop=False, params=params)
    assert rep.callbacks == -(-4 * n // 1000)
    assert rep.underruns == 0 and rep.audio.shape == (1, 4 * n)


def test_live_backpressure_tight_ring_stays_lossless(live_cfg):
    # A producer far ahead of the consumer must block on the ring's
    # capacity, not wrap around onto undrained audio. A slow device (a
    # sink sleeping 20 ms a 512-sample block) holds the consumer back;
    # in integrity mode nothing plays early, so the run must be lossless
    # however the threads are scheduled, and the producer's lead can
    # never pass the ring's room for finished samples, size - T.
    room, cfg, params = live_cfg
    n, t = cfg.audio.chunk_samples, cfg.audio.ir_length
    dry = torch.as_tensor(_noise(3 * n, 7))
    player = LivePlayer(room.scene, cfg, seed=1, device=CPU, dsp_buffer=512,
                        ring_size=n + t + 512 + 64)
    sink = _RecordingSink(pace_sr=512 / 0.02)
    rep = player.run(dry, total_chunks=6, loop=False, realtime=False,
                     params=params, sink=sink)
    want = to_numpy(art.Streamer(room.scene, cfg, seed=1).stream_clip(
        dry, lambda i: params, loop=False, total_chunks=6))
    assert rep.chunks == 6 and rep.underruns == 0 and rep.late_samples == 0
    assert rep.max_lead_samples <= player.ring.size - t
    np.testing.assert_allclose(rep.audio, want, rtol=0, atol=1e-6)


def test_live_ring_size_floor_and_device_checks(live_cfg):
    room, cfg, _ = live_cfg
    with pytest.raises(ValueError, match="ring_size"):
        LivePlayer(room.scene, cfg, device=CPU, ring_size=64)
    with pytest.raises(ValueError, match="one head listener"):
        LivePlayer(room.scene, cfg, device=CPU, binaural=True,
                   n_listeners=2)
    with pytest.raises(ValueError, match="arrival_taps"):
        LivePlayer(room.scene, cfg, device=CPU, arrival_taps=0)
    with pytest.raises(ValueError, match="scene lies on"):
        LivePlayer(room.scene, cfg, device="meta")
    if not torch.cuda.is_available():
        # the default device is the card: nothing falls back to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            LivePlayer(room.scene, cfg)


@pytest.mark.parametrize("driver", ["stream", "live"])
@pytest.mark.parametrize("case", ["one head listener", "arrival_taps",
                                  "arrival_early"])
def test_stream_settings_are_checked_once(live_cfg, driver, case):
    # the stream and the player take their settings through one holder:
    # the same refusals, the same listener count and early window
    room, cfg, _ = live_cfg

    def make(**kw):
        if driver == "stream":
            return art.Streamer(room.scene, cfg, **kw)
        return LivePlayer(room.scene, cfg, device=CPU, **kw)

    if case == "one head listener":
        with pytest.raises(ValueError, match=case):
            make(binaural=True, n_listeners=2)
        assert make(binaural=True).n_listeners == 2
    elif case == "arrival_taps":
        with pytest.raises(ValueError, match=case):
            make(arrival_taps=0)
        assert make(arrival_taps=1).state.arrival is None
    else:
        # 0.05 s at 48 kHz; a window past the IR stops at its length
        assert make(arrival_window_s=0.05).arrival_early == 2400
        assert make(arrival_window_s=1.0).arrival_early \
            == cfg.audio.ir_length == 4800


def test_live_realtime_mode_counts_underruns_not_crashes(live_cfg):
    room, cfg, params = live_cfg
    n = cfg.audio.chunk_samples

    def slow(i):
        if i > 0:
            time.sleep(0.2)            # slower than the 0.05 s cadence
        return params

    rep = LivePlayer(room.scene, cfg, device=CPU,
                     dsp_buffer=max(256, n // 4)).run(
        torch.as_tensor(_noise(2 * n, 3)), total_chunks=4, loop=False,
        realtime=True, params_fn=slow)
    assert rep.chunks == 4
    assert rep.underruns > 0
    assert rep.audio.shape[-1] == 4 * n
    assert "underruns" in rep.summary()


class _RecordingSink:
    def __init__(self, pace_sr=None):
        self.blocks = []
        self.pace_sr = pace_sr

    def write(self, block):
        self.blocks.append(np.array(block, np.float32))
        if self.pace_sr:
            time.sleep(block.shape[-1] / self.pace_sr)   # a device blocks
        return block.shape[-1]


def test_live_sink_receives_every_drained_buffer(live_cfg):
    room, cfg, params = live_cfg
    n = cfg.audio.chunk_samples
    sink = _RecordingSink()
    rep = LivePlayer(room.scene, cfg, seed=1, device=CPU).run(
        torch.as_tensor(_noise(2 * n, 0)), total_chunks=4, loop=False,
        params=params, sink=sink)
    np.testing.assert_array_equal(np.concatenate(sink.blocks, axis=-1),
                                  rep.audio)


def test_live_sink_underrun_paces_with_silence_not_spin(live_cfg):
    # realtime + a device sink + a lagging producer: every skipped tick
    # writes one DSP period of silence to the device instead of spinning
    room, cfg, params = live_cfg
    n, sr = cfg.audio.chunk_samples, cfg.audio.sample_rate
    dsp = n // 2

    def slow(i):
        time.sleep(4 * dsp / sr)
        return params

    sink = _RecordingSink(pace_sr=sr)
    rep = LivePlayer(room.scene, cfg, seed=1, device=CPU,
                     dsp_buffer=dsp).run(
        torch.as_tensor(_noise(2 * n, 0)), total_chunks=3, loop=False,
        realtime=True, params_fn=slow, sink=sink, prime=1)
    assert all(b.shape == (1, dsp) for b in sink.blocks)
    assert rep.underruns >= 1
    assert len(sink.blocks) > rep.callbacks
    assert rep.underruns <= len(sink.blocks)


def test_live_record_false_drops_audio_keeps_accounting(live_cfg):
    # record=False loses only the audio; the run's own accounting holds
    # (no comparison with another threaded run: its scheduling differs)
    room, cfg, params = live_cfg
    n = cfg.audio.chunk_samples
    sink = _RecordingSink()
    rep = LivePlayer(room.scene, cfg, seed=1, device=CPU).run(
        torch.as_tensor(_noise(2 * n, 0)), total_chunks=4, loop=False,
        params=params, record=False, sink=sink)
    assert rep.audio.shape == (1, 0)
    assert rep.chunks == 4 and rep.underruns == 0
    assert rep.callbacks == -(-4 * n // 1024) == len(sink.blocks)
    assert 0 < rep.max_lead_samples <= 4 * n
    heard = np.concatenate(sink.blocks, axis=-1)
    want = to_numpy(art.Streamer(room.scene, cfg, seed=1).stream_clip(
        torch.as_tensor(_noise(2 * n, 0)), lambda i: params, loop=False,
        total_chunks=4))
    np.testing.assert_allclose(heard, want, rtol=0, atol=1e-6)


def test_cli_live_play_degrades_cleanly_without_alsa():
    if native.sink_probe()[0]:
        pytest.skip("ALSA present here; the degradation path is not "
                    "reachable")
    with pytest.raises(SystemExit, match="--play: audio sink unavailable"):
        cli.main(["live", "--room", "smoll", "--rays", "64", "--bounces",
                  "4", "--frames", "1", "--reverb", "0.2", "--sample-rate",
                  "8000", "--duration", "0.2", "--play", "--device", CPU])
