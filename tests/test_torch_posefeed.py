"""PyTorch port: the pose feed (``posefeed.py``), JSON-lines steering of a
running stream or live session.

Every scenario of ``tests/test_posefeed.py`` runs here against the port,
and the feed itself is held against the JAX package's: a :class:`Twin`
writes the same bytes to two files, opens one with each package's
``PoseFeed`` and asks both every question (per-chunk params, facing,
control and scene walls), which must agree exactly, errors and their
messages too. The port's overrides are float32 tensors on the device of
the stream's params. Stream and live scenarios drive the port's
``Streamer`` and ``LivePlayer`` through the twin and hold the fed run
against the run with the equivalent explicit functions, bit for bit, as
the JAX tests do. One scenario is the port's alone: a multibyte UTF-8
character torn across two polls at every byte boundary, through a
regular file and a pipe, parses."""

import argparse
import dataclasses
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CPU, to_numpy

import realisticaudioraytracing2d_tpu as jart
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu.posefeed import PoseFeed as JPoseFeed
from realisticaudioraytracing2d_tpu_torch import cli
from realisticaudioraytracing2d_tpu_torch.live import LivePlayer
from realisticaudioraytracing2d_tpu_torch.posefeed import (PoseFeed,
                                                           PoseFeedError)
from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (noise_burst,
                                                                 read_wav,
                                                                 write_wav)

TINY = ["--rays", "256", "--bounces", "4", "--frames", "1",
        "--reverb", "0.2", "--sample-rate", "8000", "--device", CPU]


def _outcome(fn):
    """``("ok", value)`` or ``("raised", type name, message)``."""
    try:
        return ("ok", fn())
    except (PoseFeedError, KeyError, ValueError) as e:
        return ("raised", type(e).__name__, str(e))


class Twin:
    """The port's feed and JAX's on the same bytes (two files, written
    alike). Each query goes to both; their answers (or their errors) must
    be equal; the port's answer is returned, or its error raised."""

    def __init__(self, tmp_path, lines=(), name="feed.jsonl", raw=None):
        self.paths = [tmp_path / f"port_{name}", tmp_path / f"jax_{name}"]
        text = raw if raw is not None else "".join(
            json.dumps(line) + "\n" for line in lines)
        for p in self.paths:
            p.write_text(text)
        self.port = PoseFeed.open(str(self.paths[0]))
        self.jax = JPoseFeed.open(str(self.paths[1]))
        self.room = art.rooms.smoll_room(device=CPU)
        self.jroom = jart.rooms.smoll_room()
        self.base = art.TraceParams.make(self.room.source,
                                         self.room.listener, device=CPU)
        self.jbase = jart.TraceParams.make(self.jroom.source,
                                           self.jroom.listener, 0.5, 343.0,
                                           1.0)

    def append(self, text: str) -> None:
        for p in self.paths:
            with open(p, "a") as fh:
                fh.write(text)
                fh.flush()

    def bind(self) -> "Twin":
        self.port.bind_scene(self.room.builder)
        self.jax.bind_scene(self.jroom.builder)
        return self

    def _ask(self, port_fn, jax_fn, same):
        got, want = _outcome(port_fn), _outcome(jax_fn)
        assert got[0] == want[0], (got, want)
        if got[0] == "raised":
            assert got[1:] == want[1:]
            raise {"PoseFeedError": PoseFeedError, "KeyError": KeyError,
                   "ValueError": ValueError}[got[1]](got[2])
        same(got[1], want[1])
        return got[1]

    def params(self, i, base=None, jbase=None):
        def same(p, q):
            assert isinstance(p.source, torch.Tensor)
            assert p.source.device == self.base.source.device
            for f in ("source", "listeners"):
                assert getattr(p, f).dtype == torch.float32
                np.testing.assert_array_equal(to_numpy(getattr(p, f)),
                                              np.asarray(getattr(q, f)))
        return self._ask(lambda: self.port.params(base or self.base, i),
                         lambda: self.jax.params(jbase or self.jbase, i),
                         same)

    def facing(self, base, i):
        def same(a, b):
            assert a == b
        return self._ask(lambda: self.port.facing(base, i),
                         lambda: self.jax.facing(base, i), same)

    def control(self, i):
        def same(a, b):
            assert a == b
        return self._ask(lambda: self.port.control(i),
                         lambda: self.jax.control(i), same)

    def scene(self, i, base=None, jbase=None):
        def same(s, js):
            for f in ("a", "b", "normal", "absorption", "mask"):
                np.testing.assert_array_equal(to_numpy(getattr(s, f)),
                                              np.asarray(getattr(js, f)))
        return self._ask(
            lambda: self.port.scene(base or self.room.scene, i),
            lambda: self.jax.scene(jbase or self.jroom.scene, i), same)

    def all_at(self, i):
        """Every query of one chunk, in the stream's order."""
        self.control(i)
        self.scene(i)
        p = self.params(i)
        self.facing(0.25, i)
        return p


def src_of(p):
    return to_numpy(p.source)


# ---- unit: parsing / hold semantics ----------------------------------------


def test_overrides_apply_at_their_chunk_and_hold(tmp_path):
    tw = Twin(tmp_path, [{"chunk": 1, "source": [1.0, 2.0]},
                         {"chunk": 3, "listener": [5.0, 6.0],
                          "facing": 0.5}])
    p = tw.base
    np.testing.assert_array_equal(src_of(tw.params(0)), src_of(p))
    np.testing.assert_array_equal(src_of(tw.params(1)), [1.0, 2.0])
    p2 = tw.params(2)
    np.testing.assert_array_equal(src_of(p2), [1.0, 2.0])
    np.testing.assert_array_equal(to_numpy(p2.listeners),
                                  to_numpy(p.listeners))
    assert tw.facing(9.9, 2) == 9.9
    p3 = tw.params(3)
    np.testing.assert_array_equal(to_numpy(p3.listeners), [[5.0, 6.0]])
    assert tw.facing(9.9, 3) == 0.5


def test_chunkless_line_applies_immediately(tmp_path):
    tw = Twin(tmp_path, [{"source": [3.0, 4.0]}])
    np.testing.assert_array_equal(src_of(tw.params(5)), [3.0, 4.0])


def test_tail_semantics_lines_appended_mid_stream(tmp_path):
    tw = Twin(tmp_path)
    np.testing.assert_array_equal(src_of(tw.params(0)), src_of(tw.base))
    tw.append(json.dumps({"source": [7.0, 8.0]}) + "\n")
    np.testing.assert_array_equal(src_of(tw.params(1)), [7.0, 8.0])


def test_partial_line_buffers_until_newline(tmp_path):
    tw = Twin(tmp_path, raw='{"source": [1.0,')
    tw.params(0)                               # must not error or apply
    tw.append(' 2.0]}\n')
    np.testing.assert_array_equal(src_of(tw.params(1)), [1.0, 2.0])


def test_regular_file_tailed_in_binary_mode(tmp_path):
    # regular files are read unbuffered binary (a text-mode read() can
    # drop the bytes between two polls); hundreds of polls over a file
    # that grows by a torn line each time
    tw = Twin(tmp_path)
    assert isinstance(tw.port._fh.read(0), bytes)
    assert tw.port._select_fd is None
    for i in range(300):
        line = json.dumps({"source": [float(i), 9.0]}) + "\n"
        cut = 1 + (i * 7) % (len(line) - 2)
        tw.append(line[:cut])
        tw.params(2 * i)                      # mid-line poll
        tw.append(line[cut:])
        np.testing.assert_array_equal(src_of(tw.params(2 * i + 1)),
                                      [float(i), 9.0])


def test_late_line_applies_at_next_poll(tmp_path):
    tw = Twin(tmp_path, [{"chunk": 2, "source": [9.0, 9.0]}])
    np.testing.assert_array_equal(src_of(tw.params(7)), [9.0, 9.0])


@pytest.mark.parametrize("line,match", [
    ("not json at all", "invalid JSON"),
    ('{"sorce": [1, 2]}', "unknown key"),
    ('{"chunk": -1, "source": [1, 2]}', "chunk"),
    ('{"chunk": 0}', "no override"),
    ('{"source": [1]}', "source"),
    ('{"source": [1, "a"]}', "source"),
    ('{"facing": true}', "facing"),
    ('{"listener": [1e999, 0]}', "non-finite"),
    ('[1, 2]', "JSON object"),
])
def test_malformed_lines_error_cleanly(tmp_path, line, match):
    tw = Twin(tmp_path, raw=line + "\n")
    with pytest.raises(PoseFeedError, match=match):
        tw.params(0)


def test_lookahead_poll_does_not_leak_future_override(tmp_path):
    tw = Twin(tmp_path, [{"chunk": 5, "source": [1.0, 2.0]}])
    tw.params(5)                          # lookahead while producing 4
    np.testing.assert_array_equal(src_of(tw.params(4)), src_of(tw.base))
    np.testing.assert_array_equal(src_of(tw.params(5)), [1.0, 2.0])


def test_single_source_nested_list_form(tmp_path):
    tw = Twin(tmp_path, [{"source": [[1.0, 2.0]]}])
    p = tw.params(0)
    assert tuple(p.source.shape) == (2,)
    np.testing.assert_array_equal(src_of(p), [1.0, 2.0])


def test_shape_mismatch_errors(tmp_path):
    tw = Twin(tmp_path, [{"source": [[0.0, 0.0], [1.0, 1.0]]}])
    with pytest.raises(PoseFeedError, match="source override shape"):
        tw.params(0)


def test_overrides_land_on_the_params_device_and_broadcast(tmp_path):
    # two listeners take one [x, y] override each; the meta device stands
    # in for the card: the override must follow the params' device
    tw = Twin(tmp_path, [{"listener": [2.0, 3.0]}])
    two = art.TraceParams.make(tw.room.source,
                               np.stack([tw.room.listener] * 2), device=CPU)
    jtwo = jart.TraceParams.make(tw.jroom.source,
                                 np.stack([tw.jroom.listener] * 2),
                                 0.5, 343.0, 1.0)
    p = tw.params(0, two, jtwo)
    np.testing.assert_array_equal(to_numpy(p.listeners),
                                  [[2.0, 3.0], [2.0, 3.0]])
    meta = two._replace(source=two.source.to("meta"),
                        listeners=two.listeners.to("meta"))
    q = tw.port.params(meta, 1)
    assert q.listeners.device.type == "meta"
    assert tuple(q.listeners.shape) == (2, 2)


# ---- streams: fed == the equivalent explicit functions ----------------------


def _stream_setup():
    room = art.rooms.smoll_room(device=CPU)
    cfg = art.smoll_room_config(ray_count=256)
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, sample_rate=8000, reverb_duration=0.2))
    return room, cfg, art.Engine(room.scene, cfg)


def _fed(tw, eng, src, room):
    static = eng.params(src, room.listener)
    return lambda i: tw.params(i, static, tw.jbase._replace(
        source=jnp.asarray(src), listeners=jnp.asarray(
            np.asarray(room.listener, np.float32).reshape(-1, 2))))


@pytest.mark.parametrize("doppler,step", [(False, None), (True, 0.4),
                                          ("per_arrival", 0.3)])
def test_pose_feed_stream_equals_params_fn_stream(tmp_path, doppler, step):
    # the three JAX scenarios: a jump at chunk 1 (plain), and a source
    # moving every chunk under the Doppler feed's rate lookahead (which
    # polls i + 1 while producing i) and under per-arrival Doppler
    room, cfg, eng = _stream_setup()
    dry = torch.as_tensor(noise_burst(0.25, 8000, seed=1))
    src = np.asarray(room.source, np.float32)
    total = None if step is None else 4
    if step is None:
        def moved(i):
            return eng.params(src + (np.float32([0.5, 0.0]) if i >= 1
                                     else 0.0), room.listener)
        lines = [{"chunk": 1, "source": [float(src[0] + 0.5),
                                         float(src[1])]}]
    else:
        def moved(i):
            return eng.params(src + np.float32([step * i, 0.0]),
                              room.listener)
        lines = [{"chunk": i, "source": [float(src[0] + step * i),
                                         float(src[1])]}
                 for i in range(total)]
    tw = Twin(tmp_path, lines)
    fed = _fed(tw, eng, src, room)

    def run(fn):
        return to_numpy(art.Streamer(room.scene, cfg, seed=0).stream_clip(
            dry, fn, loop=False, total_chunks=total, doppler=doppler))

    got, want = run(fed), run(moved)
    np.testing.assert_array_equal(got, want)
    static = run(lambda i: eng.params(src, room.listener))
    assert not np.array_equal(got, static)


def test_pose_feed_obstacle_stream_equals_scene_fn_stream(tmp_path):
    room, cfg, eng = _stream_setup()
    dry = torch.as_tensor(noise_burst(0.25, 8000, seed=1))
    p = eng.params(room.source, room.listener)
    moved = room.builder.move_collider(room.scene, "Wall (4)",
                                       position=(-9.0, 5.0), angle=0.2)
    tw = Twin(tmp_path, [{"chunk": 1, "obstacle": "Wall (4)",
                          "position": [-9.0, 5.0], "angle": 0.2}]).bind()

    def run(scene_fn):
        return to_numpy(art.Streamer(room.scene, cfg, seed=0).stream_clip(
            dry, lambda i: p, scene_fn=scene_fn, loop=False))

    got = run(lambda i: tw.scene(i, room.scene))
    np.testing.assert_array_equal(got, run(
        lambda i: moved if i >= 1 else room.scene))
    assert not np.array_equal(got, run(None))     # the move is audible


def test_pose_feed_stop_flushes_tail(tmp_path):
    room, cfg, eng = _stream_setup()
    n = cfg.audio.chunk_samples
    dry = torch.as_tensor(noise_burst(1.0, 8000, seed=1))   # 10 chunks
    p = eng.params(room.source, room.listener)
    tw = Twin(tmp_path, [{"chunk": 3, "command": "stop"}])
    got = to_numpy(art.Streamer(room.scene, cfg, seed=0).stream_clip(
        dry, lambda i: p, loop=False, control_fn=tw.control))
    tail_chunks = (cfg.audio.ir_length + n - 1) // n
    assert got.shape[-1] == (3 + tail_chunks) * n
    tail = got[0, 3 * n:]
    assert np.abs(tail).max() > 0
    head_rms = np.sqrt(np.mean(tail[:n // 4] ** 2))
    end_rms = np.sqrt(np.mean(tail[-n // 4:] ** 2))
    assert end_rms < 0.5 * head_rms


def test_pose_feed_reset_ir_cuts_the_crossfade_memory(tmp_path):
    room, cfg, eng = _stream_setup()
    n = cfg.audio.chunk_samples
    dry = torch.as_tensor(noise_burst(0.4, 8000, seed=1))
    p = eng.params(room.source, room.listener)
    tw = Twin(tmp_path, [{"chunk": 2, "command": "reset_ir"}])
    got = to_numpy(art.Streamer(room.scene, cfg, seed=0).stream_clip(
        dry, lambda i: p, loop=False, control_fn=tw.control))
    plain = to_numpy(art.Streamer(room.scene, cfg, seed=0).stream_clip(
        dry, lambda i: p, loop=False))
    assert got.shape == plain.shape
    np.testing.assert_array_equal(got[:, :2 * n], plain[:, :2 * n])
    assert not np.array_equal(got[:, 2 * n:3 * n], plain[:, 2 * n:3 * n])


def test_live_stop_verb_shrinks_the_run(tmp_path):
    room, cfg, eng = _stream_setup()
    n = cfg.audio.chunk_samples
    p = eng.params(room.source, room.listener)
    dry = torch.as_tensor(noise_burst(0.8, 8000, seed=1))
    tw = Twin(tmp_path, [{"chunk": 2, "command": "stop"}])
    rep = LivePlayer(room.scene, cfg, seed=0, device=CPU).run(
        dry, total_chunks=8, loop=False, params=p, control_fn=tw.control)
    tail_chunks = (cfg.audio.ir_length + n - 1) // n
    assert rep.chunks == 2 + tail_chunks
    assert rep.audio.shape[-1] == (2 + tail_chunks) * n
    assert np.abs(rep.audio).max() > 0


def test_live_obstacle_steering_equals_scene_fn(tmp_path):
    room, cfg, eng = _stream_setup()
    p = eng.params(room.source, room.listener)
    dry = torch.as_tensor(noise_burst(0.3, 8000, seed=1))
    moved = room.builder.move_collider(room.scene, "Wall (4)",
                                       position=(-9.0, 5.0))
    tw = Twin(tmp_path, [{"chunk": 1, "obstacle": "Wall (4)",
                          "position": [-9.0, 5.0]}]).bind()

    def run(scene_fn):
        return LivePlayer(room.scene, cfg, seed=0, device=CPU).run(
            dry, total_chunks=3, loop=False, params=p,
            scene_fn=scene_fn).audio

    np.testing.assert_array_equal(
        run(lambda i: tw.scene(i, room.scene)),
        run(lambda i: moved if i >= 1 else room.scene))


# ---- geometry steering ------------------------------------------------------


def test_move_collider_changes_only_its_rows_as_jax():
    room = art.rooms.smoll_room(device=CPU)
    jroom = jart.rooms.smoll_room()
    b = room.builder
    assert [c.name for c in b.colliders] == [
        "Wall", "Wall (1)", "Wall (2)", "Wall (3)", "Wall (4)"]
    moved = b.move_collider(room.scene, "Wall (4)", position=(-10.0, 6.0),
                            angle=0.3)
    jmoved = jroom.builder.move_collider(jroom.scene, "Wall (4)",
                                         position=(-10.0, 6.0), angle=0.3)
    for f in ("a", "b", "normal"):
        np.testing.assert_array_equal(to_numpy(getattr(moved, f)),
                                      np.asarray(getattr(jmoved, f)))
    c = b.find_collider("Wall (4)")
    rows = slice(c.start, c.start + c.count)
    a0, a1 = to_numpy(room.scene.a), to_numpy(moved.a)
    assert not np.allclose(a0[rows], a1[rows])
    outside = np.ones(len(a0), bool)
    outside[rows] = False
    np.testing.assert_array_equal(a0[outside], a1[outside])
    assert moved.n_walls == room.scene.n_walls
    np.testing.assert_array_equal(to_numpy(b.move_collider(
        room.scene, 4, position=(-10.0, 6.0), angle=0.3).a), a1)


def test_move_collider_partial_override_falls_back_to_authored():
    room = art.rooms.smoll_room(device=CPU)
    b = room.builder
    c = b.find_collider("Wall (4)")
    only_angle = b.move_collider(room.scene, "Wall (4)", angle=1.0)
    both = b.move_collider(room.scene, "Wall (4)",
                           position=c.transform.position, angle=1.0)
    np.testing.assert_array_equal(to_numpy(only_angle.a), to_numpy(both.a))


def test_move_collider_unknown_name_lists_known():
    room = art.rooms.smoll_room(device=CPU)
    with pytest.raises(KeyError, match="Wall \\(4\\)"):
        room.builder.move_collider(room.scene, "Door")


def test_pose_feed_obstacle_errors_name_the_line(tmp_path):
    tw = Twin(tmp_path, [{"source": [1.0, 1.0]},
                         {"obstacle": "Door", "position": [1.0, 1.0]}]
              ).bind()
    with pytest.raises(PoseFeedError, match="line 2.*Door"):
        tw.scene(0)
    tw2 = Twin(tmp_path, [{"obstacle": "Wall"}], name="f2.jsonl")
    with pytest.raises(PoseFeedError, match="position.*angle|angle"):
        tw2.params(0)
    tw3 = Twin(tmp_path, [{"obstacle": "Wall", "angle": 0.1}],
               name="f3.jsonl")
    with pytest.raises(PoseFeedError, match="no steerable scene"):
        tw3.scene(0)
    tw4 = Twin(tmp_path, [{"position": [0.0, 0.0]}], name="f4.jsonl")
    with pytest.raises(PoseFeedError, match="obstacle"):
        tw4.params(0)
    tw5 = Twin(tmp_path, [{"command": "pause"}], name="f5.jsonl")
    with pytest.raises(PoseFeedError, match="unknown command"):
        tw5.params(0)


def test_every_query_of_a_mixed_feed_matches_jax(tmp_path):
    # sources, listeners, facings, obstacles by name and index, resets
    # and a stop, some stamped, some late, some chunk-less, queried chunk
    # by chunk as a stream does (control, scene, params, facing)
    lines = [{"chunk": 1, "source": [-10.0, 5.0]},
             {"chunk": 2, "listener": [1.0, -2.0], "facing": 0.3},
             {"chunk": 2, "obstacle": "Wall (4)", "angle": 0.2},
             {"chunk": 3, "command": "reset_ir"},
             {"obstacle": 4, "position": [-9.0, 5.0]},
             {"chunk": 1, "facing": -0.4},
             {"chunk": 6, "obstacle": "Wall (4)", "position": [-8.0, 4.0],
              "command": "reset_ir"},
             {"chunk": 8, "command": "stop"}]
    tw = Twin(tmp_path, lines).bind()
    for i in range(11):
        tw.all_at(i)
        if i == 4:
            tw.append(json.dumps({"source": [0.0, 0.0]}) + "\n")
    assert tw.control(10) == {"stop": True, "reset_ir": False}


def test_long_session_folding_bounds_state(tmp_path):
    lines = [{"chunk": i, "source": [float(i % 7), 0.0]}
             for i in range(10000)]
    lines.append({"chunk": 10500, "source": [42.0, 0.0]})
    tw = Twin(tmp_path, lines)
    tw.params(0)
    for q in range(9990, 10010):
        tw.params(q)
    assert len(tw.port._pending) == len(tw.jax._pending) == 1
    np.testing.assert_array_equal(src_of(tw.params(10010)),
                                  [float(9999 % 7), 0.0])
    np.testing.assert_array_equal(src_of(tw.params(10500)), [42.0, 0.0])


def test_facing_override_on_non_binaural_stream_warns(tmp_path):
    path = tmp_path / "f.jsonl"
    path.write_text(json.dumps({"facing": 0.5}) + "\n")
    args = argparse.Namespace(pose_feed=str(path))
    room = art.rooms.smoll_room(device=CPU)
    base = art.TraceParams.make(room.source, room.listener, device=CPU)
    poses, facing_fn, scene_fn, control_fn = cli._pose_feed_wrap(
        args, lambda i: base, None, room, binaural=False)
    assert facing_fn is None
    with pytest.warns(UserWarning, match="not binaural"):
        poses(0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # warned once, not per chunk
        poses(1)


# ---- torn multibyte characters (the port's repair) --------------------------


def _named_room(name):
    """SmollRoom's walls with the slanted one renamed ``name``."""
    from realisticaudioraytracing2d_tpu_torch.models.scene import SceneBuilder
    src = art.rooms.smoll_room(device=CPU).builder
    b = SceneBuilder()
    for c in src.colliders:
        b.add_box(c.material, c.transform, name=(name if c.name == "Wall (4)"
                                                 else c.name))
    return b, b.build(device=CPU)


@pytest.mark.parametrize("transport", ["file", "pipe"])
def test_multibyte_character_torn_at_every_byte_parses(tmp_path, transport):
    # The line names a collider with non-ASCII characters; its bytes
    # arrive in two pieces, cut at every byte boundary, with a poll in
    # between. The port keeps the partial line as bytes and decodes whole
    # lines only. (The JAX package's copy decodes each read on its own,
    # so a torn character becomes U+FFFD and the line fails, as
    # ADVICE.md notes for posefeed.py:268,272: not a fault of the port.)
    name = "Wänd ☃ 壁"
    builder, scene = _named_room(name)
    want = builder.move_collider(scene, name, position=(-9.0, 5.0))
    line = (json.dumps({"obstacle": name, "position": [-9.0, 5.0]},
                       ensure_ascii=False) + "\n").encode("utf-8")
    assert len(line) > len(line.decode("utf-8"))      # multibyte
    params = art.TraceParams.make([-18.0, 9.0], [0.0, -3.68], device=CPU)
    for cut in range(1, len(line)):
        if transport == "file":
            path = tmp_path / f"torn_{cut}.jsonl"
            path.write_bytes(line[:cut])
            feed = PoseFeed.open(str(path)).bind_scene(builder)
            feed.params(params, 0)
            with open(path, "ab") as fh:
                fh.write(line[cut:])
        else:
            r, w = os.pipe()
            feed = PoseFeed(os.fdopen(r, "rb", buffering=0),
                            close=True).bind_scene(builder)
            assert feed._select_fd is not None
            os.write(w, line[:cut])
            feed.params(params, 0)
            os.write(w, line[cut:])
            os.close(w)
        got = feed.scene(scene, 1)
        feed.close()
        np.testing.assert_array_equal(to_numpy(got.a), to_numpy(want.a))


# ---- CLI end to end ---------------------------------------------------------


def _replay(path, chunks, bind=True):
    """The feed file through both packages' feeds, chunk by chunk."""
    import shutil
    tw = Twin(path.parent, name=path.name + ".twin")
    for p in tw.paths:
        shutil.copy(path, p)
    if bind:
        tw.bind()
    for i in range(chunks):
        tw.all_at(i)


def test_cli_stream_pose_feed(tmp_path):
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, noise_burst(0.2, 8000, seed=3), 8000)
    feed = tmp_path / "poses.jsonl"
    feed.write_text(json.dumps({"chunk": 1, "source": [-10.0, 5.0]}) + "\n")
    cli.main(["stream", "--room", "smoll", *TINY, "--in", dry,
              "--out", str(tmp_path / "plain.wav")])
    cli.main(["stream", "--room", "smoll", *TINY, "--in", dry,
              "--out", str(tmp_path / "fed.wav"), "--pose-feed", str(feed)])
    a, _ = read_wav(str(tmp_path / "fed.wav"))
    b, _ = read_wav(str(tmp_path / "plain.wav"))
    assert a.shape == b.shape and not np.array_equal(a, b)
    _replay(feed, 4)


def test_cli_stream_pose_feed_malformed_line_fails(tmp_path):
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, noise_burst(0.15, 8000, seed=3), 8000)
    feed = tmp_path / "poses.jsonl"
    feed.write_text('{"bogus": 1}\n')
    with pytest.raises(PoseFeedError, match="unknown key"):
        cli.main(["stream", "--room", "smoll", *TINY, "--in", dry,
                  "--out", str(tmp_path / "x.wav"), "--pose-feed",
                  str(feed)])


def test_cli_live_pose_feed(tmp_path, capsys):
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, noise_burst(0.2, 8000, seed=3), 8000)
    out = str(tmp_path / "live.wav")
    feed = tmp_path / "poses.jsonl"
    feed.write_text(json.dumps({"chunk": 1, "listener": [2.0, -2.0]}) + "\n")
    cli.main(["live", "--room", "smoll", *TINY, "--in", dry, "--out", out,
              "--duration", "0.3", "--pose-feed", str(feed)])
    x, rate = read_wav(out)
    assert rate == 8000 and x.shape == (3 * 800,) and np.abs(x).max() > 0
    assert "live: 3 chunks" in capsys.readouterr().out
    _replay(feed, 3)


def test_cli_stream_pose_feed_obstacle_and_stop(tmp_path):
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, noise_burst(0.5, 8000, seed=3), 8000)
    out = str(tmp_path / "steered.wav")
    feed = tmp_path / "feed.jsonl"
    feed.write_text(
        json.dumps({"chunk": 1, "obstacle": "Wall (4)",
                    "position": [-9.0, 5.0]}) + "\n"
        + json.dumps({"chunk": 3, "command": "stop"}) + "\n")
    cli.main(["stream", "--room", "smoll", *TINY, "--in", dry, "--out", out,
              "--pose-feed", str(feed)])
    x, _ = read_wav(out)
    assert x.shape[0] == 5 * 800       # stopped at 3 + 2 tail chunks
    assert np.abs(x).max() > 0
    _replay(feed, 5)
