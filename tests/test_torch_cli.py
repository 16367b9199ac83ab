"""PyTorch port: the command line's ``trace``, ``bake``, ``stream``,
``live``, ``sweep``, ``analyze``, ``fit`` and ``locate`` subcommands on
the CPU.

``--device cpu`` runs the plain versions. The sweep's npz must hold
exactly what :func:`sweep_rooms` returns for the same arguments; ``trace``
must write its images and a checkpoint that ``--ir-in`` resumes (the frame
count continues), holding exactly the engine's IR; ``bake`` and ``bake
--legacy`` must write a WAV with a reverb tail after each click. The flags
default as the JAX CLI's do; ``bench`` parses with ``--device`` alone
(default ``cuda``), as the JAX ``bench`` takes no flag, and argparse
rejects any other (tests/test_torch_bench.py runs it). ``sweep --sharded`` writes the npz of the run
without it, on one device and with the rooms split over a virtual mesh of
8 (the sweep's bits, room by room).

The directive, diffraction and air flags (``--directivity``,
``--mic-directivity``, ``--stereo-aim``, ``--diffraction[-order]``,
``--air*``) parse as the JAX CLI's; ``cli trace`` with all of them, fed
JAX's frame uniforms, prints JAX's IR energy within rtol 1e-4 and its
peak bin, the same diffraction and air lines, and checkpoints the raw IR
within the trace parity limits of ``test_torch_directivity.py`` (rtol
1e-4 plus atol 3e-5 of the largest bin).

The spatial and binaural commands, fed JAX's frame uniforms: ``trace
--spatial-out`` writes JAX's npz keys with W/X/Y within those trace
limits and JAX's arrival table; ``bake --binaural`` writes JAX's WAV
within 3 PCM16 steps (the decode's float32 target bins may round one
spacing over, tests/test_torch_spatial.py) and refuses what JAX refuses;
``stream --binaural --head-turn`` writes what ``Streamer`` streams; the
``analyze`` report and ``sweep --metrics-out`` hold the metrics of
``analysis`` and JAX's within test_torch_analysis.py's limits.

``stream --doppler`` and ``--doppler-per-arrival`` (with the
``--arrival-*`` knobs, defaulting as JAX's) exclude each other at parse
time as the JAX CLI's do; the per-arrival stream writes what ``Streamer``
streams for the same knobs, the shared-rate one a changed WAV.

``live`` (integrity mode) writes what ``stream`` writes for the same seed
and flags, mono and binaural per-arrival, and prints JAX's ``live:``
line; ``--scene-json`` builds JAX's scene, poses and patterns from the
same file, and its named colliders take the pose feed's ``obstacle``
lines; without ``--in`` the commands read the bundled clip; mp3 goes in
and out through the system codecs (skipped without them).

``fit`` and ``locate`` parse with the JAX CLI's flags and defaults, take
a target from the port's ``trace --ir-out``, write the JAX CLI's JSON
keys and, fed JAX's draws, report exactly what ``diff.fit_materials`` /
``diff.localize_source`` return for the same arguments; a target of
another listener or band count exits with the JAX CLI's messages."""

import argparse
import dataclasses
import json
import struct
import zlib

import numpy as np
import pytest
import torch
from torch_parity import CPU, jax_frame_uniforms

import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu import cli as jax_cli
from realisticaudioraytracing2d_tpu_torch import cli
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.parallel.mesh import make_mesh
from realisticaudioraytracing2d_tpu_torch.parallel.sweep import sweep_rooms
from realisticaudioraytracing2d_tpu_torch.utils import checkpoint as ckpt
from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (click_clip,
                                                                 noise_burst,
                                                                 read_wav,
                                                                 write_wav)

# 256 rays x 4 bounces (SmollRoom's source sits behind the transmissive slant
# wall: no hit before bounce 2), 8 kHz, 2,048 bins (the first arrival is at
# ~63 ms), 2 frames
SMALL = ["--rays", "256", "--bounces", "4", "--sample-rate", "8000",
         "--reverb", "0.256", "--frames", "2", "--seed", "3", "--device", CPU]


def _read_png(path):
    """Decode what ``utils/png.py`` writes (8-bit RGB, filter 0, one IDAT)
    into ``[H, W, 3]`` uint8."""
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, color = struct.unpack(">IIBB", raw[16:26])
    assert (depth, color) == (8, 2)
    n = struct.unpack(">I", raw[33:37])[0]
    assert raw[37:41] == b"IDAT"
    rows = np.frombuffer(zlib.decompress(raw[41:41 + n]), np.uint8
                         ).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_cli_sweep_writes_the_sweep(tmp_path, capsys):
    out = tmp_path / "irs.npz"
    cli.main(["sweep", "--rooms", "3", "--rays", "128", "--bounces", "4",
              "--sample-rate", "8000", "--reverb", "0.256", "--frames", "2",
              "--seed", "5", "--out", str(out), "--device", CPU])
    assert "swept 3 rooms in" in capsys.readouterr().out
    got = np.load(out)
    scenes, src, lis = rooms.random_rooms(3, seed=5, device=CPU)
    want = sweep_rooms(scenes, src, lis, 5, n_rays=128, max_bounces=4,
                       sample_rate=8000, ir_length=2048, n_frames=2)
    assert got["irs"].shape == (3, 1, 2048, 1)
    np.testing.assert_array_equal(got["irs"], want.numpy())
    np.testing.assert_array_equal(got["sources"], src)
    np.testing.assert_array_equal(got["listeners"], lis)
    assert got["irs"].sum() > 0


def test_cli_sweep_flags_default_as_jax():
    port = cli.build_parser().parse_args(["sweep", "--out", "x.npz"])
    ref = argparse.ArgumentParser()
    jax_cli._common(ref)
    ref = ref.parse_args([])
    for flag in ("rays", "bounces", "bands", "sample_rate", "reverb",
                 "frames", "seed", "stereo"):
        assert getattr(port, flag) == getattr(ref, flag), flag
    assert port.rooms == 64 and port.device == "cuda"
    assert torch.device(port.device).type == "cuda"


def test_cli_trace_writes_images_and_resumes(tmp_path, capsys):
    out, scene_png, spectro, ir_npz = (str(tmp_path / n) for n in (
        "ir.png", "scene.png", "spectro.png", "ir.npz"))
    cli.main(["trace", "--room", "smoll", *SMALL, "--out", out, "--scene-out",
              scene_png, "--spectro-out", spectro, "--ir-out", ir_npz,
              "--debug-rays", "20"])
    said = capsys.readouterr().out
    assert "traced 2 frames x 256 rays in" in said and "peak bin" in said
    for path in (out, scene_png, spectro, ir_npz):
        assert f"wrote {path}" in said
    assert _read_png(out).shape == (256, 1024, 3)
    assert _read_png(scene_png).shape == (600, 800, 3)
    assert _read_png(spectro).shape == (256, 1024, 3)
    for path in (out, scene_png, spectro):
        assert _read_png(path).any(), path
    # the checkpoint holds exactly the engine's IR of that seed
    room = rooms.smoll_room(device=CPU)
    cfg = art.smoll_room_config(ray_count=256)
    cfg = dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, max_bounces=4),
        audio=dataclasses.replace(cfg.audio, sample_rate=8000,
                                  reverb_duration=0.256))
    eng = art.Engine(room.scene, cfg)
    want = eng.trace_frames(eng.params(room.source, room.listener), seed=3,
                            n_frames=2)
    state = ckpt.load_ir_state(ir_npz, device=CPU)
    assert state.frames == 2 and tuple(state.sum.shape) == (1, 2048, 1)
    assert torch.equal(state.sum, want.sum) and float(state.sum.sum()) > 0
    peak = int(state.normalized()[0, :, 0].argmax())
    assert f"peak bin {peak} " in said
    # resume: the frame count continues and the sum grows
    again = str(tmp_path / "ir2.npz")
    cli.main(["trace", *SMALL, "--ir-in", ir_npz, "--ir-out", again])
    said = capsys.readouterr().out
    assert f"resuming from {ir_npz} at frame 2" in said
    resumed = ckpt.load_ir_state(again, device=CPU)
    assert resumed.frames == 4
    assert float(resumed.sum.sum()) > 1.5 * float(state.sum.sum())
    # the resumed frames are new draws, not the first two again
    assert not torch.equal(resumed.sum - state.sum, state.sum)


def test_cli_trace_stereo_and_banded_spectrogram(tmp_path, capsys):
    spectro, ir_npz = str(tmp_path / "s.png"), str(tmp_path / "ir.npz")
    cli.main(["trace", *SMALL, "--stereo", "0.4", "--bands", "4",
              "--spectro-out", spectro, "--ir-out", ir_npz, "--gain", "50"])
    assert "traced 2 frames" in capsys.readouterr().out
    state = ckpt.load_ir_state(ir_npz, device=CPU)
    assert tuple(state.sum.shape) == (2, 2048, 4)
    assert not torch.equal(state.sum[0], state.sum[1])
    assert _read_png(spectro).any()


@pytest.mark.parametrize("mode", [[], ["--legacy"], ["--stereo", "0.4"],
                                  ["--legacy", "--stereo", "0.4",
                                   "--no-normalize"]])
def test_cli_bake_writes_a_reverberant_wav(tmp_path, capsys, mode):
    dry, wet = str(tmp_path / "dry.wav"), str(tmp_path / "wet.wav")
    clicks = (0.05, 0.3)
    write_wav(dry, click_clip(0.5, 8000, click_times=clicks), 8000)
    cli.main(["bake", "--room", "smoll", *SMALL, "--in", dry, "--out", wet,
              *mode])
    said = capsys.readouterr().out
    assert "baked 4000 samples in" in said and f"-> {wet}" in said
    x, rate = read_wav(wet)
    stereo = "--stereo" in mode
    assert rate == 8000 and x.shape == ((4000 + 2048, 2) if stereo
                                        else (4000 + 2048,))
    assert np.isfinite(x).all() and np.abs(x).max() > 0
    if "--no-normalize" not in mode:
        assert np.abs(x).max() == pytest.approx(1.0, abs=1e-3)
    mono = x[:, 0] if stereo else x
    for t in clicks:      # nothing before the first arrival, a tail after it
        c = int(t * 8000)
        assert (mono[c + 400:c + 1600] ** 2).sum() > 0
    assert not mono[:400].any()


STREAM = ["stream", "--in", "a.wav", "--out", "b.wav"]


@pytest.mark.parametrize("cmd, said", [
    (["bench", "--rays", "8"], "unrecognized arguments: --rays 8")])
def test_cli_rejects_flags_that_are_not_ported(cmd, said, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.build_parser().parse_args(cmd)
    assert exc.value.code == 2
    assert said in capsys.readouterr().err


def test_cli_bench_parses_with_the_card_by_default():
    args = cli.build_parser().parse_args(["bench"])
    assert args.device == "cuda" and args.fn is cli.cmd_bench
    assert cli.build_parser().parse_args(
        ["bench", "--device", "cpu"]).device == "cpu"


def test_cli_sweep_sharded_equals_unsharded(tmp_path, capsys, monkeypatch):
    args = ["sweep", "--rooms", "8", "--rays", "128", "--bounces", "4",
            "--sample-rate", "8000", "--reverb", "0.256", "--frames", "2",
            "--seed", "5", "--device", CPU]
    paths = [str(tmp_path / f"{n}.npz") for n in ("plain", "one", "mesh")]
    cli.main([*args, "--out", paths[0]])
    cli.main([*args, "--out", paths[1], "--sharded"])   # one device
    # a host of several devices: the rooms split over a mesh of 8
    meshes = []

    def mesh8(dev):
        meshes.append(make_mesh((8, 1), devices=[CPU] * 8))
        return meshes[-1]

    monkeypatch.setattr(cli, "_sweep_mesh", mesh8)
    cli.main([*args, "--out", paths[2], "--sharded"])
    assert len(meshes) == 1
    said = capsys.readouterr().out
    assert said.count("swept 8 rooms in") == 3
    with np.load(paths[0]) as a:
        want = dict(a)
    for p in paths[1:]:
        with np.load(p) as b:
            for k in ("irs", "sources", "listeners"):
                np.testing.assert_array_equal(b[k], want[k], err_msg=k)
    monkeypatch.undo()
    assert cli._sweep_mesh(torch.device(CPU)) is None


def test_cli_bake_rejects_binaural_and_needs_a_clip(tmp_path, capsys):
    # --binaural and --head-radius parse; a bake without --in bakes the
    # bundled clip (assets/dry_clip.wav: 1 s at 48 kHz, read at 8 kHz)
    args = cli.build_parser().parse_args(
        ["bake", "--in", "a.wav", "--out", "b.wav", "--binaural", "30",
         "--head-radius", "0.1"])
    assert (args.binaural, args.head_radius) == (30.0, 0.1)
    assert cli.build_parser().parse_args(
        ["bake", "--in", "a.wav", "--out", "b.wav"]).head_radius == 0.0875
    for sub in (["bake"], ["stream"], ["live"]):
        assert cli.build_parser().parse_args(
            [*sub, "--out", "b.wav"]).infile is None
    cli.main(["bake", *SMALL, "--out", str(tmp_path / "clip.wav")])
    assert "baked 8000 samples" in capsys.readouterr().out
    x, rate = read_wav(str(tmp_path / "clip.wav"))
    assert rate == 8000 and x.shape == (8000 + 2048,)
    assert np.isfinite(x).all() and np.abs(x).max() > 0
    # and at run time the JAX CLI's three refusals
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, click_clip(0.1, 8000), 8000)
    for extra, said in ((["--legacy"], "not available with --legacy"),
                        (["--stereo", "0.2"], "replaces --stereo"),
                        (["--mic-directivity", "cardioid"],
                         "replaces --stereo")):
        with pytest.raises(SystemExit, match=said):
            cli.main(["bake", *SMALL, "--in", dry, "--out",
                      str(tmp_path / "w.wav"), "--binaural", "0", *extra])


def test_cli_trace_and_bake_flags_default_as_jax():
    ref = argparse.ArgumentParser()
    jax_cli._common(ref)
    ref = ref.parse_args([])
    for argv in (["trace"], ["bake", "--in", "a.wav", "--out", "b.wav"]):
        port = cli.build_parser().parse_args(argv)
        for flag in ("room", "rays", "bounces", "bands", "sample_rate",
                     "reverb", "frames", "seed", "stereo"):
            assert getattr(port, flag) == getattr(ref, flag), flag
        assert port.device == "cuda"
    port = cli.build_parser().parse_args(["trace"])
    assert (port.debug_rays, port.gain, port.out, port.ir_in) == (100, None,
                                                                  None, None)


@pytest.mark.parametrize("flag, attr, value", [
    (["--directivity", "cardioid:30"], "directivity", "cardioid:30"),
    (["--mic-directivity", "figure8"], "mic_directivity", "figure8"),
    (["--stereo-aim", "30"], "stereo_aim", 30.0),
    (["--diffraction"], "diffraction", True),
    (["--diffraction-order", "2"], "diffraction_order", 2),
    (["--air"], "air", True),
    (["--air-temp", "10"], "air_temp", 10.0),
    (["--air-humidity", "70"], "air_humidity", 70.0)])
def test_cli_parses_the_pattern_diffraction_and_air_flags(flag, attr, value):
    ref = argparse.ArgumentParser()
    jax_cli._common(ref)
    jax_cli._air_args(ref)
    want = ref.parse_args(flag)
    for cmd in (["trace"], ["bake", "--in", "a.wav", "--out", "b.wav"]):
        port = cli.build_parser().parse_args(cmd + flag)
        assert getattr(port, attr) == getattr(want, attr) == value
    default = cli.build_parser().parse_args(["trace"])
    assert getattr(default, attr) == getattr(ref.parse_args([]), attr)


def _said_numbers(said):
    import re
    energy = float(re.search(r"IR energy ([0-9.eE+-]+),", said).group(1))
    peak = int(re.search(r"peak bin (\d+)", said).group(1))
    lines = [ln for ln in said.splitlines()
             if ln.startswith(("diffraction:", "air absorption:"))]
    return energy, peak, lines


def test_cli_trace_with_patterns_diffraction_and_air_matches_jax(
        tmp_path, capsys, monkeypatch):
    import jax
    from realisticaudioraytracing2d_tpu.utils import checkpoint as jax_ckpt
    args = ["trace", "--room", "smoll", "--rays", "256", "--bounces", "4",
            "--sample-rate", "8000", "--reverb", "0.256", "--frames", "2",
            "--seed", "3", "--directivity", "cardioid:90", "--stereo", "0.2",
            "--stereo-aim", "45", "--diffraction", "--diffraction-order",
            "2", "--air"]
    jax_npz, port_npz = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jax_cli.main(args + ["--ir-out", jax_npz])
    want = _said_numbers(capsys.readouterr().out)
    # the port traces JAX's draws of that seed (fold_in(key, frame))
    emit, u = jax_frame_uniforms(jax.random.PRNGKey(3), 2, 4, 256)
    trace_frames = art.Engine.trace_frames
    monkeypatch.setattr(art.Engine, "trace_frames", lambda self, p, seed=0,
                        n_frames=1, state=None: trace_frames(
                            self, p, n_frames=n_frames, state=state,
                            uniforms=(emit, u)))
    cli.main(args + ["--device", CPU, "--ir-out", port_npz])
    got = _said_numbers(capsys.readouterr().out)
    assert got[2] == want[2] and len(got[2]) == 2
    assert got[1] == want[1]
    assert want[0] > 0 and abs(got[0] - want[0]) <= 1e-4 * want[0]
    raw = ckpt.load_ir_state(port_npz, device=CPU)
    raw_j = jax_ckpt.load_ir_state(jax_npz)
    assert raw.frames == int(raw_j.frames) == 2
    ref = np.asarray(raw_j.sum)
    assert ref.shape == (2, 2048, 1) and ref.sum() > 0
    np.testing.assert_allclose(raw.sum.numpy(), ref, rtol=1e-4,
                               atol=3e-5 * ref.max())


def test_cli_bake_stereo_xy_pair_and_air(tmp_path, capsys):
    dry, wet = str(tmp_path / "dry.wav"), str(tmp_path / "wet.wav")
    write_wav(dry, click_clip(0.5, 8000, click_times=(0.1,)), 8000)
    cli.main(["bake", *SMALL, "--in", dry, "--out", wet, "--stereo", "0.2",
              "--stereo-aim", "60", "--directivity", "figure8:45",
              "--diffraction", "--air"])
    said = capsys.readouterr().out
    assert "air absorption:" in said and "diffraction: added" in said
    x, rate = read_wav(wet)
    assert rate == 8000 and x.shape[1] == 2 and np.isfinite(x).all()
    assert not np.allclose(x[:, 0], x[:, 1])   # the pair aims apart
    # --legacy ignores diffraction and air, as in JAX
    cli.main(["bake", *SMALL, "--in", dry, "--out", wet, "--legacy",
              "--directivity", "cardioid", "--air"])
    assert "air absorption" not in capsys.readouterr().out
    with pytest.raises(SystemExit, match="needs --stereo"):
        cli.main(["bake", *SMALL, "--in", dry, "--out", wet, "--stereo-aim",
                  "30"])


def _jax_draws(monkeypatch, seed, n_frames, n_bounces, n_rays):
    """Make every port trace draw JAX's frame uniforms of ``seed``
    (``fold_in(key, frame)``), as the JAX CLI's traces do."""
    import jax
    from realisticaudioraytracing2d_tpu_torch import engine
    uniforms = jax_frame_uniforms(jax.random.PRNGKey(seed), n_frames,
                                  n_bounces, n_rays)
    traced = engine.trace_accumulate
    monkeypatch.setattr(engine, "trace_accumulate", lambda *a, **k:
                        traced(*a, **dict(k, uniforms=uniforms)))


def _arrival_rows(said):
    import re
    return [tuple(float(v) for v in m) for m in re.findall(
        r"arrival \d+: t=\s*([0-9.]+) ms\s+from\s+([-0-9.]+) deg\s+"
        r"diffuseness ([0-9.]+)\s+energy ([0-9.eE+-]+)", said)]


def test_cli_trace_spatial_out_matches_jax(tmp_path, capsys, monkeypatch):
    args = ["trace", "--room", "smoll", *SMALL[:-2]]
    jax_npz, port_npz = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jax_cli.main(args + ["--spatial-out", jax_npz])
    want_rows = _arrival_rows(capsys.readouterr().out)
    _jax_draws(monkeypatch, 3, 2, 4, 256)
    cli.main(args + ["--device", CPU, "--spatial-out", port_npz])
    said = capsys.readouterr().out
    assert f"wrote {port_npz}" in said
    got_rows = _arrival_rows(said)
    assert len(got_rows) == len(want_rows) == 5
    for g, w in zip(got_rows, want_rows):
        assert g[0] == w[0]                                   # ms
        assert abs(g[1] - w[1]) <= 0.2 and abs(g[2] - w[2]) <= 2e-3
        assert g[3] == pytest.approx(w[3], rel=1e-3)
    with np.load(port_npz) as got, np.load(jax_npz) as want:
        assert set(got.files) == set(want.files) == {
            "w", "x", "y", "arrival_angle", "diffuseness", "sample_rate"}
        assert int(got["sample_rate"]) == int(want["sample_rate"]) == 8000
        peak = float(want["w"].max())
        assert want["w"].shape == got["w"].shape == (1, 2048, 1) and peak > 0
        for k in ("w", "x", "y"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=3e-5 * peak, err_msg=k)
        # angles and diffuseness where a bin holds a clear direction
        r = np.hypot(want["x"], want["y"])
        clear = (want["w"] > 1e-2 * peak) & (r > 0.1 * want["w"])
        assert clear.sum() > 10
        np.testing.assert_allclose(got["arrival_angle"][clear],
                                   want["arrival_angle"][clear], atol=1e-2)
        np.testing.assert_allclose(got["diffuseness"][clear],
                                   want["diffuseness"][clear], atol=1e-2)
    with pytest.raises(SystemExit, match="replaces --mic-directivity"):
        cli.main(args + ["--device", CPU, "--mic-directivity", "cardioid",
                         "--spatial-out", port_npz])


def test_cli_bake_binaural_matches_jax(tmp_path, capsys, monkeypatch):
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, click_clip(0.5, 8000, click_times=(0.05, 0.3)), 8000)
    args = ["bake", "--room", "smoll", *SMALL[:-2], "--in", dry,
            "--binaural", "30", "--head-radius", "0.1", "--diffraction",
            "--air"]
    jax_wav, port_wav = str(tmp_path / "j.wav"), str(tmp_path / "p.wav")
    jax_cli.main(args + ["--out", jax_wav])
    capsys.readouterr()
    _jax_draws(monkeypatch, 3, 2, 4, 256)
    cli.main(args + ["--device", CPU, "--out", port_wav])
    said = capsys.readouterr().out
    assert "binaural bake (facing 30 deg, head 10.0 cm): 4000 samples" \
        in said and "diffraction: added" in said
    got, rate = read_wav(port_wav)
    want, rate_j = read_wav(jax_wav)
    assert rate == rate_j == 8000 and got.shape == want.shape == (
        4000 + 2048, 2)
    assert np.abs(got).max() == pytest.approx(1.0, abs=1e-3)
    assert not np.allclose(got[:, 0], got[:, 1])   # ITD and ILD
    np.testing.assert_allclose(got, want, atol=3 / 32767)


def test_cli_stream_binaural_head_turn(tmp_path, capsys):
    dry, out = str(tmp_path / "dry.wav"), str(tmp_path / "st.wav")
    write_wav(dry, click_clip(0.3, 8000, click_times=(0.05,)), 8000)
    cli.main(["stream", *SMALL, "--in", dry, "--out", out, "--binaural",
              "20", "--head-turn", "90", "--head-radius", "0.15",
              "--duration", "0.5", "--viz-every", "2", "--move-listener",
              "0.5,0"])
    said = capsys.readouterr().out
    assert "streamed 4000 samples in" in said and f"-> {out}" in said
    for i in (0, 2, 4):
        assert f"wrote {str(tmp_path / 'st')}_ir_{i:04d}.png" in said
        assert _read_png(str(tmp_path / f"st_ir_{i:04d}.png")).any()
    got, rate = read_wav(out)
    assert rate == 8000 and got.shape == (4000, 2) and np.abs(got).max() > 0
    assert not np.allclose(got[:, 0], got[:, 1])
    # what the library streams for the same seed, poses and facing
    room = rooms.smoll_room(device=CPU)
    cfg = art.smoll_room_config(ray_count=256)
    cfg = dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, max_bounces=4),
        audio=dataclasses.replace(cfg.audio, sample_rate=8000,
                                  reverb_duration=0.256))
    eng = art.Engine(room.scene, cfg)
    dt = cfg.audio.chunk_duration
    wet = art.Streamer(room.scene, cfg, seed=3, binaural=True,
                       head_radius=0.15).stream_clip(
        torch.as_tensor(click_clip(0.3, 8000, click_times=(0.05,))),
        lambda i: eng.params(room.source, room.listener + np.float32(
            [0.5 * i * dt, 0.0])), total_chunks=5,
        facing_fn=lambda i: float(np.radians(20.0))
        + float(np.radians(90.0)) * dt * i)
    lib = str(tmp_path / "lib.wav")
    write_wav(lib, wet.numpy().T, 8000)
    np.testing.assert_array_equal(got, read_wav(lib)[0])
    with pytest.raises(SystemExit, match="replaces --stereo"):
        cli.main(["stream", *SMALL, "--in", dry, "--out", out, "--binaural",
                  "0", "--stereo", "0.2"])


def test_cli_doppler_flags_conflict(capsys):
    # the two Doppler modes are different physics: argparse refuses both
    # at once (exit 2), before any work, as the JAX CLI does
    with pytest.raises(SystemExit) as exc:
        cli.main([*STREAM, "--doppler", "--doppler-per-arrival"])
    assert exc.value.code == 2
    assert "not allowed with" in capsys.readouterr().err


def test_cli_arrival_flags_in_help_and_default_as_jax(capsys):
    with pytest.raises(SystemExit):
        cli.main(["stream", "--help"])
    said = capsys.readouterr().out
    for flag in ("--doppler", "--doppler-per-arrival", "--arrival-taps",
                 "--arrival-window", "--arrival-match-bins"):
        assert flag in said
    port = cli.build_parser().parse_args(STREAM)
    ref = argparse.ArgumentParser()
    jax_cli._arrival_args(ref)
    ref = ref.parse_args([])
    for flag in ("arrival_taps", "arrival_window", "arrival_match_bins"):
        assert getattr(port, flag) == getattr(ref, flag), flag
    assert not port.doppler and not port.doppler_per_arrival
    assert cli._doppler_arg(cli.build_parser().parse_args(
        [*STREAM, "--doppler-per-arrival"])) == "per_arrival"
    assert cli._doppler_arg(cli.build_parser().parse_args(
        [*STREAM, "--doppler"])) is True


def _tiny_stream_config(**audio):
    cfg = art.smoll_room_config(ray_count=256)
    return dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, max_bounces=4),
        audio=dataclasses.replace(cfg.audio, sample_rate=8000,
                                  reverb_duration=0.256, **audio))


def test_cli_stream_doppler_per_arrival(tmp_path, capsys):
    # JAX's test's flags; the WAV is what the library streams for the same
    # seed, poses and knobs
    dry, out = str(tmp_path / "dry.wav"), str(tmp_path / "pa.wav")
    clip = noise_burst(0.2, 8000, seed=3)
    write_wav(dry, clip, 8000)
    cli.main(["stream", *SMALL, "--in", dry, "--out", out, "--move-source",
              "1,0", "--doppler-per-arrival", "--arrival-taps", "8",
              "--arrival-window", "0.08", "--arrival-match-bins", "48"])
    assert "streamed" in capsys.readouterr().out
    got, rate = read_wav(out)
    assert rate == 8000 and np.abs(got).max() > 0 and np.isfinite(got).all()
    room = rooms.smoll_room(device=CPU)
    cfg = _tiny_stream_config()
    eng = art.Engine(room.scene, cfg)
    dt = cfg.audio.chunk_duration
    streamer = art.Streamer(room.scene, cfg, seed=3, arrival_taps=8,
                            arrival_window_s=0.08, arrival_match_bins=48)
    wet = streamer.stream_clip(
        torch.as_tensor(read_wav(dry)[0]), lambda i: eng.params(
            room.source + np.float32([1.0 * i * dt, 0.0]), room.listener),
        loop=False, doppler="per_arrival")
    assert tuple(streamer.state.arrival.idx.shape) == (1, 8)
    lib = str(tmp_path / "lib.wav")
    write_wav(lib, wet.numpy()[0], 8000)
    np.testing.assert_array_equal(got, read_wav(lib)[0])


def test_cli_doppler_stream(tmp_path, capsys):
    # JAX's test: the warped dry feed changes the output
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, noise_burst(0.12, 8000, seed=3), 8000)
    a, b = str(tmp_path / "plain.wav"), str(tmp_path / "dopp.wav")
    common = ["stream", *SMALL, "--in", dry, "--move-source", "10,0"]
    cli.main([*common, "--out", a])
    cli.main([*common, "--out", b, "--doppler"])
    capsys.readouterr()
    ya, _ = read_wav(a)
    yb, _ = read_wav(b)
    assert ya.shape == yb.shape and np.abs(yb).max() > 0
    assert not np.allclose(ya, yb)


def test_cli_stream_and_analyze_flags_default_as_jax():
    args = cli.build_parser().parse_args(STREAM)
    assert (args.frames_per_chunk, args.duration, args.viz_every,
            args.binaural, args.head_turn, args.head_radius,
            args.move_listener, args.move_source, args.device) == (
        1, None, 0, None, 0.0, 0.0875, None, None, "cuda")
    args = cli.build_parser().parse_args(["analyze"])
    assert (args.ir_in, args.out, args.edc_out, args.speed_of_sound,
            args.room, args.frames) == (None, None, None, 343.0, "smoll", 8)
    assert cli.build_parser().parse_args(
        ["sweep", "--out", "x"]).metrics_out is None


def _report_close(got, want):
    assert got.keys() == want.keys() and len(got["listeners"]) == len(
        want["listeners"])
    for lg, lw in zip(got["listeners"], want["listeners"]):
        for bg, bw in zip(lg["bands"], lw["bands"]):
            assert bg.keys() == bw.keys()
            for m in bw:
                if bw[m] is None:
                    assert bg[m] is None, m
                else:
                    rel = 1e-3 if m in ("rt60_t20_s", "rt60_t30_s",
                                        "edt_s") else 1e-5
                    assert bg[m] == pytest.approx(bw[m], rel=rel,
                                                  abs=2e-6), m


def test_cli_analyze_matches_jax(tmp_path, capsys):
    import json
    ir_npz = str(tmp_path / "ir.npz")
    cli.main(["trace", *SMALL, "--stereo", "0.4", "--bands", "2",
              "--ir-out", ir_npz])
    capsys.readouterr()
    jax_json, port_json = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    edc = str(tmp_path / "edc.png")
    common = ["analyze", "--ir-in", ir_npz, "--sample-rate", "8000"]
    jax_cli.main(common + ["--out", jax_json])
    want_said = capsys.readouterr().out.splitlines()[-1]
    cli.main(common + ["--device", CPU, "--out", port_json, "--edc-out",
                       edc])
    said = capsys.readouterr().out
    assert f"wrote {port_json}" in said and f"wrote {edc}" in said
    assert said.splitlines()[-2].split(",")[0] == want_said.split(",")[0]
    got, want = (json.load(open(f)) for f in (port_json, jax_json))
    assert got["source"] == ir_npz and got["ir_length"] == 2048
    assert len(got["listeners"]) == 2 and len(got["listeners"][0][
        "bands"]) == 2
    _report_close(got, want)
    assert _read_png(edc).shape == (256, 1024, 3) and _read_png(edc).any()
    # without --ir-in: a fresh trace of the room, with air
    cli.main(["analyze", *SMALL, "--air"])
    said = capsys.readouterr().out
    assert "air absorption:" in said and "listener 0 band 0: RT60" in said
    assert json.loads(said[said.index("{"):said.rindex("}") + 1])[
        "source"] == "traced smoll (2 frames x 256 rays)"


def test_cli_sweep_metrics_out(tmp_path, capsys):
    from realisticaudioraytracing2d_tpu import analysis as jan
    from realisticaudioraytracing2d_tpu_torch import analysis as an
    out, metrics = str(tmp_path / "irs.npz"), str(tmp_path / "m.npz")
    cli.main(["sweep", "--rooms", "3", "--rays", "128", "--bounces", "4",
              "--sample-rate", "8000", "--reverb", "0.256", "--frames", "2",
              "--seed", "5", "--out", out, "--metrics-out", metrics,
              "--device", CPU])
    said = capsys.readouterr().out
    assert f"metrics -> {metrics}; RT60(T20) median" in said
    with np.load(out) as npz:
        irs = npz["irs"]
    want = an.analyze_dataset(irs, 8000, device=CPU)
    ref = jan.analyze_dataset(irs, 8000)
    with np.load(metrics) as got:
        assert set(got.files) == set(want) == set(ref)
        for k in want:
            assert got[k].shape == (3, 1, 1)
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(ref[k]))
            ok = np.isfinite(ref[k])
            np.testing.assert_allclose(got[k][ok], ref[k][ok], rtol=1e-3,
                                       atol=1e-6, err_msg=k)


# ---- live, the pose feed, --scene-json, the bundled clip and mp3 ----------


@pytest.mark.parametrize("mode", [[], ["--binaural", "0",
                                       "--doppler-per-arrival",
                                       "--move-source", "2,0"]])
def test_cli_live_writes_what_stream_streams(tmp_path, capsys, mode):
    # integrity mode (no --realtime): what the audio thread heard is the
    # stream of the same seed, sample for sample
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, noise_burst(0.25, 8000, seed=3), 8000)
    live, stream = str(tmp_path / "live.wav"), str(tmp_path / "stream.wav")
    cli.main(["live", *SMALL, "--in", dry, "--out", live, "--duration",
              "0.5", *mode])
    said = capsys.readouterr().out
    assert said.startswith("live: 5 chunks") and "(0 underruns)" in said
    cli.main(["stream", *SMALL, "--in", dry, "--out", stream, "--duration",
              "0.5", *mode])
    x, rate = read_wav(live)
    y, _ = read_wav(stream)
    assert rate == 8000 and x.shape == y.shape == (
        (4000, 2) if mode else (4000,))
    assert np.abs(x).max() > 0
    np.testing.assert_array_equal(x, y)


def test_cli_band_split_reaches_the_streamer_and_the_player(
        tmp_path, capsys, monkeypatch):
    """``--band-split`` goes to ``Streamer`` and ``LivePlayer`` (linear by
    default); live writes what stream writes with it, the octave split
    another stream than the linear one, and an unknown split is
    refused at parse time."""
    from realisticaudioraytracing2d_tpu_torch import streaming
    seen = []
    orig = streaming._StreamSettings.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        seen.append((type(self).__name__, self.band_split))
    monkeypatch.setattr(streaming._StreamSettings, "__init__", init)
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, noise_burst(0.25, 8000, seed=3), 8000)
    flags = [*SMALL, "--room", "sample", "--bands", "8", "--diffraction",
             "--diffraction-order", "2", "--air", "--in", dry,
             "--duration", "0.3"]
    out = {}
    for cmd, split in (("stream", "octave"), ("live", "octave"),
                       ("stream", None)):
        path = str(tmp_path / f"{cmd}_{split}.wav")
        cli.main([cmd, *flags, "--out", path]
                 + (["--band-split", split] if split else []))
        out[cmd, split] = read_wav(path)[0]
    capsys.readouterr()
    assert seen == [("Streamer", "octave"), ("LivePlayer", "octave"),
                    ("Streamer", "linear")]
    assert np.abs(out["stream", "octave"]).max() > 0
    np.testing.assert_array_equal(out["stream", "octave"],
                                  out["live", "octave"])
    assert not np.allclose(out["stream", "octave"], out["stream", None])
    for cmd in ("stream", "live"):
        assert cli.build_parser().parse_args(
            [cmd, "--out", "x"]).band_split == "linear"
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args([cmd, "--out", "x",
                                           "--band-split", "cubic"])
    assert "invalid choice: 'cubic'" in capsys.readouterr().err


def test_cli_live_flags_default_as_jax():
    args = cli.build_parser().parse_args(["live"])
    assert (args.infile, args.out, args.duration, args.frames_per_chunk,
            args.dsp_buffer, args.realtime, args.play, args.play_device,
            args.viz_every, args.pose_feed, args.binaural, args.head_turn,
            args.head_radius, args.doppler, args.doppler_per_arrival,
            args.arrival_taps, args.device) == (
        None, None, 2.0, 1, 1024, False, False, "default", 0, None, None,
        0.0, 0.0875, False, False, 6, "cuda")
    assert cli.build_parser().parse_args(STREAM).pose_feed is None


def _scene_spec():
    return {
        "n_bands": 2,
        "source": [-3.0, 1.0],
        "listeners": [[2.0, -1.0], [2.5, 1.5]],
        "listener_radius": 0.4,
        "directivity": "cardioid:30",
        "mic_directivity": ["figure8:90", "cardioid"],
        "colliders": [
            {"name": "Border", "type": "box", "position": [0, 0],
             "size": [12, 8],
             "material": {"absorption": 0.2, "scattering": 0.3}},
            {"name": "Pillar ☃", "type": "circle", "position": [0.5, 0.2],
             "radius": 0.6, "resolution": 12,
             "material": {"band_absorption": [0.1, 0.4],
                          "transmission": 0.2, "ior": 1.3}},
            {"type": "polygon", "position": [-1.0, -2.0], "angle": 0.4,
             "paths": [[[0, 0], [1, 0], [0.5, 0.8]]]}],
        "boxes": [{"name": "Crate", "position": [3.0, 2.0],
                   "angle": 0.3, "scale": [1.5, 0.5]}],
    }


def test_cli_scene_json_matches_jax_and_steers_by_name(tmp_path, capsys):
    spec = _scene_spec()
    room = cli.load_scene_json(spec, device=CPU)
    want = jax_cli.load_scene_json(spec)
    for f in want.scene._fields:
        np.testing.assert_array_equal(getattr(room.scene, f).numpy(),
                                      np.asarray(getattr(want.scene, f)))
    for f in ("source", "listener", "directivity", "mic_directivity"):
        np.testing.assert_array_equal(getattr(room, f), getattr(want, f))
    assert room.listener_radius == want.listener_radius
    # the port's loader also names the colliders for the pose feed
    assert [c.name for c in room.builder.colliders] == [
        "Border", "Pillar ☃", None, "Crate"]
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(spec, ensure_ascii=False))
    feed = tmp_path / "feed.jsonl"
    feed.write_text(json.dumps({"chunk": 1, "obstacle": "Crate",
                                "position": [3.0, -2.0]}) + "\n")
    cli.main(["stream", *SMALL, "--scene-json", str(path), "--out",
              str(tmp_path / "s.wav"), "--duration", "0.3",
              "--pose-feed", str(feed)])
    x, _ = read_wav(str(tmp_path / "s.wav"))
    assert x.shape == (2400, 2) and np.abs(x).max() > 0
    cli.main(["trace", *SMALL, "--scene-json", str(path)])
    assert "traced 2 frames x 256 rays" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no colliders"):
        cli.load_scene_json({"source": [0, 0], "listener": [1, 1]})


def test_cli_mp3_in_and_out(tmp_path, capsys):
    from realisticaudioraytracing2d_tpu_torch import native
    if not all(native.mp3_probe()):
        pytest.skip("system mp3 codecs (libmpg123/libmp3lame) not available")
    dry = str(tmp_path / "dry.mp3")
    native.encode_mp3(dry, noise_burst(0.5, 8000, seed=3), 8000, kbps=64)
    cli.main(["bake", *SMALL, "--in", dry, "--out", str(tmp_path / "w.mp3")])
    x, rate = native.decode_mp3(str(tmp_path / "w.mp3"))
    assert rate == 8000 and x.ndim == 1 and len(x) >= 4000 + 2048
    assert np.isfinite(x).all() and np.abs(x).max() > 0.1


# -- fit and locate ----------------------------------------------------------

FIT_KEYS = {"loss", "steps", "loss_start", "loss_end", "fields", "groups"}
GROUP_KEYS = {"group", "n_walls", "first_wall", "absorption", "scattering",
              "transmission", "ior"}
LOCATE_KEYS = {"position", "loss", "configured_source", "starts"}


@pytest.mark.parametrize("sub", ["fit", "locate"])
def test_cli_fit_and_locate_parse_with_jax_defaults(sub, monkeypatch):
    """``fit`` and ``locate`` take the JAX CLI's flags with its defaults,
    plus ``--device`` (the card by default)."""
    argv = [sub, "--target", "t.npz", "--out", "r.json"]
    parsed = {}
    monkeypatch.setattr(jax_cli, f"cmd_{sub}",
                        lambda args: parsed.update(vars(args)))
    jax_cli.main(argv)     # its parser, with the command replaced
    want = dict(parsed)
    got = vars(cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    got.pop("fn"), want.pop("fn")
    assert got == want


def _fit_target(tmp_path):
    """A small SmollRoom target through the port's ``trace --ir-out``."""
    target = str(tmp_path / "target.npz")
    cli.main(["trace", "--room", "smoll", *SMALL, "--ir-out", target])
    return target


def _record(monkeypatch, name, uniforms_fn):
    """Wrap ``diff.<name>`` so the CLI's call takes JAX's draws; keep its
    arguments and result."""
    from realisticaudioraytracing2d_tpu_torch import diff
    fn, seen = getattr(diff, name), {}

    def wrapped(*a, **k):
        seen.update(args=a, kwargs=k)
        seen["result"] = fn(*a, **dict(k, uniforms_fn=uniforms_fn))
        return seen["result"]

    monkeypatch.setattr(diff, name, wrapped)
    return fn, seen


def _jax_sim_draws(seed, n_rays, n_bounces):
    """The draws of JAX's ``simulate_ir(PRNGKey(seed))`` at one frame."""
    import jax

    from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
    emit, u = jax_rng.bounce_uniforms(jax.random.PRNGKey(seed), n_bounces,
                                      n_rays)
    return (torch.from_numpy(np.array(emit))[None],
            torch.from_numpy(np.array(u))[None])


def test_cli_fit_writes_jax_report(tmp_path, capsys, monkeypatch):
    """``cli fit`` on a target from the port's ``trace --ir-out`` writes
    the JAX CLI's JSON keys, and, fed JAX's draws, reports exactly what
    ``diff.fit_materials`` returns for the same arguments."""
    from realisticaudioraytracing2d_tpu_torch import diff
    target = _fit_target(tmp_path)
    capsys.readouterr()
    draws = _jax_sim_draws(3, 128, 4)
    fit, seen = _record(monkeypatch, "fit_materials", lambda i, j: draws)
    out = str(tmp_path / "fit.json")
    cli.main(["fit", "--room", "smoll", *SMALL, "--target", target,
              "--out", out, "--steps", "3", "--fit-rays", "128"])
    said = capsys.readouterr().out
    assert "material groups in" in said and "(3 steps)" in said \
        and f"-> {out}" in said
    report = json.load(open(out))
    assert set(report) == FIT_KEYS and report["steps"] == 3
    assert report["loss"] == "edc+mse"
    assert report["fields"] == ["absorption", "scattering"]
    assert report["groups"] and all(set(g) == GROUP_KEYS
                                    for g in report["groups"])
    kw = seen["kwargs"]
    assert (kw["n_rays"], kw["max_bounces"], kw["sample_rate"], kw["frames"],
            kw["loss"], kw["steps"], kw["lr"], kw["soft"]) == (
        128, 4, 8000, 1, "edc+mse", 3, 0.08, False)
    room = rooms.smoll_room(device=CPU)
    state = ckpt.load_ir_state(target, device=CPU)
    p = art.Engine(room.scene, cli._config(cli.build_parser().parse_args(
        ["fit", *SMALL, "--target", target, "--out", out]))).params(
            room.source, room.listener)
    again = fit(room.scene, p, state.normalized(), 3, n_rays=128,
                max_bounces=4, sample_rate=8000, steps=3, lr=0.08,
                loss="edc+mse", uniforms_fn=lambda i, j: draws, device=CPU)
    assert torch.equal(again.losses, seen["result"].losses)
    losses = again.losses.numpy().astype(np.float64)
    assert report["loss_start"] == float(losses[:5].mean())
    absorption = again.params.constrained()[0].numpy()
    for g in report["groups"]:
        assert g["absorption"] == [round(float(a), 4)
                                   for a in absorption[g["group"]]]
    groups, _ = diff.infer_material_groups(room.scene)
    assert [g["group"] for g in report["groups"]] == sorted(set(
        groups[room.scene.mask.numpy()].tolist()))


def test_cli_locate_writes_jax_report(tmp_path, capsys, monkeypatch):
    """``cli locate``: the JAX CLI's JSON keys, and, fed JAX's draws,
    exactly what ``diff.localize_source`` returns for the same
    arguments."""
    target = _fit_target(tmp_path)
    capsys.readouterr()
    draws = _jax_sim_draws(3, 128, 4)
    locate, seen = _record(monkeypatch, "localize_source",
                           lambda i, j: draws)
    out = str(tmp_path / "loc.json")
    cli.main(["locate", "--room", "smoll", *SMALL, "--target", target,
              "--out", out, "--starts", "3", "--steps", "2",
              "--fit-rays", "128", "--bounds=-2,-1,2,1"])
    said = capsys.readouterr().out
    assert "located source at (" in said and "3 starts x 2 steps" in said
    report = json.load(open(out))
    assert set(report) == LOCATE_KEYS and len(report["starts"]) == 3
    assert all(set(s) == {"position", "loss"} for s in report["starts"])
    room = rooms.smoll_room(device=CPU)
    assert report["configured_source"] == [round(float(v), 4)
                                           for v in room.source]
    res = seen["result"]
    kw = seen["kwargs"]
    assert (kw["n_rays"], kw["max_bounces"], kw["n_starts"], kw["steps"],
            kw["lr"], kw["n_sources"]) == (128, 4, 3, 2, 0.08, 1)
    np.testing.assert_array_equal(kw["bounds"], [[-2, -1], [2, 1]])
    state = ckpt.load_ir_state(target, device=CPU)
    again = locate(seen["args"][0], seen["args"][1], state.normalized(), 3,
                   n_rays=128, max_bounces=4, sample_rate=8000, n_starts=3,
                   steps=2, lr=0.08, bounds=kw["bounds"],
                   uniforms_fn=lambda i, j: draws, device=CPU)
    assert torch.equal(again.positions, res.positions)
    assert torch.equal(again.losses, res.losses)
    assert report["position"] == [round(float(v), 4) for v in again.position]
    assert report["loss"] == round(float(again.loss), 6)


@pytest.mark.parametrize("sub", ["fit", "locate"])
def test_cli_fit_and_locate_refuse_mismatched_targets(tmp_path, sub):
    """A target of another listener or band count exits with the JAX
    CLI's messages before any fit."""
    target = _fit_target(tmp_path)
    base = [sub, "--room", "smoll", *SMALL, "--target", target, "--out",
            str(tmp_path / "r.json"), "--steps", "1"]
    with pytest.raises(SystemExit, match="1 listeners; this setup has 2"):
        cli.main(base + ["--stereo", "0.2"])
    with pytest.raises(SystemExit, match="1 bands; scene has 2"):
        cli.main(base + ["--bands", "2"])
