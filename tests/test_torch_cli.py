"""PyTorch port: the command line's ``trace``, ``bake`` and ``sweep``
subcommands on the CPU.

``--device cpu`` runs the plain versions. The sweep's npz must hold
exactly what :func:`sweep_rooms` returns for the same arguments; ``trace``
must write its images and a checkpoint that ``--ir-in`` resumes (the frame
count continues), holding exactly the engine's IR; ``bake`` and ``bake
--legacy`` must write a WAV with a reverb tail after each click. The flags
default as the JAX CLI's do, and the JAX flags whose modules are not
ported are rejected by argparse."""

import argparse
import dataclasses
import struct
import zlib

import numpy as np
import pytest
import torch
from torch_parity import CPU

import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu import cli as jax_cli
from realisticaudioraytracing2d_tpu_torch import cli
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.parallel.sweep import sweep_rooms
from realisticaudioraytracing2d_tpu_torch.utils import checkpoint as ckpt
from realisticaudioraytracing2d_tpu_torch.utils.audio_io import (click_clip,
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


@pytest.mark.parametrize("flag", [
    ["--scene-json", "x.json"], ["--directivity", "cardioid"],
    ["--mic-directivity", "cardioid"], ["--stereo-aim", "30"],
    ["--diffraction"], ["--diffraction-order", "2"], ["--air"],
    ["--air-temp", "10"], ["--spatial-out", "x.npz"]])
def test_cli_rejects_flags_that_are_not_ported(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.build_parser().parse_args(["trace", *flag])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_cli_bake_rejects_binaural_and_needs_a_clip(capsys):
    for argv in (["bake", "--in", "a.wav", "--out", "b.wav", "--binaural",
                  "0"], ["bake", "--out", "b.wav"],
                 ["bake", "--in", "a.wav", "--out", "b.wav", "--head-radius",
                  "0.1"]):
        with pytest.raises(SystemExit) as exc:
            cli.build_parser().parse_args(argv)
        assert exc.value.code == 2
    capsys.readouterr()


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
