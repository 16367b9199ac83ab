"""PyTorch port: the command line's ``sweep`` subcommand on the CPU.

``--device cpu`` runs the plain version; the npz it writes must hold
exactly what :func:`sweep_rooms` returns for the same arguments, and its
flags default as the JAX CLI's do."""

import argparse

import numpy as np
import torch
from torch_parity import CPU

from realisticaudioraytracing2d_tpu import cli as jax_cli
from realisticaudioraytracing2d_tpu_torch import cli
from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.parallel.sweep import sweep_rooms


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
