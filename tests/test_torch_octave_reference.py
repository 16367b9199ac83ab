"""PyTorch port: the banded stream's physics addenda and the octave band
split, against the benchmark's plain reference
(``benchmark/reference/addenda.py``) on the CPU, on SampleScene in 8
octave bands (the ``samplescene_octave`` configuration at small sizes).

* ``diffraction_ir`` of orders 1 and 2 at a pose the top wall shadows and
  at a lit one: zero where lit; in the shadow the same bins as the
  reference's paths, energies within rtol 1e-5 (float32 against float64
  arithmetic on the same float32 lengths), and order 2 adds bins that
  order 1 lacks;
* the air: ``iso9613_alpha`` at the 8 octave centres against the
  reference's ISO 9613-1 within 1e-12, the stream's float32 curve within
  1.5e-5 (its float32 exponent, up to 25 at 16 kHz over 2 s, rounds by a
  few 1e-6 absolute, which ``10^x`` scales by ``ln 10``);
* the octave masks: every bin in exactly one band, band k's edges at
  ``f_k 2^(-1/2)`` and ``f_k 2^(1/2)``, the reference's masks; a flat
  banded IR crossfades as the mono IR in both splits; every banded
  convolution of a plain and of a per-arrival chunk takes the stream's
  split;
* a few ``Streamer`` chunks at 256 rays with the octave split, order-2
  diffraction and air, walking from the shadow into the light: each output
  chunk within 1e-5 of its peak of the reference's, each chunk's IR within
  1e-5 of each band's L1.

The JAX parity tests of the linear split (``test_torch_bands.py``,
``test_torch_convolve.py``) are this split's own."""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import CPU

import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import streaming
from realisticaudioraytracing2d_tpu_torch.ops import air
from realisticaudioraytracing2d_tpu_torch.ops import convolve as cv
from realisticaudioraytracing2d_tpu_torch.ops import diffraction as dfr

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.reference import addenda, philox, physics  # noqa: E402

CONFIG = json.loads((REPO / "benchmark" / "configs"
                     / "samplescene_octave.json").read_text())
CENTRES = CONFIG["band_centres_hz"]
SR, T = 8000, 2000                   # 8 kHz, a 0.25 s IR
SHADOW = np.array([18.5, 18.12], np.float32)   # the top of the walk
LIT = np.array([18.5, 10.12], np.float32)      # its bottom


@pytest.fixture(scope="module")
def room():
    return art.rooms.sample_scene(n_bands=8, device=CPU)


def _reference(dtype=torch.float32):
    return addenda.Addenda(addenda.band_walls(CONFIG), CENTRES, speed=343.0,
                           gain=1.0, sample_rate=SR, ir_length=T,
                           dtype=dtype, acc_dtype=torch.float64, device=CPU)


def _params(room, listener):
    cfg = art.sample_scene_config(n_bands=8)
    return art.Engine(room.scene, cfg).params(room.source, listener)


def test_the_reference_reads_the_shipped_scene(room):
    walls = addenda.band_walls(CONFIG)
    w = room.scene.mask.sum()
    np.testing.assert_array_equal(walls.a, room.scene.a[:w].numpy())
    np.testing.assert_array_equal(walls.b, room.scene.b[:w].numpy())
    np.testing.assert_array_equal(walls.absorption,
                                  room.scene.absorption[:w].numpy())
    np.testing.assert_array_equal(CONFIG["scene"]["source"],
                                  room.source.astype(np.float64).round(6))


@pytest.mark.parametrize("listener,shadowed", [(SHADOW, True),
                                               (LIT, False)],
                         ids=["shadow", "lit"])
def test_diffraction_ir_matches_the_reference(room, listener, shadowed):
    ref = _reference()
    assert ref.blocked(room.source, listener) == shadowed
    irs = {}
    for order in (1, 2):
        got = dfr.diffraction_ir(room.scene, _params(room, listener),
                                 sample_rate=SR, ir_length=T, order=order)
        assert got.shape == (1, T, 8)
        irs[order] = got[0].double()
    want, _ = ref.ir(room.source, listener)
    if not shadowed:
        assert not irs[1].any() and not irs[2].any() and not want.any()
        return
    np.testing.assert_array_equal((irs[2] > 0).numpy(), (want > 0).numpy())
    np.testing.assert_allclose(irs[2].numpy(), want.numpy(), rtol=1e-5,
                               atol=0)
    only2 = (irs[2].sum(-1) > 0) & (irs[1].sum(-1) == 0)
    assert int(only2.sum()) > 0
    assert float(irs[1].sum()) > 0


def test_air_at_the_octave_centres_matches_iso_9613_1():
    freqs = air.band_frequencies(8)
    np.testing.assert_allclose(freqs, CENTRES, rtol=1e-14)
    got = air.iso9613_alpha(freqs, 20.0, 50.0, 101.325)
    want = addenda.air_alpha(CENTRES, 20.0, 50.0, 101.325)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # 1 kHz: 4.66 dB/km at 20 C, 50% RH (ISO 9613-1 table 1: 4.7)
    assert got[3] == pytest.approx(4.66e-3, rel=2e-3)
    alpha = torch.tensor(got, dtype=torch.float32)
    curve = air.air_attenuation_curve(88200, 44100, alpha, 343.0,
                                      reciprocal=True)
    ref = addenda.air_curve(88200, 44100, want, 343.0, torch.float64, CPU)
    np.testing.assert_allclose(curve.double().numpy(), ref.numpy(),
                               rtol=1.5e-5, atol=1e-37)


@pytest.mark.parametrize("n_fft,sr", [(131072, 44100), (8192, 8000),
                                      (4096, 48000)])
def test_octave_masks_partition_the_bins_at_the_band_edges(n_fft, sr):
    masks = cv.octave_filterbank(8, n_fft, sr)
    assert masks.shape == (8, n_fft // 2 + 1)
    assert torch.equal(masks.sum(0), torch.ones(n_fft // 2 + 1))
    freqs = np.arange(n_fft // 2 + 1) * sr / n_fft
    band = masks.argmax(0).numpy()
    lo = np.asarray(CENTRES) * 2 ** -0.5
    hi = np.asarray(CENTRES) * 2 ** 0.5
    for k in range(8):
        f = freqs[band == k]
        if f.size:
            assert k == 0 or f.min() >= lo[k] * (1 - 1e-12)
            assert k == 7 or f.max() < hi[k] * (1 + 1e-12)
    assert band[0] == 0
    assert band[-1] == max(k for k in range(8)
                           if k == 0 or lo[k] <= freqs[-1])
    for k in range(1, 8):
        below = freqs < lo[k] * (1 - 1e-9)
        assert (band[below] < k).all()
    np.testing.assert_array_equal(
        masks.numpy(), addenda.band_masks(CENTRES, n_fft, sr, torch.float32,
                                          CPU).numpy())
    got = cv.split_masks(8, n_fft, torch.device("cpu"), "octave", sr)
    assert got is cv.split_masks(8, n_fft, torch.device("cpu"), "octave", sr)
    assert torch.equal(got, masks)


def test_unknown_and_unrated_splits_are_refused():
    with pytest.raises(ValueError, match="band split"):
        cv.split_masks(8, 512, torch.device("cpu"), "cubic", 8000)
    with pytest.raises(ValueError, match="sample rate"):
        cv.split_masks(8, 512, torch.device("cpu"), "octave")
    room = art.rooms.sample_scene(n_bands=8, device=CPU)
    with pytest.raises(ValueError, match="band_split"):
        art.Streamer(room.scene, art.sample_scene_config(n_bands=8),
                     band_split="third-octave")


@pytest.mark.parametrize("split", ["linear", "octave"])
def test_a_flat_banded_ir_crossfades_as_the_mono_ir(split):
    rng = np.random.default_rng(4)
    chunk = torch.as_tensor(rng.uniform(-1, 1, 800).astype(np.float32))
    prev = torch.as_tensor(rng.uniform(0, 1e-3, (1, T, 1)
                                       ).astype(np.float32))
    cur = torch.as_tensor(rng.uniform(0, 1e-3, (1, T, 1)
                                      ).astype(np.float32))
    mono = streaming._crossfaded_wet(chunk, prev, cur)
    banded = streaming._crossfaded_wet(chunk, prev.expand(1, T, 8),
                                       cur.expand(1, T, 8), split, SR)
    np.testing.assert_allclose(banded.numpy(), mono.numpy(), rtol=0,
                               atol=2e-6 * float(mono.abs().max()))


def test_octave_streamer_chunks_match_the_reference(room):
    """Five chunks at 256 rays x 4 bounces, 8 kHz, 0.1 s chunks and a
    0.25 s IR, the listener stepping from the top of the walk (in the top
    wall's shadow) down its left side into the light."""
    cfg = art.sample_scene_config(n_bands=8, ray_count=256)
    cfg = dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, max_bounces=4),
        audio=dataclasses.replace(cfg.audio, sample_rate=SR,
                                  reverb_duration=T / SR,
                                  chunk_duration=0.1))
    n, seed = cfg.audio.chunk_samples, 2 ** 31 + 27
    alpha = addenda.air_alpha(CENTRES, 20.0, 50.0, 101.325)
    st = art.Streamer(room.scene, cfg, seed=seed, diffraction=2,
                      air_alpha=torch.tensor(air.iso9613_alpha(
                          air.band_frequencies(8)), dtype=torch.float32),
                      band_split="octave")
    eng = art.Engine(room.scene, cfg)
    poses = [np.array([18.5 + 4 * math.cos(a), 14.12 + 4 * math.sin(a)],
                      np.float32)
             for a in np.linspace(math.pi / 2, 1.4 * math.pi, 5)]
    dry = torch.as_tensor(np.random.default_rng(9).uniform(
        -0.5, 0.5, 5 * n).astype(np.float32))
    ref = _reference()
    assert ref.blocked(room.source, poses[0])
    assert not ref.blocked(room.source, poses[-1])
    outs, irs = [], []
    for i, pose in enumerate(poses):
        outs.append(st.process(dry[i * n:(i + 1) * n],
                               eng.params(room.source, pose))[0].clone())
        irs.append(st.state.prev_ir[0].clone())

    tab = physics.tables([addenda.band_walls(CONFIG)], torch.float32, CPU)
    want_irs = [addenda.chunk_ir(tab, ref, room.source, pose,
                                 philox.mix_seed(seed, k), n_rays=256,
                                 n_bounces=4, radius=0.5, alpha=alpha,
                                 dtype=torch.float32,
                                 acc_dtype=torch.float64)[0]
                for k, pose in enumerate(poses)]

    def masks_of(n_fft):
        return addenda.band_masks(CENTRES, n_fft, SR, torch.float64, CPU)

    for k, (got, want) in enumerate(zip(irs, want_irs)):
        l1 = want.abs().sum(0)
        assert (l1 > 0).all()
        gap = ((got.double() - want).abs().sum(0) / l1).max()
        assert float(gap) < 1e-5, k
    for j in range(5):
        want = addenda.output_chunk(
            j, n, T, lambda k: dry[k * n:(k + 1) * n].double(),
            lambda k: want_irs[k], masks_of)[0]
        gap = (outs[j].double() - want).abs().max() / want.abs().max()
        assert float(gap) < 1e-5, j


@pytest.mark.parametrize("split", ["linear", "octave"])
def test_every_banded_convolution_of_a_chunk_takes_the_split(
        room, monkeypatch, split):
    """A banded per-arrival chunk's masks (the taps' band-split dry and
    the residual's crossfade) and a plain banded chunk's all come in the
    stream's split, at the stream's sample rate."""
    cfg = art.sample_scene_config(n_bands=8, ray_count=64)
    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, sample_rate=SR,
                                       reverb_duration=T / SR))
    seen = []
    orig = cv.split_masks

    def masks(k, n_fft, device, split="linear", sample_rate=None):
        seen.append((split, sample_rate))
        return orig(k, n_fft, device, split, sample_rate)
    monkeypatch.setattr(cv, "split_masks", masks)
    params = _params(room, SHADOW)
    n = cfg.audio.chunk_samples
    dry = torch.rand(4 * n, generator=torch.Generator().manual_seed(1)) - .5
    for per_arrival in (False, True):
        st = art.Streamer(room.scene, cfg, seed=5, band_split=split)
        wd = n + st.arrival_early + 2
        for i in range(2):
            window = (dry, *streaming.window_scalars(
                i, n, wd, dry.shape[-1], True, None), True) \
                if per_arrival else None
            st.process(dry[i * n:(i + 1) * n], params, window=window)
    assert len(seen) == 2 * 2 + 2 * 3 and set(seen) == {(split, SR)}
