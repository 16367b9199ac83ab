"""PyTorch port: every ported convolution function vs JAX, same inputs
(numpy, seeded), rtol 1e-5.

Elementwise functions (gate, resample, normalize, downmix) must agree to
1e-6. FFT results carry each FFT library's float32 rounding, which is
absolute (relative to the signal's peak) rather than relative per
sample, so those comparisons add ``atol = 1e-5 * max|reference|``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_numpy, to_torch

from realisticaudioraytracing2d_tpu.ops import convolve as jcv
from realisticaudioraytracing2d_tpu_torch import streaming
from realisticaudioraytracing2d_tpu_torch.ops import convolve as cv


def _fft_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture
def signals(rng):
    x = rng.uniform(-1, 1, 300).astype(np.float32)
    x[::7] = 5e-5                                   # below the input gate
    ir = rng.uniform(-0.2, 0.5, 150).astype(np.float32)
    return x, ir


def test_gate_direct_and_fft_match_jax(signals):
    x, ir = signals
    np.testing.assert_array_equal(to_numpy(cv.gate_input(to_torch(x))),
                                  np.asarray(jcv.gate_input(jnp.asarray(x))))
    for gate in (1e-4, None):
        _fft_close(cv.convolve_direct(to_torch(x), to_torch(ir), 3, gate),
                   jcv.convolve_direct(jnp.asarray(x), jnp.asarray(ir), 3,
                                       gate))
        _fft_close(cv.convolve_fft(to_torch(x), to_torch(ir), 3, gate),
                   jcv.convolve_fft(jnp.asarray(x), jnp.asarray(ir), 3, gate))
    assert cv.convolve_direct(to_torch(x), to_torch(ir)).shape == (450,)


def test_chunk_crossfade_matches_jax(rng):
    chunk = rng.uniform(-1, 1, 64).astype(np.float32)
    ir_a = rng.uniform(0, 1, 200).astype(np.float32)
    ir_b = rng.uniform(0, 1, 200).astype(np.float32)
    _fft_close(cv.convolve_chunk_crossfade(to_torch(chunk), to_torch(ir_a),
                                           to_torch(ir_b), 2, 5),
               jcv.convolve_chunk_crossfade(jnp.asarray(chunk),
                                            jnp.asarray(ir_a),
                                            jnp.asarray(ir_b), 2, 5))


@pytest.mark.parametrize("shape", [(150,), (150, 1), (150, 4), (2, 150, 4)])
def test_apply_ir_and_combined_transfer_match_jax(rng, shape):
    x = rng.uniform(-1, 1, 200).astype(np.float32)
    ir = rng.uniform(0, 0.5, shape).astype(np.float32)
    _fft_close(cv.apply_ir(to_torch(x), to_torch(ir), 2),
               jcv.apply_ir(jnp.asarray(x), jnp.asarray(ir), 2))
    if len(shape) > 1:
        h = cv.combined_transfer(to_torch(ir), 512)
        jh = jcv.combined_transfer(jnp.asarray(ir), 512)
        np.testing.assert_allclose(to_numpy(h.real), np.asarray(jh.real),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(to_numpy(h.imag), np.asarray(jh.imag),
                                   rtol=1e-5, atol=1e-4)


def test_band_filterbank_equals_jax():
    for k in (1, 3, 8):
        np.testing.assert_array_equal(
            to_numpy(cv.band_filterbank(100, k, 256)),
            np.asarray(jcv.band_filterbank(100, k, 256)))


def test_banded_calls_share_one_mask_per_key(rng):
    # combined_transfer, convolve_banded and the stream's band windows
    # read one [K, F] mask per (K, n_fft, device): a second banded call
    # gets the cached tensor, band_filterbank's masks
    cpu = torch.device("cpu")
    masks = cv._band_masks(4, 512, cpu)
    assert torch.equal(masks, cv.band_filterbank(100, 4, 512))
    hits = cv._band_masks.cache_info().hits
    ir = to_torch(rng.uniform(0, 0.4, (150, 4)).astype(np.float32))
    cv.combined_transfer(ir, 512)
    cv.convolve_banded(to_torch(rng.uniform(-1, 1, 300).astype(np.float32)),
                       ir)                                # n_fft 512
    streaming._band_windows(to_torch(rng.normal(size=256)
                                     .astype(np.float32)), 4)  # n_fft 512
    assert cv._band_masks.cache_info().hits == hits + 3
    assert cv._band_masks(4, 512, cpu) is masks
    assert cv._band_masks(8, 512, cpu) is not masks


def test_peak_downmix_resample_load_match_jax(rng):
    x = rng.uniform(-2, 2, (500, 2)).astype(np.float32)
    np.testing.assert_allclose(to_numpy(cv.downmix_mono(to_torch(x))),
                               np.asarray(jcv.downmix_mono(jnp.asarray(x))),
                               rtol=1e-6)
    mono = x[:, 0].copy()
    np.testing.assert_allclose(to_numpy(cv.peak_normalize(to_torch(mono))),
                               np.asarray(jcv.peak_normalize(
                                   jnp.asarray(mono))), rtol=1e-6)
    for src, dst in ((44100, 48000), (48000, 22050), (16000, 16000)):
        np.testing.assert_allclose(
            to_numpy(cv.resample_linear(to_torch(mono), src, dst)),
            np.asarray(jcv.resample_linear(jnp.asarray(mono), src, dst)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            to_numpy(cv.load_samples(to_torch(x), src, dst)),
            np.asarray(jcv.load_samples(jnp.asarray(x), src, dst)),
            rtol=1e-6, atol=1e-6)
    assert cv.downmix_mono(torch.ones(4)).shape == (4,)


# --- banded synthesis: convolve_banded ----------------------------------------

@pytest.mark.parametrize("n_bands,accum,gate", [(1, 1, 1e-4), (4, 3, None),
                                                (8, 1, 1e-4), (32, 2, None)])
def test_convolve_banded_matches_jax(rng, n_bands, accum, gate):
    x = rng.uniform(-1, 1, 300).astype(np.float32)
    x[::7] = 5e-5                                   # below the input gate
    ir = rng.uniform(0, 0.4, (150, n_bands)).astype(np.float32)
    got = cv.convolve_banded(to_torch(x), to_torch(ir), accum, gate)
    assert tuple(got.shape) == (450,)
    _fft_close(got, jcv.convolve_banded(jnp.asarray(x), jnp.asarray(ir),
                                        accum, gate))


def test_convolve_banded_flat_ir_equals_scalar(rng):
    # all K bands share one IR: banded synthesis == the plain FFT convolution
    # (the oracle of tests/test_convolve.py)
    x = rng.uniform(-1, 1, 200).astype(np.float32)
    ir = rng.uniform(0, 0.3, 100).astype(np.float32)
    banded = to_torch(np.tile(ir[:, None], (1, 4)))
    got = cv.convolve_banded(to_torch(x), banded, accum_count=1,
                             gate_eps=None)
    want = cv.convolve_fft(to_torch(x), to_torch(ir), accum_count=1,
                           gate_eps=None)
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-3,
                               atol=1e-4)


def test_convolve_banded_highband_removes_lows():
    # energy only in the top band: a pure low-frequency input comes out
    # strongly attenuated against a flat IR
    n = 512
    x = to_torch(np.sin(2 * np.pi * np.arange(n) * 2 / n).astype(np.float32))
    ir_hi = np.zeros((64, 4), np.float32)
    ir_hi[0, 3] = 1.0
    ir_flat = np.zeros((64, 4), np.float32)
    ir_flat[0, :] = 1.0
    out_hi = cv.convolve_banded(x, to_torch(ir_hi), gate_eps=None)
    out_flat = cv.convolve_banded(x, to_torch(ir_flat), gate_eps=None)
    assert float(out_hi.abs().max()) < 0.1 * float(out_flat.abs().max())
