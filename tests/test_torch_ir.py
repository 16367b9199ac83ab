"""PyTorch port: IR binning vs JAX on random hits (numpy, seeded).

Both packages add one listener's hits in the same flattened order in
float32, so the IRs must be EQUAL, and a rerun must be bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import to_numpy, to_torch

from realisticaudioraytracing2d_tpu.ops import ir as jax_ir
from realisticaudioraytracing2d_tpu.ops.trace import Hits as JaxHits
from realisticaudioraytracing2d_tpu_torch.ops import ir
from realisticaudioraytracing2d_tpu_torch.ops.trace import Hits


def _random_hits(rng, b=4, r=300, n_l=2, k=3, sr=8000, t=256):
    delay = rng.uniform(-0.002, 1.2 * t / sr, (b, 2, r, n_l)).astype(np.float32)
    energy = rng.uniform(0, 1, (b, 2, r, n_l, k)).astype(np.float32)
    valid = rng.uniform(0, 1, (b, 2, r, n_l)) > 0.3
    # many hits in a few bins: the order of the float sums matters
    delay[:, :, :40] = np.float32(5.5 / sr)
    return delay, energy, valid


def test_scatter_hits_equals_jax(rng):
    sr, t = 8000, 256
    delay, energy, valid = _random_hits(rng, sr=sr, t=t)
    want = np.asarray(jax_ir.scatter_hits(
        JaxHits(jnp.asarray(delay), jnp.asarray(energy), jnp.asarray(valid)),
        sr, t))
    hits = Hits(to_torch(delay), to_torch(energy), to_torch(valid))
    got = to_numpy(ir.scatter_hits(hits, sr, t))
    assert got.shape == (2, t, 3)
    np.testing.assert_array_equal(got, want)
    again = to_numpy(ir.scatter_hits(hits, sr, t))
    np.testing.assert_array_equal(got, again)       # bit-identical rerun


def test_scatter_drops_invalid_and_out_of_range():
    delay = np.array([0.001, 0.1, -0.5, 0.002], np.float32)
    hits = Hits(to_torch(delay.reshape(1, 1, 4, 1)),
                to_torch(np.array([1.0, 1.0, 1.0, 7.0], np.float32
                                  ).reshape(1, 1, 4, 1, 1)),
                to_torch(np.array([True, True, True, False]
                                  ).reshape(1, 1, 4, 1)))
    out = ir.scatter_hits(hits, 1000, 8)
    assert float(out.sum()) == pytest.approx(1.0)
    assert float(out[0, 1, 0]) == 1.0


def test_ir_state_accumulate_and_normalize(rng):
    delay, energy, valid = _random_hits(rng, n_l=1, k=1)
    hits = Hits(to_torch(delay), to_torch(energy), to_torch(valid))
    st = ir.IRState.zeros(256, 1, 1, device="cpu")
    assert st.ir_length == 256 and st.frames == 0
    st = ir.accumulate(ir.accumulate(st, hits, 8000), hits, 8000)
    assert st.frames == 2
    one = ir.scatter_hits(hits, 8000, 256)
    np.testing.assert_allclose(to_numpy(st.normalized()), to_numpy(one),
                               rtol=1e-6)
    jst = jax_ir.IRState(jnp.asarray(to_numpy(st.sum)), jnp.asarray(2))
    np.testing.assert_array_equal(to_numpy(st.normalized()),
                                  np.asarray(jst.normalized()))
