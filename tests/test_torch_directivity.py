"""PyTorch port: directive sources and microphones (``ops/directivity.py``
and the directive trace) against the JAX package, on the CPU.

Tolerances:

* ``evaluate`` and the presets: the series at 1,001 angles within 3e-7
  absolute (torch's and XLA's float32 cos/sin differ by an ulp);
  ``from_function`` runs the same numpy FFT and gives the same bits;
* ``fourier_gain`` against JAX's ``ops/pallas/bounce_kernel.py::
  _fourier_gain`` (a plain jnp function, called on the CPU with a list of
  scalar coefficients): within 1 ulp (the two run the same operations);
  against ``evaluate`` (angles and trig instead of the recurrence): within
  1e-5 * sum |c|;
* the directive plain trace on JAX's uniforms against JAX's ``trace``:
  valid masks agree on >= 99.9% of the entries (a gain an ulp off can
  flip a ray at the energy cutoff); where both are valid, delays agree as
  in ``test_torch_trace.py`` and energies to rtol 1e-4 plus atol 3e-5 of
  the largest energy (the gain's error is ~1e-7 * sum |c| absolute, which
  near a pattern's null is a large relative one; measured: at most
  1.1e-5 of the largest energy);
* omni-coded patterns (``[1.]``) give the omni bits on every path; a
  microphone cardioid pair at aims 0 and pi sums to twice omni within
  1e-6 (relative L1: (1 + cos) + (1 - cos) rounds);
* K9's per-entry aims equal single-source traces of the same Philox
  numbers bit for bit; the mixdown with per-source aims equals the sum of
  single-source scatters of JAX's uniforms within atol 1e-6 (JAX's
  ``test_directive_fused.py`` construction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CPU, jax_source_uniforms, to_numpy, to_torch

from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
from realisticaudioraytracing2d_tpu.ops import directivity as jax_dv
from realisticaudioraytracing2d_tpu.ops import ir as jax_ir
from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
from realisticaudioraytracing2d_tpu.ops import trace as jax_trace
from realisticaudioraytracing2d_tpu.ops.pallas import bounce_kernel as jax_bk
from realisticaudioraytracing2d_tpu.parallel import multisource as jax_ms
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
from realisticaudioraytracing2d_tpu_torch.ops import trace as tt
from realisticaudioraytracing2d_tpu_torch.ops.cuda import accel_kernel as ak
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.parallel.multisource import \
    trace_sources_mixdown
from realisticaudioraytracing2d_tpu_torch.parallel.sweep import sweep_rooms

ANGLES = np.linspace(-np.pi, np.pi, 1001).astype(np.float32)
PATTERNS = {
    "omni": lambda m: m.omni(),
    "cardioid": lambda m: m.cardioid(0.3),
    "figure8": lambda m: m.figure_eight(1.1),
    "from_function": lambda m: m.from_function(
        lambda t: np.exp(np.cos(t - 0.4)))}
SR, T = 8000, 4000


@pytest.mark.parametrize("name", list(PATTERNS))
def test_presets_and_evaluate_match_jax(name):
    c = PATTERNS[name](dv)
    np.testing.assert_array_equal(c, PATTERNS[name](jax_dv))
    got = to_numpy(dv.evaluate(torch.as_tensor(c), torch.as_tensor(ANGLES)))
    want = np.asarray(jax_dv.evaluate(c, ANGLES))
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)
    assert got.min() >= 0.0
    # batched coefficients broadcast against angles like JAX's
    table = np.stack([c, c * 0.5])                      # [L, C]
    ang = np.stack([ANGLES, ANGLES[::-1]], -1)          # [R, L]
    got = to_numpy(dv.evaluate(torch.as_tensor(table), torch.as_tensor(ang)))
    np.testing.assert_allclose(got, np.asarray(jax_dv.evaluate(table, ang)),
                               rtol=0, atol=3e-7)


def test_from_function_rejects_negative_and_zero_mean():
    with pytest.raises(ValueError, match="non-negative"):
        dv.from_function(lambda t: np.cos(t))
    with pytest.raises(ValueError, match="zero mean"):
        dv.from_function(lambda t: np.zeros_like(t))


@pytest.mark.parametrize("name", list(PATTERNS))
def test_fourier_gain_matches_jax_recurrence(name):
    c = PATTERNS[name](dv)
    c1, s1 = np.cos(ANGLES), np.sin(ANGLES)
    got = to_numpy(dv.fourier_gain(torch.as_tensor(c1), torch.as_tensor(s1),
                                   torch.as_tensor(c)))
    want = np.asarray(jax_bk._fourier_gain(
        jnp.asarray(c1), jnp.asarray(s1), [jnp.float32(x) for x in c]))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    ev = to_numpy(dv.evaluate(torch.as_tensor(c), torch.as_tensor(ANGLES)))
    assert np.abs(got - ev).max() <= 1e-5 * np.abs(c).sum()


def _trace_pair(d, m, n_listeners=2, seed=3, n_rays=1024, n_bounces=5):
    room = jax_rooms.smoll_room()
    lis = np.stack([room.listener, room.listener + [1.5, 0.5]]
                   )[:n_listeners]
    p = jax_trace.TraceParams.make(room.source, lis, 0.5, 343.0, 1.0,
                                   directivity=d, mic_directivity=m)
    key = jax.random.PRNGKey(seed)
    hj, _ = jax_trace.trace(room.scene, p, key, n_rays=n_rays,
                            max_bounces=n_bounces)
    emit, u = jax_rng.bounce_uniforms(key, n_bounces, n_rays)
    ht, _ = tt.trace(convert.scene_from_arrays(room.scene, device=CPU),
                     convert.params_from_arrays(p, device=CPU),
                     to_torch(emit), to_torch(u))
    return hj, ht


@pytest.mark.parametrize("case", ["source", "mic", "mic per listener",
                                  "both"])
def test_directive_trace_matches_jax_with_jax_uniforms(case):
    d, m = {"source": (dv.cardioid(0.7), None),
            "mic": (None, dv.figure_eight(0.3)),
            "mic per listener": (None, np.stack([dv.cardioid(0.5),
                                                 dv.cardioid(-2.0)])),
            "both": (dv.figure_eight(1.0), dv.cardioid(2.0))}[case]
    hj, ht = _trace_pair(d, m)
    vj, vt = np.asarray(hj.valid), to_numpy(ht.valid)
    assert vj.sum() > 500
    assert (vj != vt).mean() <= 1e-3
    both = vj & vt
    dj, dt = np.asarray(hj.delay)[both], to_numpy(ht.delay)[both]
    rel = np.abs(dt - dj) / np.abs(dj)
    assert np.mean(rel <= 1e-5) >= 0.99 and rel.max() <= 1e-4
    ej, et = np.asarray(hj.energy)[..., 0][both], \
        to_numpy(ht.energy)[..., 0][both]
    np.testing.assert_allclose(et, ej, rtol=1e-4, atol=3e-5 * ej.max())


def test_omni_coded_patterns_equal_none_on_every_plain_path():
    room = art.rooms.smoll_room(device=CPU)
    lis = np.stack([room.listener, room.listener + [1.5, 0.5]])
    p0 = tt.TraceParams.make(room.source, lis, device=CPU)
    p1 = p0._replace(directivity=torch.ones(1),
                     mic_directivity=torch.ones(2, 1))
    kw = dict(n_rays=256, max_bounces=4, sample_rate=SR, ir_length=T)
    emit, u = (x[0] for x in art.ops.rng.philox_uniforms(5, 1, 4, 256, CPU))
    h0, _ = tt.trace(room.scene, p0, emit, u)
    h1, _ = tt.trace(room.scene, p1, emit, u)
    assert all(torch.equal(a, b) for a, b in zip(h0, h1))
    for fn in (bk.trace_frames_ir_mega, ak.trace_frames_ir_accel_sorted):
        a, b = (fn(room.scene, p, 5, 1, **kw) for p in (p0, p1))
        assert float(a.sum()) > 0 and torch.equal(a, b)
    assert torch.equal(bk.fixed_point_scale(p0, 1, 256, 4),
                       bk.fixed_point_scale(p1, 1, 256, 4))


def test_mic_cardioid_pair_sums_to_twice_omni():
    room = art.rooms.smoll_room(device=CPU)
    p = tt.TraceParams.make(room.source, room.listener, device=CPU)
    kw = dict(n_rays=512, max_bounces=5, sample_rate=SR, ir_length=T)
    omni = bk.trace_frames_ir_mega(room.scene, p, 9, 1, **kw)
    pair = [bk.trace_frames_ir_mega(
        room.scene, p._replace(mic_directivity=torch.as_tensor(
            dv.cardioid(a))), 9, 1, **kw) for a in (0.0, np.pi)]
    got = (pair[0] + pair[1]).numpy()
    want = 2 * omni.numpy()
    assert want.sum() > 0 and not np.allclose(pair[0], pair[1])
    assert np.abs(got - want).sum() / np.abs(want).sum() < 1e-6


def test_rooms_kernel_per_entry_aims_equal_single_traces():
    room = art.rooms.smoll_room(device=CPU)
    srcs = torch.tensor([[0.0, -3.0], [1.0, -3.0]])
    aims = torch.as_tensor(np.stack([dv.cardioid(0.0), dv.cardioid(2.0)]))
    mic = torch.as_tensor(dv.figure_eight(1.0))
    kw = dict(n_rays=256, max_bounces=4, sample_rate=SR, ir_length=T)
    shared = art.Scene(*(x[None] for x in room.scene))
    lis = torch.as_tensor(room.listener).reshape(1, 1, 2).expand(2, 1, 2)
    batch = bk.trace_rooms_ir_mega(shared, srcs, lis, 3, 1, directivity=aims,
                                   mic_directivity=mic, entry_offset=4, **kw)
    for i in range(2):
        p_i = tt.TraceParams.make(srcs[i], room.listener, device=CPU,
                                  directivity=aims[i], mic_directivity=mic)
        emit, u = art.ops.rng.philox_uniforms(3, 1, 4, 256, CPU, entry=4 + i)
        single = bk.trace_frames_ir_plain(room.scene, p_i, emit, u,
                                          sample_rate=SR, ir_length=T)
        assert float(single.sum()) > 0
        assert torch.equal(batch[i], single)
    # a sweep of rooms takes [rooms, C] aims and [C] mics the same way
    rooms2 = art.Scene(*(x.expand(2, *x.shape[1:]) for x in shared))
    swept = sweep_rooms(rooms2, srcs, lis, 3, directivity=aims,
                        mic_directivity=mic, room_offset=4, **kw)
    assert torch.equal(swept, batch)


def test_mixdown_per_source_aims_match_jax_sum_of_singles():
    room = jax_rooms.smoll_room()
    srcs = np.array([[0.0, -3.0], [1.0, -3.0]], np.float32)
    aims = np.stack([np.pad(dv.cardioid(0.0), (0, 2)), dv.figure_eight(1.0)])
    mic = dv.cardioid(0.6)
    p = jax_trace.TraceParams.make(srcs, room.listener, 0.5, 343.0, 1.0,
                                   directivity=aims, mic_directivity=mic)
    key = jax.random.PRNGKey(2)
    kw = dict(n_rays=256, max_bounces=4, sample_rate=SR, ir_length=T)
    want = 0
    for i, k in enumerate(jax.random.split(key, 2)):
        p_i = p._replace(source=jnp.asarray(srcs[i]),
                         directivity=jnp.asarray(aims[i]))
        hits = jax_trace.trace_hits_only(room.scene, p_i, k, n_rays=256,
                                         max_bounces=4)
        want = want + np.asarray(jax_ir.scatter_hits(hits, SR, T))
    jax_mix = np.asarray(jax_ms.trace_sources_mixdown(
        room.scene, p, key, backend="jnp", **kw))
    np.testing.assert_allclose(jax_mix, want, atol=1e-6)
    got = trace_sources_mixdown(
        convert.scene_from_arrays(room.scene, device=CPU),
        convert.params_from_arrays(p, device=CPU), 0,
        uniforms=jax_source_uniforms(key, 2, 4, 256), **kw)
    assert want.sum() > 0
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-4,
                               atol=3e-5 * want.max())


def test_directive_fixed_point_scale_and_pattern_checks():
    room = art.rooms.smoll_room(device=CPU)
    p = tt.TraceParams.make(room.source, room.listener, device=CPU)
    s0 = bk.fixed_point_scale(p, 1, 100, 5)
    s1 = bk.fixed_point_scale(p._replace(
        directivity=torch.as_tensor(dv.cardioid(0.0)),
        mic_directivity=torch.as_tensor(dv.figure_eight(0.0))), 1, 100, 5)
    # sum |c| bounds each pattern's gain: 2 and 2, so the scale drops by
    # 2^2
    assert float(s0 / s1) == 4.0
    emit, u = (x[0] for x in art.ops.rng.philox_uniforms(1, 1, 2, 16, CPU))
    for bad in (dict(directivity=torch.ones(2)),
                dict(directivity=torch.ones(2, 3)),
                dict(mic_directivity=torch.ones(3, 3))):
        with pytest.raises(ValueError, match="directivity"):
            tt.trace(room.scene, p._replace(**bad), emit, u)
