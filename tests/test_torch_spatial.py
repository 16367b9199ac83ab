"""PyTorch port: spatial (W/X/Y intensity) IRs and the binaural decode
(``spatial.py``), after tests/test_spatial.py.

The same inputs, made from a seed with numpy, go through the JAX module
and the port. Tolerances:

* the virtual-microphone tables, the split of an IR, the ear signs and
  the host analysis (``dominant_arrivals``, ``onset_bearing``,
  ``two_arrival_bearings``, numpy code on the same float32 numbers) are
  equal exactly;
* steering takes ``cos``/``sin``, which round by an ulp or so
  differently in XLA and torch: within rtol 1e-5 and atol 1e-6 of the
  largest value. The decode's target bin ``t = bin - shift * sin(phi)``
  is a float32 near ``bin``, whose spacing grows with the bin (3.1e-5 at
  400 bins, 7.8e-3 at 72,000): an ulp of ``sin`` can round ``t`` one
  spacing over, which moves ``e * spacing`` of a deposit ``e`` between
  its two bins (a ``t`` that crosses an integer moves only ``e * frac``
  with ``frac`` ~ 0: the splat is continuous in ``t``). So the decode is
  held within ``DECODE_FLIPS`` such moves of the largest deposit, ``(1 +
  shadow) * max W * spacing(T)``, per bin; the per-ear coherent total,
  which each deposit pair conserves, within rtol 1e-6;
* ``trace_spatial`` fed JAX's uniforms is held to the trace parity of
  ``test_torch_directivity.py`` (rtol 1e-4 plus atol 3e-5 of the largest
  bin); on the CPU the W row equals the port's omni trace bit for bit,
  since the plain path's float scatter sees the same hits with gain 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CPU, jax_frame_uniforms, to_numpy, to_torch

from realisticaudioraytracing2d_tpu import analysis as jan
from realisticaudioraytracing2d_tpu import spatial as jsp
from realisticaudioraytracing2d_tpu.models.materials import \
    AudioMaterial as JMaterial
from realisticaudioraytracing2d_tpu.models.scene import \
    SceneBuilder as JBuilder
from realisticaudioraytracing2d_tpu.ops.trace import \
    TraceParams as JParams
import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import analysis as an
from realisticaudioraytracing2d_tpu_torch import convert
from realisticaudioraytracing2d_tpu_torch import spatial as sp
from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams

TRACE_TOL = dict(rtol=1e-4)


# deposits of one bin whose target rounds one float32 spacing over at once
DECODE_FLIPS = 4


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30))


def _decoded_close(got, want, w, shadow=0.6):
    """The decode against JAX's: the limit of the module docstring."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    n_t = got.shape[-2] if got.ndim > 1 else got.shape[-1]
    move = (1.0 + shadow) * float(np.abs(w).max()) * float(
        np.spacing(np.float32(n_t)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=DECODE_FLIPS * move
                               + 1e-6 * np.abs(want).max())


def echo_scene():
    # reflective wall at x=10; source at origin, listener at (5, 0):
    # direct arrives from -x (bearing pi), the wall echo from +x (0)
    m = JMaterial(absorption=0.1, scattering=0.0, transmission=0.0, ior=1.0)
    b = JBuilder(n_bands=1)
    b.add_segment((10.0, -20.0), (10.0, 20.0), (-1.0, 0.0), m)
    return b.build()


def box_room(side=8.0, absorption=0.3):
    # closed square, fully diffuse walls -> isotropic late field
    m = JMaterial(absorption=absorption, scattering=1.0, transmission=0.0,
                  ior=1.0)
    s = side / 2
    b = JBuilder(n_bands=1)
    b.add_segment((-s, -s), (s, -s), (0.0, 1.0), m)
    b.add_segment((s, -s), (s, s), (-1.0, 0.0), m)
    b.add_segment((s, s), (-s, s), (0.0, -1.0), m)
    b.add_segment((-s, s), (-s, -s), (1.0, 0.0), m)
    return b.build()


def random_field(seed=0, n_t=300, shape=(2, 3)):
    """Random W/X/Y with |(X, Y)| <= W (part coherent, part diffuse), as
    numpy float32 arrays."""
    rng = np.random.default_rng(seed)
    w = rng.random((shape[0], n_t, shape[1])).astype(np.float32)
    ang = rng.random(w.shape) * 2 * np.pi
    frac = rng.random(w.shape)
    return (w, (w * frac * np.cos(ang)).astype(np.float32),
            (w * frac * np.sin(ang)).astype(np.float32))


def both(arrays):
    """The port's and JAX's SpatialIR on the same numpy channels."""
    return (sp.SpatialIR(*(torch.from_numpy(a) for a in arrays)),
            jsp.SpatialIR(*(jnp.asarray(a) for a in arrays)))


def synth(t0, bearing, energy=1.0, n_t=256, coherent=1.0):
    w = np.zeros((1, n_t, 1), np.float32)
    w[0, t0, 0] = energy
    return (w, (w * coherent * np.cos(bearing)).astype(np.float32),
            (w * coherent * np.sin(bearing)).astype(np.float32))


@pytest.mark.parametrize("order", [1, 2])
def test_spatial_params_equal_jax(order):
    lis = np.float32([[5.0, 0.0], [2.0, 1.0]])
    got = sp.spatial_params(TraceParams.make([0.0, 0.0], lis, device=CPU),
                            order=order)
    want = jsp.spatial_params(JParams.make(np.float32([0, 0]), lis),
                              order=order)
    n = 3 if order == 1 else 5
    assert tuple(got.mic_directivity.shape) == (2 * n, n)
    np.testing.assert_array_equal(to_numpy(got.listeners),
                                  np.asarray(want.listeners))
    np.testing.assert_array_equal(to_numpy(got.mic_directivity),
                                  np.asarray(want.mic_directivity))
    assert got.mic_directivity.dtype == torch.float32


def test_spatial_params_and_split_refusals():
    p = TraceParams.make([0.0, 0.0], [5.0, 0.0],
                         mic_directivity=dv.cardioid(0.0), device=CPU)
    with pytest.raises(ValueError, match="mic_directivity"):
        sp.spatial_params(p)
    with pytest.raises(ValueError, match="order"):
        sp.spatial_params(p._replace(mic_directivity=None), order=3)
    with pytest.raises(ValueError, match="3L"):
        sp.spatial_from_ir(torch.zeros(4, 8, 1))
    with pytest.raises(ValueError, match="5L"):
        sp.spatial_from_ir(torch.zeros(6, 8, 1), order=2)
    with pytest.raises(ValueError, match="head listener"):
        sp.binaural_trace_params(TraceParams.make(
            [0.0, 0.0], [[1.0, 0.0], [2.0, 0.0]], device=CPU), 2)
    with pytest.raises(ValueError, match="two ear"):
        sp.binaural_trace_params(p._replace(mic_directivity=None), 1)


@pytest.mark.parametrize("order", [1, 2])
def test_spatial_from_ir_equals_jax(order):
    n = 3 if order == 1 else 5
    ir = np.random.default_rng(1).random((2 * n, 64, 2)).astype(np.float32)
    got = sp.spatial_from_ir(torch.from_numpy(ir), order=order)
    want = jsp.spatial_from_ir(jnp.asarray(ir), order=order)
    assert got.order == want.order == order and got.n_listeners == 2
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("n_t", [1, 7, 72000])
def test_ear_signs_equal_jax(n_t):
    for ear in (0, 1):
        got = sp._ear_signs(n_t, ear)
        np.testing.assert_array_equal(got, jsp._ear_signs(n_t, ear))
        assert got.dtype == np.float32
    t = sp._ear_signs_tensor(n_t, 1, torch.device(CPU))
    assert t is sp._ear_signs_tensor(n_t, 1, torch.device(CPU))  # cached
    np.testing.assert_array_equal(to_numpy(t)[0, :, 0],
                                  jsp._ear_signs(n_t, 1))


@pytest.mark.parametrize("aim", [0.0, 0.7, -2.5])
def test_steer_and_stereo_equal_jax(aim):
    arrays = random_field(2)
    rng = np.random.default_rng(3)
    x2 = (arrays[0] * rng.uniform(-0.5, 0.5, arrays[0].shape)
          ).astype(np.float32)
    y2 = (arrays[0] * rng.uniform(-0.5, 0.5, arrays[0].shape)
          ).astype(np.float32)
    port, ref = both(arrays)
    _close(to_numpy(port.steer(aim)), ref.steer(aim))
    _close(to_numpy(port.steer(aim, b=0.5, a=1.0)), ref.steer(aim, 0.5, 1.0))
    for g, w in zip(port.stereo(aim, spread=1.2), ref.stereo(aim, 1.2)):
        _close(to_numpy(g), w)
    port2, ref2 = both(arrays + (x2, y2))
    assert port2.order == 2
    _close(to_numpy(port2.steer(aim, a=1.0, b=4.0 / 3.0, c=1.0 / 3.0)),
           ref2.steer(aim, a=1.0, b=4.0 / 3.0, c=1.0 / 3.0))
    _close(to_numpy(port.arrival_angle()), ref.arrival_angle())
    _close(to_numpy(port.diffuseness()), ref.diffuseness())


def test_steer_refusals():
    ones = torch.ones(1, 4, 1)
    zeros = torch.zeros(1, 4, 1)
    ir1 = sp.SpatialIR(w=ones, x=zeros, y=zeros)
    with pytest.raises(ValueError, match="power pattern"):
        ir1.steer(0.0, b=2.0, a=1.0)
    with pytest.raises(ValueError, match="order=2"):
        ir1.steer(0.0, c=0.5)
    ir2 = sp.SpatialIR(ones, zeros, zeros, zeros, zeros)
    with pytest.raises(ValueError, match="negative"):
        ir2.steer(0.0, b=0.0, a=0.5, c=1.0)   # dips below zero at u=pi/2
    ir2.steer(0.3, a=1.0, b=4.0 / 3.0, c=1.0 / 3.0)
    for abc in ((1.0, 0.5, 0.2), (0.5, 0.0, 1.0), (1.0, 4 / 3, 1 / 3)):
        assert sp._steer_min(*abc) == jsp._steer_min(*abc)
    with pytest.raises(ValueError, match="shadow"):
        ir1.binaural(8000, shadow=1.5)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(decorrelate=False, shadow=0.3),
    dict(facing=1.1, head_radius=0.2, shadow=1.0),
    dict(facing=-0.4, speed_of_sound=300.0, decorrelate=False)])
def test_binaural_equals_jax(kw):
    arrays = random_field(4, n_t=400)
    port, ref = both(arrays)
    got = port.binaural(8000, **kw)
    want = ref.binaural(8000, **kw)
    for g, w in zip(got, want):
        _decoded_close(to_numpy(g), w, arrays[0], kw.get("shadow", 0.6))
    # the coherent path re-splats exactly 2 coh: per ear, the coherent
    # totals are the JAX ones
    plain_kw = dict(kw, decorrelate=False)
    w_, x_, y_ = arrays
    diffuse = w_ - np.minimum(np.hypot(x_, y_), w_)
    for g, w in zip(port.binaural(8000, **plain_kw),
                    ref.binaural(8000, **plain_kw)):
        np.testing.assert_allclose(
            float(to_numpy(g).astype(np.float64).sum() - diffuse.sum()),
            float(np.asarray(w).astype(np.float64).sum() - diffuse.sum()),
            rtol=1e-6)


def test_binaural_with_a_traced_speed_of_sound_equals_jax_jit():
    # the stream step's form: speed_of_sound a float32 tensor, max_shift
    # r / c * sr in float32 operations, as the jitted JAX step computes
    w, x, y = random_field(5, n_t=300)
    capture = np.concatenate([w, w + x, w + y])     # the three microphones
    c = torch.tensor(343.0)
    step = jax.jit(jsp.binaural_decode_ir, static_argnums=(1, 3, 4, 6))
    want = step(jnp.asarray(capture), 48000, jnp.asarray(0.3, jnp.float32),
                0.0875, 0.6, jnp.asarray(343.0, jnp.float32), True)
    got = sp.binaural_decode_ir(torch.from_numpy(capture), 48000, 0.3,
                                0.0875, 0.6, c)
    assert tuple(got.shape) == (4, 300, 3)
    _decoded_close(to_numpy(got), want, w)
    left, _ = sp.spatial_from_ir(torch.from_numpy(capture)).binaural(
        48000, facing=0.3, speed_of_sound=c)
    np.testing.assert_array_equal(to_numpy(left), to_numpy(got[:2]))


def test_binaural_pure_side_itd_and_ild():
    sr, r, c = 8000, 0.0875, 343.0
    shift = r / c * sr                         # 2.04 bins
    port, ref = both(synth(100, np.pi / 2))
    left, right = (to_numpy(e)[0, :, 0] for e in port.binaural(
        sr, facing=0.0, head_radius=r, shadow=0.6, speed_of_sound=c))
    tl = (left * np.arange(left.size)).sum() / left.sum()
    tr = (right * np.arange(right.size)).sum() / right.sum()
    np.testing.assert_allclose(tl, 100 - shift, atol=1e-3)
    np.testing.assert_allclose(tr, 100 + shift, atol=1e-3)
    np.testing.assert_allclose(left.sum(), 1.6, rtol=1e-6)
    np.testing.assert_allclose(right.sum(), 0.4, rtol=1e-6)
    for g, w in zip((left, right), ref.binaural(sr, 0.0, r, 0.6, c)):
        _decoded_close(g, np.asarray(w)[0, :, 0], 1.0)


def test_binaural_frontal_is_symmetric():
    port, _ = both(synth(50, 0.7))
    left, right = port.binaural(8000, facing=0.7)
    np.testing.assert_allclose(to_numpy(left), to_numpy(right), atol=1e-7)
    assert float(left[0, 50, 0]) == pytest.approx(1.0)


def test_binaural_degenerate_head_identity():
    # radius 0 and shadow 0: coincident ears hear W exactly, the
    # decorrelator gates itself off
    port, ref = both(random_field(5))
    left, right = port.binaural(8000, head_radius=0.0, shadow=0.0)
    np.testing.assert_allclose(to_numpy(left), to_numpy(port.w), atol=1e-7)
    assert torch.equal(left, right)
    np.testing.assert_array_equal(
        to_numpy(left), np.asarray(ref.binaural(8000, head_radius=0.0,
                                                shadow=0.0)[0]))


def test_binaural_decorrelation_touches_only_the_diffuse_stream():
    port, _ = both(synth(100, 0.9, coherent=1.0))
    for on, off in zip(port.binaural(8000, shadow=0.4),
                       port.binaural(8000, shadow=0.4, decorrelate=False)):
        assert torch.equal(on, off)
    arrays = random_field(3)
    port, _ = both(arrays)
    l_on, _ = port.binaural(8000, shadow=0.4)
    l_off, _ = port.binaural(8000, shadow=0.4, decorrelate=False)
    w_, x_, y_ = arrays
    diffuse = w_ - np.minimum(np.hypot(x_, y_), w_)
    signs = sp._ear_signs(w_.shape[1], 0)[None, :, None]
    np.testing.assert_allclose(to_numpy(l_on) - signs * diffuse,
                               to_numpy(l_off) - diffuse, atol=1e-6)
    # a fully diffuse field keeps its per-bin magnitude in both ears
    diffuse_only = sp.SpatialIR(port.w, torch.zeros_like(port.w),
                                torch.zeros_like(port.w))
    left, right = diffuse_only.binaural(8000, shadow=0.6)
    assert torch.equal(left.abs(), port.w) and torch.equal(right.abs(),
                                                           port.w)
    assert not torch.equal(left, right)
    # decorrelation off: left + right == 2 W in total
    left, right = port.binaural(8000, shadow=0.3, decorrelate=False)
    np.testing.assert_allclose(float(left.sum() + right.sum()),
                               2 * float(port.w.sum()), rtol=1e-5)


def test_binaural_near_start_bin_clamps_no_negative_energy():
    sr, r, c = 44100, 0.0875, 343.0
    port, ref = both(synth(0, np.pi / 2, n_t=64))
    left, right = (to_numpy(e)[0, :, 0] for e in port.binaural(
        sr, head_radius=r, shadow=0.6, speed_of_sound=c))
    assert (left >= 0).all() and (right >= 0).all()
    np.testing.assert_allclose(left.sum(), 1.6, rtol=1e-6)
    assert left.max() <= 1.6 + 1e-6
    np.testing.assert_allclose(left.sum() + right.sum(), 2.0, rtol=1e-6)
    _decoded_close(left, np.asarray(ref.binaural(
        sr, head_radius=r, shadow=0.6, speed_of_sound=c)[0])[0, :, 0], 1.0)


def test_binaural_decorrelation_drops_late_iacc():
    # a fully diffuse late tail (x = y = 0): the identical-diffuse decode
    # measures IACC ~ 1, the decorrelated one under 0.5, on the port's
    # iacc as on JAX's
    sr, n_t = 8000, 2048
    rng = np.random.default_rng(7)
    env = np.exp(-np.arange(n_t) / (0.08 * sr))
    w = (rng.random(n_t) * env)[None, :, None].astype(np.float32)
    z = np.zeros_like(w)
    port, ref = both((w, z, z))
    late = dict(t_start_s=0.02)
    vals = []
    for decorrelate in (False, True):
        left, right = port.binaural(sr, decorrelate=decorrelate)
        got = float(an.iacc(left[0, :, 0], right[0, :, 0], sr, **late))
        jl, jr = ref.binaural(sr, decorrelate=decorrelate)
        want = float(jan.iacc(jl[0, :, 0], jr[0, :, 0], sr, **late))
        assert got == pytest.approx(want, rel=1e-4)
        vals.append(got)
    assert vals[0] > 0.99
    assert vals[1] < 0.5


def test_dominant_arrivals_and_onset_bearing_equal_jax():
    n_t = 256
    w = np.zeros((1, n_t, 1), np.float32)
    x = np.zeros_like(w)
    y = np.zeros_like(w)
    w[0, 100, 0], x[0, 100, 0] = 1.0, 1.0     # arrival 1 from bearing 0
    w[0, 104, 0], x[0, 104, 0] = 0.5, 0.5     # its smear
    w[0, 120, 0], x[0, 120, 0] = 0.8, -0.8    # arrival 2 from bearing pi
    port, ref = both((w, x, y))
    got = sp.dominant_arrivals(port, 8000, n=2, window_bins=16)
    assert len(got) == 2 and got == jsp.dominant_arrivals(ref, 8000, n=2,
                                                          window_bins=16)
    assert abs(got[0]["bearing_rad"]) < 1e-6
    assert abs(abs(got[1]["bearing_rad"]) - np.pi) < 1e-6
    assert got[1]["energy"] == pytest.approx(0.8)
    port, ref = both(random_field(9, n_t=500))
    for kw in (dict(), dict(listener=1, band=2, n=8, window_bins=4,
                            min_fraction=0.1)):
        assert sp.dominant_arrivals(port, 8000, **kw) == \
            jsp.dominant_arrivals(ref, 8000, **kw)
    for t, kw in ((0.02, {}), (0.031, dict(listener=1, band=1,
                                           onset_bins=6))):
        assert sp.onset_bearing(port, t, 8000, **kw) == \
            jsp.onset_bearing(ref, t, 8000, **kw)


def test_two_arrival_bearings_equal_jax():
    t1, t2, e1, e2 = 0.3, 2.0, 1.0, 0.7
    z = np.zeros((1, 64, 1), np.float32)
    chans = []
    for f in (lambda t: 1.0, np.cos, np.sin, lambda t: np.cos(2 * t),
              lambda t: np.sin(2 * t)):
        c = z.copy()
        c[0, 10, 0] = e1 * f(t1) + e2 * f(t2)
        chans.append(c)
    port, ref = both(tuple(chans))
    got = sp.two_arrival_bearings(port, 9, 12)
    assert got == jsp.two_arrival_bearings(ref, 9, 12)
    (b1, g1), (b2, g2) = got
    assert abs(b1 - t1) < 0.02 and abs(g1 - e1) < 0.02
    assert abs(b2 - t2) < 0.02 and abs(g2 - e2) < 0.02
    with pytest.raises(ValueError, match="order=2"):
        sp.two_arrival_bearings(both(random_field(1))[0], 0, 4)


@pytest.mark.parametrize("order, listeners", [
    (1, [[5.0, 0.0]]), (1, [[5.0, 0.0], [2.0, 1.0]]), (2, [[5.0, 0.0]])])
def test_trace_spatial_fed_jax_uniforms_equals_jax(order, listeners):
    key = jax.random.PRNGKey(4)
    jscene = echo_scene()
    lis = np.float32(listeners)
    kw = dict(n_rays=1024, max_bounces=2, sample_rate=8000, ir_length=1024,
              n_frames=2, order=order)
    want, jstate = jsp.trace_spatial(
        jscene, JParams.make(np.float32([0, 0]), lis, listener_radius=0.5),
        key, **kw)
    scene = convert.scene_from_arrays(jscene, device=CPU)
    p = TraceParams.make([0.0, 0.0], lis, listener_radius=0.5, device=CPU)
    uniforms = jax_frame_uniforms(key, 2, 2, 1024)
    got, state = sp.trace_spatial(scene, p, uniforms=uniforms, **kw)
    assert state.frames == 2 and tuple(state.sum.shape) == tuple(
        jstate.sum.shape) == ((3 if order == 1 else 5) * len(lis), 1024, 1)
    ref = np.asarray(jstate.sum)
    assert ref.max() > 0
    np.testing.assert_allclose(to_numpy(state.sum), ref, **TRACE_TOL,
                               atol=3e-5 * ref.max())
    assert got.order == want.order and got.n_listeners == len(lis)
    # per-hit identity on the plain path: W is the omni trace bit for bit
    omni = art.trace_accumulate(
        scene, p, art.IRState.zeros(1024, len(lis), 1, device=CPU),
        n_rays=1024, max_bounces=2, sample_rate=8000, n_frames=2,
        uniforms=uniforms)
    assert torch.equal(got.w, omni.normalized())
    # and a retrace with a steered pattern is the steered capture
    aim = 0.7
    cardioid = art.trace_accumulate(
        scene, p._replace(mic_directivity=torch.tensor(dv.cardioid(aim))),
        art.IRState.zeros(1024, len(lis), 1, device=CPU), n_rays=1024,
        max_bounces=2, sample_rate=8000, n_frames=2,
        uniforms=uniforms).normalized()
    np.testing.assert_allclose(to_numpy(got.steer(aim)), to_numpy(cardioid),
                               rtol=2e-4, atol=1e-7 * float(cardioid.max()))


def test_trace_spatial_accumulates_across_calls():
    scene = convert.scene_from_arrays(echo_scene(), device=CPU)
    p = TraceParams.make([0.0, 0.0], [5.0, 0.0], listener_radius=0.5,
                         device=CPU)
    kw = dict(n_rays=512, max_bounces=2, sample_rate=8000, ir_length=1024)
    ir1, st = sp.trace_spatial(scene, p, 0, **kw)
    ir2, st = sp.trace_spatial(scene, p, 1, state=st, **kw)
    assert st.frames == 2 and float(ir2.w.sum()) > 0
    assert not torch.equal(ir1.w, ir2.w)
    # the direct sound from -x, the echo from +x
    ang = to_numpy(ir2.arrival_angle())[0, :, 0]
    w = to_numpy(ir2.w)[0, :, 0]
    direct = int(np.floor(5.0 / 343.0 * 8000))
    db = slice(direct - 3, direct + 4)
    assert abs(abs(ang[db][w[db].argmax()]) - np.pi) < 0.1


def test_binaural_traced_box_room_late_iacc():
    # a traced diffuse box room (JAX's draws): the decorrelated decode's
    # late IACC < 0.5, the plain decode's > 0.9, and both are JAX's
    sr = 8000
    key = jax.random.PRNGKey(0)
    jscene = box_room()
    kw = dict(n_rays=2048, max_bounces=12, sample_rate=sr, ir_length=4096)
    want, _ = jsp.trace_spatial(jscene, JParams.make(
        np.float32([0, 0]), np.float32([1.0, 0.5]), listener_radius=0.5),
        key, **kw)
    got, _ = sp.trace_spatial(
        convert.scene_from_arrays(jscene, device=CPU),
        TraceParams.make([0.0, 0.0], [1.0, 0.5], listener_radius=0.5,
                         device=CPU),
        uniforms=jax_frame_uniforms(key, 1, 12, 2048), **kw)
    late = dict(t_start_s=0.08)
    vals = []
    for decorrelate in (False, True):
        left, right = got.binaural(sr, decorrelate=decorrelate)
        i_port = float(an.iacc(left[0, :, 0], right[0, :, 0], sr, **late))
        jl, jr = want.binaural(sr, decorrelate=decorrelate)
        i_jax = float(jan.iacc(jl[0, :, 0], jr[0, :, 0], sr, **late))
        assert i_port == pytest.approx(i_jax, rel=1e-3)
        vals.append(i_port)
    assert vals[0] > 0.9
    assert vals[1] < 0.5


def test_convert_spatial_ir():
    arrays = random_field(6)
    _, ref = both(arrays)
    got = convert.spatial_ir_from_arrays(ref, device=CPU)
    assert got.x2 is None and got.order == 1
    for g, a in zip(got, arrays):
        np.testing.assert_array_equal(to_numpy(g), a)
    ref2 = ref._replace(x2=ref.x, y2=ref.y)
    got2 = convert.spatial_ir_from_arrays(ref2, device=CPU)
    assert got2.order == 2 and torch.equal(got2.y2, to_torch(arrays[2]))
