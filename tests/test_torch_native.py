"""PyTorch port: the native host runtime (``native/``: the ring buffer,
the flatteners, the Morton clusters, the mp3 codecs and the ALSA sink).

The port keeps its own copy of the JAX package's C++ sources and builds
them into ``build/torch_native/`` under a hash of the sources. Each
function is held against the JAX package's binding on the same inputs:
the ring (compiled and its NumPy fallback) bit for bit on the same
push/drain sequences, across the wrap, with one and two channels; the
flatteners and the Morton clusters bit for bit on the compiled path and
within 1e-5 on the fallbacks (``tests/test_native.py``'s bound), past
2^20 segments too; mp3 decodes of one file equal. The mp3 tests skip
where the system codecs are missing, the sink tests check the message a
host without ALSA gives."""

import shutil
import threading

import numpy as np
import pytest

from realisticaudioraytracing2d_tpu import native as jax_native
from realisticaudioraytracing2d_tpu.utils import audio_io as jax_audio_io
from realisticaudioraytracing2d_tpu_torch import native
from realisticaudioraytracing2d_tpu_torch.utils import audio_io


@pytest.fixture
def fallback(monkeypatch):
    """The port's NumPy fallbacks (the compiled library hidden)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def test_native_library_builds_under_build_with_the_source_hash():
    if shutil.which("g++") is None:
        pytest.skip("no g++ here: the NumPy fallbacks are in use")
    assert native.available()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "torch_native")
    assert path.name.startswith("libartnative_") and path.exists()
    # the port's sources are copies of the JAX package's, byte for byte
    for src in native._SRCS:
        jax_src = (native._HERE.parents[1] / "realisticaudioraytracing2d_tpu"
                   / "native" / src.name)
        assert src.read_bytes() == jax_src.read_bytes()


def _ring_script(seed, size, channels):
    """A push/drain sequence that overlaps, wraps and drains across the
    wrap."""
    rng = np.random.default_rng(seed)
    steps, offset = [], 0
    for _ in range(40):
        n = int(rng.integers(1, size))
        steps.append(("push", rng.normal(size=(channels, n)).astype(
            np.float32), offset + int(rng.integers(0, size // 2))))
        steps.append(("drain", int(rng.integers(1, size // 2))))
        offset += steps[-1][1]
    return steps


def _play(ring, steps):
    out = []
    for step in steps:
        if step[0] == "push":
            ring.push(step[1], step[2])
        else:
            out.append(ring.drain(step[1]))
    return out, ring.read_head


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("path", ["native", "fallback"])
def test_ring_matches_jax_ring_bit_for_bit(request, channels, path):
    if path == "fallback":
        request.getfixturevalue("fallback")
    size = 97
    steps = _ring_script(channels, size, channels)
    got, head = _play(native.NativeRingBuffer(size, channels), steps)
    want, want_head = _play(jax_native.NativeRingBuffer(size, channels),
                            steps)
    assert head == want_head
    assert any(np.abs(w).max() > 0 for w in want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ring_semantics_and_refuses_a_channel_mismatch():
    rb = native.NativeRingBuffer(8, channels=1)
    rb.push(np.ones(4, np.float32), 0)
    rb.push(np.ones(4, np.float32), 2)
    np.testing.assert_array_equal(rb.drain(6)[0], [1, 1, 2, 2, 1, 1])
    np.testing.assert_array_equal(rb.drain(2)[0], [0, 0])
    assert rb.read_head == 0
    rb2 = native.NativeRingBuffer(8, channels=2)
    with pytest.raises(ValueError, match="channels"):
        rb2.push(np.ones((1, 4), np.float32), 0)


@pytest.mark.parametrize("path", ["native", "fallback"])
def test_ring_threaded_integrity(request, path):
    # A producer pushes overlapping chunks while a consumer drains: the
    # energy in equals the energy out (the lock keeps add and zero
    # atomic). A short switch interval makes the threads interleave.
    import sys
    if path == "fallback":
        request.getfixturevalue("fallback")
    rb = native.NativeRingBuffer(1024, channels=1)
    n_chunks, chunk = 64, 128
    done = threading.Event()
    drained = []

    def producer():
        for i in range(n_chunks):
            rb.push(np.ones(chunk, np.float32), i * chunk // 2)
        done.set()

    def consumer():
        while not done.is_set():
            drained.append(float(rb.drain(64).sum()))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=f) for f in (producer, consumer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for _ in range(40):
        drained.append(float(rb.drain(64).sum()))
    assert sum(drained) == pytest.approx(n_chunks * chunk)


def _boxes():
    return np.array([
        [0.0, 10.0, 0.0, 100.0, 1.0, 1.0, 1.0, 0.0, 0.0],
        [2.0, 3.0, np.pi / 2, 4.0, 2.0, 1.0, 1.0, 0.0, 0.0],
        [-1.0, 0.5, 0.3, -2.0, 1.5, 2.0, 0.5, 0.1, -0.2],
    ], np.float32)


def _segments(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-50, 50, size=(n, 2)).astype(np.float32)
    b = a + rng.uniform(0.01, 1.0, size=(n, 2)).astype(np.float32)
    segs = np.concatenate([a, b, np.zeros((n, 2), np.float32)], axis=1)
    segs[-5:, 2:4] = segs[-5:, 0:2]          # degenerate padding sorts last
    return segs


@pytest.mark.parametrize("path", ["native", "fallback"])
def test_flatteners_and_clusters_match_jax(request, path):
    if path == "fallback":
        request.getfixturevalue("fallback")
    # bit for bit where both sides run the same compiled code (JAX's
    # binding falls back to NumPy where its own build failed)
    exact = path == "native" and jax_native.available()
    check = (np.testing.assert_array_equal if exact else
             lambda g, w: np.testing.assert_allclose(g, w, atol=1e-5))
    check(native.flatten_boxes(_boxes()), jax_native.flatten_boxes(_boxes()))
    tri = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    for tf in ((1.0, 2.0, 0.0, 1.0, 1.0), (0.5, -1.0, 0.7, -2.0, 1.5)):
        check(native.flatten_loop(tri, tf), jax_native.flatten_loop(tri, tf))
    segs = _segments(3000)
    order, aabb = native.morton_clusters(segs, 64)
    want_order, want_aabb = jax_native.morton_clusters(segs, 64)
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(aabb, want_aabb)
    assert set(order[-5:]) == set(range(2995, 3000))


def test_morton_clusters_past_2_20_segments_match_jax():
    # the sort key packs the wall index into a 31-bit field: past 2^20
    # segments the order is still a permutation, and the JAX binding's
    n = (1 << 20) + 3
    segs = _segments(n)
    order, aabb = native.morton_clusters(segs, cluster_size=256)
    seen = np.zeros(n, bool)
    seen[order] = True
    assert seen.all() and aabb.shape == (-(-n // 256), 4)
    want_order, want_aabb = jax_native.morton_clusters(segs, 256)
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(aabb, want_aabb)


# ---- mp3 codecs (system libmpg123 / libmp3lame) ----------------------------

def _needs_mp3():
    if not all(native.mp3_probe()):
        pytest.skip("system mp3 codecs (libmpg123/libmp3lame) not available")


def _tone_amp(y, f, rate):
    y = y[np.argmax(np.abs(y) > 1e-4):].astype(np.float64)
    n = rate // 2
    tt = np.arange(n) / rate
    return np.hypot(np.dot(y[:n], np.sin(2 * np.pi * f * tt)),
                    np.dot(y[:n], np.cos(2 * np.pi * f * tt))) / (n / 2)


@pytest.mark.parametrize("stereo", [False, True])
def test_mp3_round_trip_and_jax_decode(tmp_path, stereo):
    _needs_mp3()
    rate = 44100
    t = np.arange(rate) / rate
    tones = ((330, 0.4), (660, 0.3)) if stereo else ((440, 0.5),)
    x = np.stack([a * np.sin(2 * np.pi * f * t) for f, a in tones],
                 -1).astype(np.float32)
    path = str(tmp_path / "x.mp3")
    native.encode_mp3(path, x if stereo else x[:, 0], rate, kbps=160)
    y, r = native.decode_mp3(path)
    assert r == rate and np.isfinite(y).all()
    assert y.shape[1:] == ((2,) if stereo else ())
    ys = y if stereo else y[:, None]
    for c, (f, want) in enumerate(tones):
        assert abs(_tone_amp(ys[:, c], f, rate) - want) < 0.08
    # JAX's binding (where its own build has the codecs) decodes the same
    # file to the same samples
    if all(jax_native.mp3_probe()):
        y_jax, r_jax = jax_native.decode_mp3(path)
        assert r_jax == r
        np.testing.assert_array_equal(y, y_jax)


def test_mp3_decode_errors(tmp_path):
    _needs_mp3()
    with pytest.raises(RuntimeError, match="mp3 decode failed"):
        native.decode_mp3(str(tmp_path / "missing.mp3"))
    bad = tmp_path / "bad.mp3"
    bad.write_bytes(b"\x00" * 4096)             # no MPEG frame anywhere
    with pytest.raises(RuntimeError, match="mp3 decode failed"):
        native.decode_mp3(str(bad))
    with pytest.raises(ValueError, match="mp3 encode wants"):
        native.encode_mp3(str(tmp_path / "x.mp3"),
                          np.zeros((10, 3), np.float32), 8000)


def test_codecs_refuse_cleanly_without_the_native_runtime(fallback,
                                                          tmp_path):
    assert native.mp3_probe() == (False, False)
    with pytest.raises(RuntimeError, match="mp3 decode unavailable"):
        native.decode_mp3(str(tmp_path / "x.mp3"))
    with pytest.raises(RuntimeError, match="mp3 encode unavailable"):
        native.encode_mp3(str(tmp_path / "x.mp3"), np.zeros(8), 8000)
    assert native.sink_probe() == (False,
                                   "native runtime unavailable (no g++?)")


def test_read_audio_dispatches_on_extension(tmp_path):
    _needs_mp3()
    rate = 22050
    x = (0.25 * np.sin(2 * np.pi * 220 * np.arange(rate) / rate)
         ).astype(np.float32)
    for name in ("clip.wav", "clip.mp3"):
        path = str(tmp_path / name)
        audio_io.write_audio(path, x, rate)
        y, r = audio_io.read_audio(path)
        assert r == rate
        if name.endswith(".wav") or all(jax_native.mp3_probe()):
            want, want_r = jax_audio_io.read_audio(path)
            assert want_r == rate
            np.testing.assert_array_equal(y, want)
        mid = np.ravel(y)[len(y) // 4:3 * len(y) // 4].astype(np.float64)
        assert abs(np.sqrt((mid ** 2).mean()) - 0.25 / np.sqrt(2)) < 0.02


def test_bundled_clip_is_the_port_copy():
    path = audio_io.builtin_clip_path()
    assert "realisticaudioraytracing2d_tpu_torch" in path
    with open(path, "rb") as f, open(jax_audio_io.builtin_clip_path(),
                                     "rb") as g:
        assert f.read() == g.read()
    x, rate = audio_io.read_audio(path)
    assert rate == 48000 and x.shape == (48000,) and np.abs(x).max() > 0


# ---- OS audio sink (ALSA, opened at run time) -------------------------------

def test_sink_probe_reports_availability_with_reason():
    ok, reason = native.sink_probe()
    assert isinstance(ok, bool) and isinstance(reason, str) and reason
    if jax_native.available():
        assert (ok, reason) == jax_native.sink_probe()
    if not ok:
        assert "asound" in reason or "native runtime" in reason


def test_audio_sink_degrades_cleanly_without_device():
    ok, _ = native.sink_probe()
    if ok:
        pytest.skip("ALSA present here; the degradation path is not "
                    "reachable")
    with pytest.raises(RuntimeError, match="audio sink unavailable"):
        native.AudioSink(48000, 1)
