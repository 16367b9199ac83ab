"""PyTorch port: the binaural decode's gather on the CPU.

On the card ``SpatialIR.binaural`` and ``binaural_decode_ir`` are one
launch of ``binaural_decode_kernel`` (``ops/cuda/binaural_kernel.py``), a
gather: each output bin sums, from 0, the ``lo`` deposits of the sources
within ``window_half_width`` bins whose ``lo`` is that bin, in ascending
source order, then their ``hi`` deposits in the same order, then adds the
diffuse rest through the ear's sign. Here a numpy model of that gather,
fed the plain chain's own deposits (``spatial.binaural_entries``), equals
the plain decode (``spatial.binaural_plain``: ``index_add_`` in the
entries' order) bit for bit: targets clamped at bin 0 and at T - 1 (where
``lo == hi``), two listeners, four bands, ``facing`` as a number and as a
0-d tensor, ``speed_of_sound`` as a number and as a tensor (a slow one
whose window passes the halo the host sizes for a card tensor, so the
kernel reads past its shared memory), decorrelation off, the degenerate
head. Then the routing of CPU tensors to the chain and the checks the
wrapper makes before a launch. tests/test_torch_cuda_binaural_decode.py
holds the kernel itself on the card."""

import numpy as np
import pytest
import torch

from realisticaudioraytracing2d_tpu_torch import spatial as spm
from realisticaudioraytracing2d_tpu_torch.ops.cuda import binaural_kernel \
    as bdk
from realisticaudioraytracing2d_tpu_torch.ops.cuda import build

SR = 48000
# the shipped head (Brown and Duda): 12.24 bins of ITD at 48 kHz
HEAD = dict(head_radius=0.0875, shadow=0.6)


def capture(n_l, n_t, n_k, seed, empty=0.3, edges=False):
    """A ``[3L, T, K]`` capture ``[W; C0; C90]`` from ``seed``: energies
    W >= 0 (a share ``empty`` of bins zero, as a real IR's silence),
    intensity vectors of length up to 1.2 W (the decode clips it at W),
    bearings uniform. ``edges``: the first and the last 40 bins arrive
    from the left of a head facing 0, so the left ear's targets clamp at
    bin 0 and the right ear's at T - 1."""
    g = np.random.default_rng(seed)
    w = g.exponential(1.0, (n_l, n_t, n_k)).astype(np.float32)
    w[g.random((n_l, n_t, n_k)) < empty] = 0.0
    r = w * g.uniform(0.0, 1.2, w.shape).astype(np.float32)
    phi = g.uniform(-np.pi, np.pi, w.shape)
    if edges:
        phi[:, :40] = np.pi / 2
        phi[:, -40:] = np.pi / 2
    x = (r * np.cos(phi)).astype(np.float32)
    y = (r * np.sin(phi)).astype(np.float32)
    return torch.from_numpy(np.concatenate([w, x + w, y + w]))


def kernel_max_shift(head_radius, sample_rate, speed):
    """``max_shift`` as the kernel has it (float32), from the host."""
    ms = bdk.max_shift_known(head_radius, sample_rate, speed)
    assert ms is not None
    return ms


def gather(sp, sample_rate, facing, head_radius, shadow, speed,
           decorrelate, halo):
    """The kernel's gather in numpy on the chain's deposits: returns the
    two-ear IR ``[2L, T, K]`` and the deposits each ear's window read
    from past the shared range ``halo`` (the kernel's global reads)."""
    rows, values, diffuse = spm.binaural_entries(
        sp, sample_rate, facing, head_radius, shadow, speed)
    n_l, n_t, n_k = diffuse.shape
    n = n_l * n_t * n_k
    rows, values = rows.numpy(), values.numpy()
    h = bdk.window_half_width(
        kernel_max_shift(head_radius, sample_rate, speed), n_t)
    src = np.arange(n_t)[None, :, None]
    tile0 = (np.arange(n_t) // bdk.TILE) * bdk.TILE
    s0 = np.maximum(tile0 - min(h, halo), 0)
    s1 = np.minimum(tile0 + bdk.TILE + min(h, halo), n_t)
    decorr = spm._decorrelated(decorrelate, head_radius, shadow)
    out, past = [], 0
    for ear in range(2):
        acc = np.zeros((n_l, n_t, n_k), np.float32)
        for part in range(2):              # lo deposits, then hi ones
            sl = slice((2 * ear + part) * n, (2 * ear + part + 1) * n)
            flat = rows[sl] - ear * n
            target = ((flat // n_k) % n_t).reshape(n_l, n_t, n_k)
            val = values[sl].reshape(n_l, n_t, n_k)
            # the window holds every deposit's source
            assert np.abs(target - src).max() <= h
            for d in range(-h, h + 1):     # ascending source bins
                b = np.arange(n_t) + d
                ok = (b >= 0) & (b < n_t)
                bc = np.clip(b, 0, n_t - 1)
                hit = ok[None, :, None] & (target[:, bc] == src)
                acc = (acc + np.where(hit, val[:, bc],
                                      np.float32(0))).astype(np.float32)
                outside = ok & ((b < s0) | (b >= s1))
                past += int((hit & outside[None, :, None]).sum())
        rest = diffuse.numpy()
        if decorr:
            rest = rest * spm._ear_signs(n_t, ear)[None, :, None]
        out.append((acc + rest).astype(np.float32))
    return np.concatenate(out), past


def bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else x
    return np.ascontiguousarray(x, np.float32).view(np.int32)


# (name, L, T, K, sample rate, facing, speed of sound, kwargs)
CASES = {
    "cell": (1, 72000, 1, SR, 0.3, 343.0, {}),
    "clamped_edges": (1, 300, 1, SR, 0.0, 343.0, {}),
    "two_listeners": (2, 900, 1, SR, -1.1, 343.0, {}),
    "four_bands": (1, 700, 4, SR, 2.5, 343.0, {}),
    "facing_tensor": (1, 600, 1, SR, "tensor:0.7", 343.0, {}),
    "speed_tensor": (1, 600, 1, SR, 0.4, "tensor:343.0", {}),
    "speed_float64_tensor": (1, 600, 1, SR, 0.4, "f64:331.5", {}),
    "slow_speed_tensor": (1, 2000, 1, SR, 1.3, "tensor:20.0", {}),
    "slow_speed_number": (1, 2000, 1, SR, 1.3, 20.0, {}),
    "no_decorrelation": (1, 600, 2, SR, 0.2, 343.0,
                         dict(decorrelate=False)),
    "degenerate_head": (1, 600, 1, SR, 0.9, 343.0,
                        dict(head_radius=0.0, shadow=0.0)),
    "eight_khz_turned": (2, 800, 1, 8000, 12.0, 343.0, dict(shadow=1.0)),
}


def _value(v):
    if isinstance(v, str):
        kind, num = v.split(":")
        dtype = torch.float64 if kind == "f64" else torch.float32
        return torch.tensor(float(num), dtype=dtype)
    return v


@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_in_the_kernel_order_equals_the_plain_decode(name):
    n_l, n_t, n_k, sr, facing, speed, kw = CASES[name]
    facing, speed = _value(facing), _value(speed)
    opts = {**HEAD, "decorrelate": True, **kw}
    cap = capture(n_l, n_t, n_k, seed=len(name), edges=name ==
                  "clamped_edges")
    sp = spm.spatial_from_ir(cap)
    want = spm.binaural_plain(sp, sr, facing, opts["head_radius"],
                              opts["shadow"], speed, opts["decorrelate"])
    # the halo the host sizes for the kernel: a speed given as a tensor is
    # a card tensor there (meta here), which the host cannot read
    on_card = speed.to("meta") if isinstance(speed, torch.Tensor) else speed
    halo = bdk.shared_halo(opts["head_radius"], sr, on_card, n_t)
    got, past = gather(sp, sr, facing, opts["head_radius"], opts["shadow"],
                       speed, opts["decorrelate"], halo)
    assert want.shape == (2 * n_l, n_t, n_k)
    assert np.array_equal(bits(got), bits(want))
    assert float(want.abs().sum()) > 0
    # the routed entry points are the chain on the CPU
    assert np.array_equal(bits(spm.binaural_decode_ir(
        cap, sr, facing, opts["head_radius"], opts["shadow"], speed,
        decorrelate=opts["decorrelate"])), bits(want))
    lft, rgt = sp.binaural(sr, facing, speed_of_sound=speed, **opts)
    assert np.array_equal(bits(torch.cat([lft, rgt])), bits(want))
    # only the slow card-tensor speed reads past the shared halo
    assert (past > 0) == (name == "slow_speed_tensor")
    if name == "clamped_edges":
        rows, _, _ = spm.binaural_entries(sp, sr, facing,
                                          opts["head_radius"],
                                          opts["shadow"], speed)
        n = n_t
        lo_left, hi_right = rows[:n], rows[3 * n:] - n
        assert int((lo_left == 0).sum()) > 5    # clamped at bin 0
        assert int((hi_right == n_t - 1).sum()) > 5
        lo_right = rows[2 * n:3 * n] - n
        assert bool(((lo_right == n_t - 1) & (hi_right == n_t - 1)).any())


def test_window_and_halo():
    """The window of the shipped head at 72,000 bins, the whole IR where
    the shift is not finite or reaches T, and the halo: the known shift's
    window, the 100 m/s one for a card tensor, capped."""
    ms = kernel_max_shift(0.0875, SR, 343.0)
    assert abs(ms - 12.244898) < 1e-5
    assert bdk.window_half_width(ms, 72000) == 15
    assert bdk.window_half_width(float("inf"), 500) == 500
    assert bdk.window_half_width(float("nan"), 500) == 500
    assert bdk.window_half_width(600.0, 500) == 500
    assert bdk.window_half_width(0.0, 1) == 1
    assert bdk.shared_halo(0.0875, SR, 343.0, 72000) == 15
    card = torch.tensor(343.0, device="meta")
    assert bdk.max_shift_known(0.0875, SR, card) is None
    assert bdk.shared_halo(0.0875, SR, card, 72000) == \
        bdk.window_half_width(0.0875 / bdk.HALO_MIN_SPEED * SR, 72000) == 45
    assert bdk.shared_halo(0.0875, SR, 1.0, 72000) == bdk.MAX_SHARED_HALO
    # a host tensor gives the chain's float32 value
    assert bdk.max_shift_known(0.0875, SR, torch.tensor(343.0)) == float(
        (torch.tensor(np.float32(0.0875)) / torch.tensor(343.0)) * 48000.0)


def test_cpu_tensors_run_the_chain(monkeypatch):
    """A CPU capture or SpatialIR goes to the plain chain, never to the
    kernel's library, and counts no launch."""
    calls = []
    real = spm.binaural_plain

    def spy(*args, **kw):
        calls.append(args[0])
        return real(*args, **kw)

    def refuse():
        raise AssertionError("the kernel library was loaded for a CPU "
                             "tensor")

    monkeypatch.setattr(spm, "binaural_plain", spy)
    monkeypatch.setattr(build, "load_library", refuse)
    before = bdk.binaural_decode.launches
    cap = capture(1, 400, 1, seed=3)
    a = bdk.binaural_decode(cap, SR, 0.5)
    b = spm.binaural_decode_ir(cap, SR, 0.5, 0.0875, 0.6, 343.0)
    lft, rgt = spm.spatial_from_ir(cap).binaural(SR, 0.5)
    assert len(calls) == 3
    assert all(isinstance(c, spm.SpatialIR) for c in calls)
    assert torch.equal(a, b) and torch.equal(torch.cat([lft, rgt]), a)
    assert bdk.binaural_decode.launches == before


def _meta_capture(n_l=1, n_t=600, n_k=1, dtype=torch.float32):
    return torch.empty((3 * n_l, n_t, n_k), dtype=dtype, device="meta")


def _meta_sp(**edit):
    w = torch.empty((1, 600, 1), device="meta")
    sp = spm.SpatialIR(w=w, x=torch.empty_like(w), y=torch.empty_like(w))
    return sp._replace(**edit)


@pytest.mark.parametrize("what,spatial,facing,speed,shadow,match", [
    ("a float64 capture", _meta_capture(dtype=torch.float64), 0.0, 343.0,
     0.6, "capture must be torch.float32"),
    ("a capture of four rows", torch.empty((4, 600, 1), device="meta"),
     0.0, 343.0, 0.6, r"\[3L, T, K\]"),
    ("a 2-D capture", torch.empty((3, 600), device="meta"), 0.0, 343.0,
     0.6, r"\[3L, T, K\]"),
    ("an empty capture", torch.empty((0, 600, 1), device="meta"), 0.0,
     343.0, 0.6, r"\[3L, T, K\]"),
    ("no bins", _meta_capture(n_t=0), 0.0, 343.0, 0.6, "1 <= T"),
    ("no bands", _meta_capture(n_k=0), 0.0, 343.0, 0.6, "K >= 1"),
    ("past 2^24 bins", _meta_capture(n_t=(1 << 24) + 1), 0.0, 343.0, 0.6,
     "1 <= T"),
    ("x of another shape", _meta_sp(x=torch.empty((1, 599, 1),
                                                  device="meta")),
     0.0, 343.0, 0.6, "x must be"),
    ("a float64 y", _meta_sp(y=torch.empty((1, 600, 1),
                                           dtype=torch.float64,
                                           device="meta")),
     0.0, 343.0, 0.6, "y must be torch.float32"),
    ("x on another device", _meta_sp(x=torch.empty((1, 600, 1))), 0.0,
     343.0, 0.6, "x is on cpu"),
    ("two facings", _meta_capture(), torch.zeros(2, device="meta"), 343.0,
     0.6, "facing must be one floating element"),
    ("an integer facing tensor", _meta_capture(),
     torch.zeros((), dtype=torch.int32, device="meta"), 343.0, 0.6,
     "facing must be one floating element"),
    ("a float64 facing on the card", _meta_capture(),
     torch.zeros((), dtype=torch.float64, device="meta"), 343.0, 0.6,
     "facing on meta must be"),
    ("a facing that is text", _meta_capture(), "north", 343.0, 0.6,
     "facing must be a number"),
    ("two speeds", _meta_capture(), 0.0, torch.ones(2, device="meta"),
     0.6, "speed_of_sound must be one floating element"),
    ("a float16 speed on the card", _meta_capture(), 0.0,
     torch.ones((), dtype=torch.float16, device="meta"), 0.6,
     "speed_of_sound on meta must be"),
    ("a shadow past 1", _meta_capture(), 0.0, 343.0, 1.5,
     r"shadow must be in \[0, 1\]"),
    ("a negative shadow", _meta_capture(), 0.0, 343.0, -0.1,
     r"shadow must be in \[0, 1\]"),
])
def test_input_checks_before_any_launch(what, spatial, facing, speed,
                                        shadow, match):
    with pytest.raises(ValueError, match=match):
        bdk.decode_inputs(spatial, facing, speed, shadow)


def test_inputs_the_kernel_takes():
    """A capture's rows are views of it (no copy: no launch beside the
    kernel's), a CPU facing or speed tensor a host value, a card one a
    pointer; a SpatialIR's channels as they are."""
    cap = _meta_capture(n_l=2)
    w, x, y, capture_rows, facing_h, facing_t, speed_t = bdk.decode_inputs(
        cap, torch.tensor(0.25, dtype=torch.float64), 343.0, 0.6)
    assert capture_rows and facing_h == 0.25 and facing_t is None
    assert speed_t is None
    assert w.shape == x.shape == y.shape == (2, 600, 1)
    assert (w.storage_offset(), x.storage_offset(),
            y.storage_offset()) == (0, 1200, 2400)
    fac = torch.tensor(0.5, device="meta")
    speed = torch.tensor(343.0, dtype=torch.float64, device="meta")
    sp = _meta_sp()
    w, x, y, capture_rows, facing_h, facing_t, speed_t = bdk.decode_inputs(
        sp, fac, speed, 0.0)
    assert not capture_rows and facing_h is None
    assert facing_t.shape == () and speed_t.dtype == torch.float64
    assert w is sp.w and x is sp.x and y is sp.y
