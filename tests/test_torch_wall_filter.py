"""PyTorch port: the division-free wall filter never rejects a hit.

``ops/geometry.py::ray_segment_maybe`` mirrors, in float32 and in the same
operation order, the filter the CUDA kernels run before the exact
ray-segment test (``csrc/trace_common.cuh::wall_straddles`` and
``wall_in_reach``). The kernels
divide only where it says "maybe", so the one property that keeps their
bits is: wherever the exact float32 test (``pairwise_ray_segment_t``) hits
within ``tmax``, the filter says True. Checked on the float64-oracle fuzz
cases of ``tests/test_geometry.py``, on rooms of the package, and on razor
edges built on the numerators themselves: segment endpoints, ``|dotp|`` at
``EPS``, ``t1`` at ``EPS``, quotients an ulp around 0, 1 and ``tmax``,
numerators that underflow, and padding walls. The filter is also useful:
it keeps few pairs that do not hit."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_geometry import oracle_intersect
from torch_parity import CPU, to_torch

from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import geometry as g

F32 = np.float32


def _fuzz(seed, n, scale=10.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-scale, scale, (n, 2))
    ang = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(ang), np.sin(ang)], -1)
    a = rng.uniform(-scale, scale, (n, 2))
    b = rng.uniform(-scale, scale, (n, 2))
    return o, d, a, b


def _never_rejects(o, d, a, b, tmax=g.INF):
    t = g.pairwise_ray_segment_t(o, d, a, b)
    maybe = g.ray_segment_maybe(o, d, a, b, tmax)
    wanted = (t < g.INF) & (t <= tmax)
    assert not bool((wanted & ~maybe).any())
    return t, maybe


@pytest.mark.parametrize("seed,scale", [(0, 10.0), (1, 10.0), (2, 1000.0),
                                        (3, 0.01)])
def test_filter_keeps_every_hit_of_the_oracle_fuzz(seed, scale):
    o, d, a, b = _fuzz(seed, 500, scale)
    args = [to_torch(x.astype(F32)) for x in (o, d, a, b)]
    t, maybe = _never_rejects(*args)
    # pair i of the oracle fuzz is the diagonal; where the float64 oracle
    # hits and float32 agrees, the filter kept the pair
    for i in range(500):
        if oracle_intersect(o[i], d[i], a[i], b[i]) < g.INF \
                and float(t[i, i]) < g.INF:
            assert bool(maybe[i, i]), i
    # and it is a filter: hardly anything that misses gets through
    misses_kept = int((maybe & (t >= g.INF)).sum())
    assert misses_kept <= 0.001 * maybe.numel()


@pytest.mark.parametrize("tmax", [0.0, -1.0, 1e-4, 0.5, 3.0, 50.0])
def test_filter_keeps_every_hit_within_tmax(tmax):
    o, d, a, b = (to_torch(x.astype(F32)) for x in _fuzz(7, 400))
    t, maybe = _never_rejects(o, d, a, b, tmax)
    # a per-ray bound, the running closest hit of a nearest sweep
    bound = t.min(dim=-1, keepdim=True).values
    _never_rejects(o, d, a, b, bound)
    assert int(g.ray_segment_maybe(o, d, a, b, bound).sum()) \
        <= int(maybe.sum()) + int((t <= bound).sum())


@pytest.mark.parametrize("room_fn", [rooms.smoll_room, rooms.big_room,
                                     lambda device: rooms.city_scene(
                                         60, device=device)])
def test_filter_on_the_package_rooms_with_padding_walls(room_fn):
    scene = room_fn(device=CPU).scene.pad_to(512)
    o, d, _, _ = _fuzz(11, 300, 15.0)
    t, maybe = _never_rejects(to_torch(o.astype(F32)), to_torch(d.astype(F32)),
                              scene.a, scene.b)
    pad = ~scene.mask
    assert bool(pad.any()) and not bool(maybe[:, pad].any())
    assert bool((t[:, pad] == g.INF).all())


def _edge(x, ulps):
    """``x`` moved by ``ulps`` float32 steps."""
    x = np.asarray(x, F32)
    for _ in range(abs(ulps)):
        x = np.nextafter(x, F32(np.inf if ulps > 0 else -np.inf))
    return x


def _numerator_cases():
    """Adversarial (n1, n2, dotp): quotients an ulp around every limit."""
    cases = []
    for dotp in (1e-4, 1.0001e-4, 0.37, 1.0, 3.0, 977.0, 1e6):
        for sign in (1.0, -1.0):
            den = F32(sign * dotp)
            for ulps in range(-3, 4):
                # t2 around 1 and around 0, t1 well inside
                cases.append((den * F32(0.5), _edge(den, ulps), den))
                cases.append((den * F32(0.5), F32(ulps) * F32(1e-45), den))
                cases.append((den * F32(0.5), -F32(ulps) * F32(1e-45), den))
                # t1 around EPS, t2 well inside
                cases.append((_edge(den * F32(1e-4), ulps), den * F32(0.5),
                              den))
                # t1 around tmax = 2 (see the test), t2 well inside
                cases.append((_edge(den * F32(2.0), ulps), den * F32(0.5),
                              den))
    for ulps in range(-3, 4):          # |dotp| around EPS
        den = _edge(F32(1e-4), ulps)
        cases.append((den * F32(0.5), den * F32(0.5), den))
        cases.append((-den * F32(0.5), -den * F32(0.5), -den))
    for tiny in (1e-45, -1e-45, 1e-38, -1e-38, 0.0, -0.0):
        cases.append((F32(1.0), F32(tiny), F32(2.0)))   # t2 underflows
        cases.append((F32(tiny), F32(1.0), F32(2.0)))   # t1 underflows
    cases.append((F32(0.0), F32(0.0), F32(0.0)))        # a padding wall
    cases.append((F32(np.nan), F32(0.5), F32(1.0)))
    return cases


@pytest.mark.parametrize("tmax", [g.INF, 2.0])
def test_filter_on_razor_edge_numerators(tmax):
    n1, n2, dotp = (torch.tensor(np.array(x, F32))
                    for x in zip(*_numerator_cases()))
    t = g.exact_from_numerators(n1, n2, dotp)
    maybe = g.maybe_from_numerators(n1, n2, dotp, tmax)
    wanted = (t < g.INF) & (t <= tmax)
    assert int(wanted.sum()) > 50
    assert not bool((wanted & ~maybe).any())
    # the edges are real: quotients on the limit and an ulp either side
    t2 = n2 / dotp
    assert bool((t2 == 1.0).any()) and bool((t2 == 1.0 + 2.0 ** -23).any()) \
        and bool((t2 == 1.0 - 2.0 ** -24).any())


@pytest.mark.parametrize("what,o,d,a,b,hits", [
    ("t2 = 0 exactly: through endpoint a", (0, 0), (1, 0), (2, 0), (2, 1),
     True),
    ("t2 = 1 exactly: through endpoint b", (0, 0), (1, 0), (2, -1), (2, 0),
     True),
    ("t1 = EPS exactly", (2 - 1e-4, 0.5), (1, 0), (2, 0), (2, 1), None),
    ("behind the ray", (0, 0), (1, 0), (-2, -1), (-2, 1), False),
    ("parallel", (0, 0), (1, 0), (1, 1), (5, 1), False),
    ("degenerate padding wall", (0, 0), (1, 0), (0, 0), (0, 0), False),
])
def test_filter_on_named_edges(what, o, d, a, b, hits):
    args = [torch.tensor([x], dtype=torch.float32) for x in (o, d, a, b)]
    t, maybe = _never_rejects(*args)
    if hits is not None:
        assert bool(t[0, 0] < g.INF) == hits, what
        assert bool(maybe[0, 0]) == hits, what


@settings(max_examples=200, deadline=None)
@given(st.floats(-50, 50, width=32), st.floats(-50, 50, width=32),
       st.floats(0, 6.25, width=32), st.floats(-50, 50, width=32),
       st.floats(-50, 50, width=32), st.floats(-50, 50, width=32),
       st.floats(-50, 50, width=32), st.floats(0, 200, width=32))
def test_filter_never_rejects_a_hit_hypothesis(ox, oy, ang, ax, ay, bx, by,
                                               tmax):
    o = torch.tensor([[ox, oy]], dtype=torch.float32)
    d = torch.tensor([[np.cos(ang), np.sin(ang)]], dtype=torch.float32)
    a = torch.tensor([[ax, ay], [bx, by]], dtype=torch.float32)
    b = torch.tensor([[bx, by], [ax, ay]], dtype=torch.float32)
    _never_rejects(o, d, a, b)
    _never_rejects(o, d, a, b, tmax)
