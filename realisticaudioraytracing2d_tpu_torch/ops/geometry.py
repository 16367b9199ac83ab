"""Geometry primitives (PyTorch): ray-segment / ray-circle intersection,
reflection, refraction, rotation.

Port of ``realisticaudioraytracing2d_tpu/ops/geometry.py`` (spec:
``Assets/Script/Common.hlsl:14-43``). Every function broadcasts over
leading dims, and keeps the JAX version's operation order so float32
results agree to the last bit wherever both libraries round the same.

* Points and directions are float32 tensors whose last axis is 2 (x, y).
* Missing intersections return ``INF`` (1e8), exactly like the reference.
"""

from __future__ import annotations

import torch

# Constants match Common.hlsl:4-6.
EPS = 1e-4
INF = 1e8
PI = 3.14159265


def perp(d: torch.Tensor) -> torch.Tensor:
    """90-degree counter-clockwise rotation: (x, y) -> (-y, x)."""
    return torch.stack([-d[..., 1], d[..., 0]], dim=-1)


def dot2(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]


def cross2(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """z-component of the 2D cross product."""
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def rotate(v: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate 2D vectors by ``angle`` radians (broadcasts over leading dims)."""
    s, c = torch.sin(angle), torch.cos(angle)
    return torch.stack(
        [v[..., 0] * c - v[..., 1] * s, v[..., 0] * s + v[..., 1] * c],
        dim=-1)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize; zero vectors stay zero."""
    n2 = dot2(v, v)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp(n2, min=eps)),
                      0.0)
    return v * inv[..., None]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """HLSL ``reflect``: d - 2*dot(d, n)*n."""
    return d - 2.0 * dot2(d, n)[..., None] * n


def ray_segment_intersect(o, d, a, b) -> torch.Tensor:
    """Parametric distance along ray ``o + t*d`` to segment ``[a, b]``:
    ``t`` when ``t >= EPS`` and the segment parameter lies in [0, 1],
    else ``INF`` (``Common.hlsl:14-21``)."""
    v1 = o - a
    v2 = b - a
    v3 = perp(d)
    dotp = dot2(v2, v3)
    safe = torch.where(dotp.abs() < EPS, 1.0, dotp)
    t1 = cross2(v2, v1) / safe
    t2 = dot2(v1, v3) / safe
    valid = (dotp.abs() >= EPS) & (t1 >= EPS) & (t2 >= 0.0) & (t2 <= 1.0)
    return torch.where(valid, t1, INF)


def segment_numerators(o, d, a, b):
    """``(n1, n2, dotp)`` of :func:`pairwise_ray_segment_t`, in its
    operation order: ``t1 = n1 / dotp`` is the distance along the ray and
    ``t2 = n2 / dotp`` the position along the segment."""
    ox, oy = o[..., 0:1], o[..., 1:2]
    dx, dy = d[..., 0:1], d[..., 1:2]
    ax, ay = a[..., 0], a[..., 1]
    v2x = b[..., 0] - ax
    v2y = b[..., 1] - ay
    cross_const = v2x * ay - v2y * ax
    dotp = v2y * dx - v2x * dy
    n1 = v2x * oy - v2y * ox - cross_const
    n2 = (oy * dx - ox * dy) - (ay * dx - ax * dy)
    return n1, n2, dotp


def exact_from_numerators(n1, n2, dotp) -> torch.Tensor:
    """The exact test on given numerators: ``t1`` where the pair hits,
    else ``INF`` (the last three lines of :func:`pairwise_ray_segment_t`)."""
    safe = torch.where(dotp.abs() < EPS, 1.0, dotp)
    t1 = n1 / safe
    t2 = n2 / safe
    valid = (dotp.abs() >= EPS) & (t1 >= EPS) & (t2 >= 0.0) & (t2 <= 1.0)
    return torch.where(valid, t1, INF)


def pairwise_ray_segment_t(o, d, a, b) -> torch.Tensor:
    """All-pairs ray-segment distances: rays ``[..., R, 2]`` x segments
    ``[W, 2]`` -> ``t[..., R, W]`` (the trace loop's hot computation,
    ``Raytrace2D.compute:69-72``)."""
    return exact_from_numerators(*segment_numerators(o, d, a, b))


# Slacks of ray_segment_maybe (csrc/trace_common.cuh: kSlackHi, kSlackLo,
# kEpsLo), as float32 values.
_SLACK_HI = 1.000001
_SLACK_LO = -1e-6
_EPS_LO = 9.9999e-5


def maybe_from_numerators(n1, n2, dotp, tmax=INF) -> torch.Tensor:
    """The division-free filter on given numerators (float32 tensors):
    False only where :func:`exact_from_numerators` gives ``INF`` or a
    distance above ``tmax``. With ``a = |dotp|`` and ``m = n *
    sign(dotp)`` (so ``n / dotp = m / a`` exactly), ``t2`` in [0, 1] needs
    ``m2`` in [0, a] and ``t1`` in [EPS, tmax] needs ``m1`` in [EPS * a,
    tmax * a]. Each limit is widened by a relative 1e-6, far more than
    the rounding of the products it is compared with (6e-8) and of a
    quotient at the edges (a quotient up to 1 + 2^-24 rounds to 1, a tiny
    negative one underflows to -0 and passes ``>= 0``), so the filter
    never rejects a pair the exact test accepts. A NaN fails every
    comparison and is kept."""
    mag = dotp.abs()
    m1 = torch.where(dotp < 0.0, -n1, n1)
    m2 = torch.where(dotp < 0.0, -n2, n2)
    f32 = dotp.new_tensor
    tmax_s = torch.clamp(torch.as_tensor(tmax, dtype=dotp.dtype,
                                         device=dotp.device), min=0.0) \
        * f32(_SLACK_HI)
    miss = (mag < EPS) | (m2 < mag * f32(_SLACK_LO)) \
        | (m2 > mag * f32(_SLACK_HI)) | (m1 < mag * f32(_EPS_LO)) \
        | (m1 > mag * tmax_s)
    return ~miss


def ray_segment_maybe(o, d, a, b, tmax=INF) -> torch.Tensor:
    """Plain float32 mirror of the kernels' division-free filter
    (``csrc/trace_common.cuh::wall_straddles`` and
    ``wall_in_reach`` together), for rays ``[..., R, 2]`` x
    segments ``[W, 2]`` -> bool ``[..., R, W]``: False only where
    :func:`pairwise_ray_segment_t` gives ``INF`` or a distance above
    ``tmax`` (a number or ``[..., R, 1]``). The kernels run the exact test
    with its two divides only where this is True."""
    return maybe_from_numerators(*segment_numerators(o, d, a, b), tmax)


def ray_circle_intersect(o, d, center, radius) -> torch.Tensor:
    """Nearest positive distance along ray to a circle, else ``INF``
    (``Common.hlsl:23-36``): entry point preferred when > EPS, else exit."""
    L = center - o
    tca = dot2(L, d)
    d2 = dot2(L, L) - tca * tca
    r2 = radius * radius
    inside = (tca >= 0.0) & (d2 <= r2)
    pos = (r2 - d2) > 0.0
    disc = torch.where(inside & pos, r2 - d2, 1.0)
    thc = torch.where(inside & pos, torch.sqrt(disc), 0.0)
    t0 = tca - thc
    t1 = tca + thc
    t = torch.where(t0 > EPS, t0, torch.where(t1 > EPS, t1, INF))
    return torch.where(inside, t, INF)


def refract(i, n, eta):
    """Snell refraction of direction ``i`` across normal ``n`` with
    relative index ``eta``. Returns ``(t, ok)``; ``t`` is zero where
    ``ok`` is False (total internal reflection, ``Common.hlsl:38-43``).

    Double ``where``, as in :func:`ray_circle_intersect`: the JAX function
    takes ``sqrt(|cost2|)``, whose backward is inf at ``cost2 == 0``,
    and the mask turns it into inf * 0 = NaN (SmollRoom's gradients at
    15,000 rays, in JAX too). Where its value is discarded sqrt gets 1;
    where ``ok`` the values are the JAX function's bit for bit."""
    cosi = -dot2(i, n)
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    ok = cost2 > 0.0
    root = torch.sqrt(torch.where(ok, cost2, 1.0))
    t = eta[..., None] * i + (eta * cosi - root)[..., None] * n
    return t * ok[..., None].to(t.dtype), ok


def nearest_hit(t: torch.Tensor):
    """Reduce pairwise distances ``t[..., W]`` to (closest[...], index[...]).

    The index is the FIRST wall among equal minima (the JAX oracle's
    ``argmin`` rule, which the hand kernel keeps by scanning walls in
    ascending order with a strict ``<``), and -1 when nothing was hit. A
    row holding a NaN has a NaN minimum, which equals no entry: its index
    is that of its first NaN, as ``jnp.argmin`` gives, so every index
    lies in ``[-1, W)``."""
    closest = t.min(dim=-1).values
    ids = torch.arange(t.shape[-1], dtype=torch.int32, device=t.device)
    at_min = (t == closest[..., None]) | torch.isnan(t)
    idx = torch.where(at_min, ids,
                      t.shape[-1]).min(dim=-1).values.to(torch.int32)
    return closest, torch.where(closest >= INF, -1, idx).to(torch.int32)
