"""The plain reference of a head's spatial capture and of its binaural
decode, in plain PyTorch.

**The capture.** The head is traced as three coincident virtual
microphones with power patterns ``g = c0 + c1 cos(theta) + c2 sin(theta)``
(omni ``[1, 0, 0]``, a cardioid aimed at 0 ``[1, 1, 0]``, one aimed at
pi/2 ``[1, 0, 1]``), clamped at zero, at the direction ``theta`` the sound
arrives from: against the ray for a direct capture, from the bounce point
for a next-event estimate. The rays are those of :mod:`.physics`
(``physics._bounce`` runs every bounce, in the program's float32
operation order, its deposits summed in float64); the three microphones
share the head's position, so every ray's geometry, cutoffs and
occlusion are the head's, computed once, and only each deposit's gain
differs. Per bin, ``W = omni``, ``X = C0 - W`` and ``Y = C90 - W`` are
the energy and the energy-weighted cosine and sine of the arrival angle.

**The decode** (DirAC style): per bin the coherent part ``min(|(X, Y)|,
W)`` arrives from ``atan2(Y, X)``; at the ear at ``facing +- pi/2`` (left
``+``) it takes the plane-wave delay ``-+ (r / c) sin(phi)`` (``phi`` the
bearing relative to ``facing``), clamped to the IR before its fraction is
taken, as a linear two-bin splat, and the head-shadow gain ``1 +- shadow
sin(phi)``. The diffuse rest ``W - coherent`` reaches each ear whole,
times the ear's deterministic random signs.

The capture runs in the trace's dtype; the decode in the dtype of its
inputs (float64 for the comparison, bfloat16 for the control). One band.
No code of the measured program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import philox, physics

# omni, cardioid at 0, cardioid at pi/2: [c0, c_cos, c_sin]
PATTERNS = ((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (1.0, 0.0, 1.0))


def gains(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """The microphones' gains ``[n, 3]`` for sound arriving from the
    direction whose cosine and sine are ``cx``, ``cy`` ``[n]``: ``(c0 +
    c1 cx) + c2 cy``, clamped at zero."""
    return torch.stack([torch.clamp((c0 + c1 * cx) + c2 * cy, min=0.0)
                        for c0, c1, c2 in PATTERNS], dim=-1)


class _MicDeposits(physics.Deposits):
    """The three microphones' IR sums. ``physics._bounce`` hands each of
    its two deposits (the direct captures, then the next-event estimates)
    for the head alone, ``[n, 1]``; :meth:`add` weights them by the gains
    :func:`capture` queued for them, in that order."""

    def __init__(self, ir_length, sample_rate, acc_dtype, device):
        super().__init__(1, len(PATTERNS), ir_length, 1, sample_rate,
                         acc_dtype, device)
        self.queue = []

    def add(self, ent, delay, energy, valid):
        g = self.queue.pop(0)                                  # [n, 3]
        m = len(PATTERNS)
        super().add(ent, delay.expand(-1, m), energy * g[..., None],
                    valid.expand(-1, m))


def _arrival_gains(w, head, ox, oy, dx, dy, ent):
    """The gains of a bounce's two deposits for rays at ``o`` going ``d``
    (``[n]`` each), as ``physics._bounce`` places them: the direct capture
    arrives against the ray, the next-event estimate from the point where
    the ray meets its nearest wall (the ray's origin where it meets
    none)."""
    closest, hit = physics._nearest(physics._hit_distance(
        ox[:, None], oy[:, None], dx[:, None], dy[:, None], w, ent))
    adv = torch.where(hit >= 0, closest, 0.0)
    qx = ox + dx * adv
    qy = oy + dy * adv
    tx, ty = head[0] - qx, head[1] - qy
    d_lis = torch.sqrt(torch.clamp(physics._dot(tx, ty, tx, ty), min=1e-20))
    return gains(-dx, -dy), gains(-(tx / d_lis), -(ty / d_lis))


def capture(w: physics.Tables, source, head, seed: int, *, n_rays: int,
            n_bounces: int, sample_rate: int, ir_length: int, radius: float,
            speed: float, gain: float, dtype=torch.float32,
            acc_dtype=torch.float64):
    """One frame of the three-microphone capture of a head at ``head``
    (``[2]``) from ``source`` (``[2]``) in the one scene of ``w``, drawing
    the Philox numbers of ``seed`` (entry 0, frame 0). Returns the IRs
    ``[3, T]`` (omni, cardioid 0, cardioid 90; in ``acc_dtype``) and the
    :class:`physics.Work` they needed (each shadow ray counted once: the
    microphones share it)."""
    dev = w.ax.device
    dep = _MicDeposits(ir_length, sample_rate, acc_dtype, dev)
    ray = torch.arange(n_rays, device=dev)
    zero = torch.zeros_like(ray)
    # emission (Raytrace2D.compute:52), as physics._trace_group
    jitter = philox.emission_jitter(seed, ray, zero, zero, n_bounces).to(dtype)
    idx = ray.to(dtype)
    angle = (idx + jitter) / idx.new_tensor(float(n_rays)) * (2.0 * physics.PI)
    dx, dy = torch.cos(angle), torch.sin(angle)
    src = torch.as_tensor(source).to(device=dev, dtype=dtype)
    px = src[0].expand(n_rays).clone()
    py = src[1].expand(n_rays).clone()
    energy = torch.full((n_rays, 1), float(gain), dtype=dtype, device=dev)
    time = torch.zeros(n_rays, dtype=dtype, device=dev)
    dist = torch.zeros(n_rays, dtype=dtype, device=dev)
    speed_t = torch.full((n_rays,), float(speed), dtype=dtype, device=dev)
    depth = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    alive = torch.ones(n_rays, dtype=torch.bool, device=dev)
    slot = torch.zeros(n_rays, dtype=torch.int64, device=dev)
    lis = torch.as_tensor(head).to(device=dev, dtype=dtype)
    c = torch.tensor(float(speed), dtype=dtype, device=dev)
    rad = torch.tensor(float(radius), dtype=dtype, device=dev)
    alive_n = heard_n = 0
    for b in range(n_bounces):
        live = alive.nonzero()[:, 0]
        alive_n += live.numel()
        for s in physics._sliced(live.numel(), w.n_walls):
            r = live[s]
            u = philox.ray_uniforms(seed, ray[r], zero[r], zero[r],
                                    b).to(dtype)
            dep.queue = list(_arrival_gains(w, lis, px[r], py[r], dx[r],
                                            dy[r], None))
            heard_n += physics._bounce(
                w, lis[None, None], rad, c, dep, r, zero[r], None, u, px,
                py, dx, dy, energy, time, dist, speed_t, depth, alive, slot,
                dtype)
    return dep.result()[0, :, :, 0], physics.Work(alive_n, heard_n)


def signs(n_t: int, ear: int, like: torch.Tensor) -> torch.Tensor:
    """The ear's deterministic random signs ``[T]`` (+-1; ear 0 left, 1
    right) that decorrelate the diffuse field, as ``like``'s dtype and
    device."""
    rng = np.random.default_rng(0xD1FF05E ^ (ear * 0x9E3779B9))
    return torch.as_tensor(rng.integers(0, 2, n_t) * 2.0 - 1.0).to(
        device=like.device, dtype=like.dtype)


def max_shift(sample_rate: int, head_radius: float, speed: float) -> float:
    """The largest interaural delay, in bins: ``r / c * sample_rate``."""
    return head_radius / speed * sample_rate


def decode(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, facing: float,
           *, sample_rate: int, head_radius: float, shadow: float,
           speed: float, decorrelate: bool = True) -> torch.Tensor:
    """The two ears' IRs ``[2, T]`` (left, right) of the channels ``W``,
    ``X``, ``Y`` ``[T]`` heard by a head facing ``facing`` (radians)."""
    n_t = w.shape[-1]
    coh = torch.minimum(torch.sqrt(x * x + y * y), w)
    dif = w - coh
    s = torch.sin(torch.atan2(y, x) - facing)
    bins = torch.arange(n_t, device=w.device).to(w.dtype)
    shift = max_shift(sample_rate, head_radius, speed)
    out = []
    for ear, sign in enumerate((1.0, -1.0)):
        t = torch.clamp(bins - sign * shift * s, 0.0, float(n_t - 1))
        lo = torch.floor(t)
        frac = t - lo
        # (a no-op but in a precision too coarse to hold the last bin)
        lo = lo.to(torch.int64).clamp(0, n_t - 1)
        hi = torch.clamp(lo + 1, max=n_t - 1)
        e = coh * (1.0 + sign * shadow * s)
        ear_ir = torch.zeros_like(w)
        ear_ir.index_add_(0, lo, e * (1.0 - frac))
        ear_ir.index_add_(0, hi, e * frac)
        out.append(ear_ir + (dif * signs(n_t, ear, w) if decorrelate
                             else dif))
    return torch.stack(out)
