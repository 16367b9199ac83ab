"""The plain reference trace: rays from a source through a 2D wall scene
into impulse responses (IRs), in plain PyTorch.

Written from the reference Unity project's ``Trace`` compute kernel
(``Raytrace2D.compute:49-172`` of clarkipeng/RealisticAudioRaytracing2D)
in the operation order of the measured program's plain trace, so float32
rays follow the same paths. Per ray: stratified jittered emission
(``(i + jitter) / R * 2 pi``); then each bounce finds the nearest wall,
captures the ray at a listener circle it crosses before the wall while
outside every wall (energy over the squared path length, at least 1),
adds a next-event estimate from the hit point to each listener that no
wall occludes (``cos * 0.5 / d^2`` of the absorbed-off energy, above a
cutoff), takes the wall's absorption, dies under an energy cutoff, and
either transmits (refracted, Snell, the medium's speed changing) or
reflects (a lerp between the mirror and a diffuse direction by the
wall's scattering). Every hit deposits its energy into the IR bin
``floor(delay * sample_rate)``.

The reference differs from the program on purpose where that makes it
plainer or more exact: the deposit sums in float64 (the program in fixed
point), only the rays that are alive and the shadow rays that are heard
are swept (the others' results are never read), and rays run in slices
so that the ``[rays, walls]`` temporaries fit. Any float dtype runs: the
lower-precision control is this trace in bfloat16.

No code of the measured program is imported.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from . import philox

EPS = 1e-4
INF = 1e8
PI = 3.14159265
ENERGY_CUTOFF = 1e-3
NEE_CUTOFF = 1e-5
OCCLUSION_SLACK = 0.1
# elements of one [rays, walls] temporary
PAIRS_PER_SLICE = 1 << 26
# rays of one group of (entry, frame) planes
RAYS_PER_GROUP = 1 << 24


class Tables(NamedTuple):
    """Wall tables ``[E, W]`` of E scenes (entries), each field a tensor:
    start x/y, edge vector x/y, the cross constant, normal x/y; absorption
    ``[E, W, K]``, scattering, transmission, ior ``[E, W]``."""

    ax: torch.Tensor
    ay: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    cc: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    absorption: torch.Tensor
    scattering: torch.Tensor
    transmission: torch.Tensor
    ior: torch.Tensor

    @property
    def n_walls(self) -> int:
        return self.ax.shape[-1]


def tables(scenes, dtype, device) -> Tables:
    """Stack ``scenes`` (``scenes.Walls``, one per entry, equal wall
    counts) into :class:`Tables` of ``dtype`` on ``device``."""
    def t(name, col=None):
        arrs = [getattr(s, name) if col is None else getattr(s, name)[:, col]
                for s in scenes]
        return torch.stack([torch.as_tensor(a) for a in arrs]).to(
            device=device, dtype=dtype)

    ax, ay = t("a", 0), t("a", 1)
    vx = t("b", 0) - ax
    vy = t("b", 1) - ay
    cc = vx * ay - vy * ax
    return Tables(ax, ay, vx, vy, cc, t("normal", 0), t("normal", 1),
                  t("absorption"), t("scattering"), t("transmission"),
                  t("ior"))


class Pose(NamedTuple):
    """Per entry: source ``[E, 2]``, listeners ``[E, L, 2]``; the listener
    radius, speed of sound and input gain are numbers shared by all."""

    source: torch.Tensor
    listeners: torch.Tensor
    radius: float
    speed: float
    gain: float


def _pick(field: torch.Tensor, ent: Optional[torch.Tensor]):
    """Rows of a per-entry table for each ray (``[1, ...]`` when the batch
    has one entry: it broadcasts)."""
    return field[:1] if ent is None else field[ent]


def _dot(ux, uy, vx, vy):
    return ux * vx + uy * vy


def _hit_distance(ox, oy, dx, dy, w: Tables, ent):
    """Distances ``[n, W]`` along rays ``o + t d`` (``[n, 1]`` each) to every
    wall of their entry; INF where the ray misses the segment."""
    ax, ay = _pick(w.ax, ent), _pick(w.ay, ent)
    vx, vy, cc = _pick(w.vx, ent), _pick(w.vy, ent), _pick(w.cc, ent)
    dotp = vy * dx - vx * dy
    n1 = vx * oy - vy * ox - cc
    n2 = (oy * dx - ox * dy) - (ay * dx - ax * dy)
    safe = torch.where(dotp.abs() < EPS, 1.0, dotp)
    t1 = n1 / safe
    t2 = n2 / safe
    ok = (dotp.abs() >= EPS) & (t1 >= EPS) & (t2 >= 0.0) & (t2 <= 1.0)
    return torch.where(ok, t1, INF)


def _nearest(t: torch.Tensor):
    """The least distance and the FIRST wall that gives it (the row's first
    NaN where one is present: ``min`` takes the lower index on a tie and
    lets a NaN win), -1 where nothing is hit."""
    closest, idx = t.min(dim=-1)
    return closest, torch.where(closest >= INF, -1, idx)


def _sliced(n: int, w: int):
    step = max(1, PAIRS_PER_SLICE // max(1, w))
    return [slice(i, min(n, i + step)) for i in range(0, n, step)]


def _circle(ox, oy, dx, dy, cx, cy, radius):
    """Distance along rays to listener circles (entry point preferred past
    EPS, else the exit), INF where the ray misses."""
    lx, ly = cx - ox, cy - oy
    tca = _dot(lx, ly, dx, dy)
    d2 = _dot(lx, ly, lx, ly) - tca * tca
    r2 = radius * radius
    inside = (tca >= 0.0) & (d2 <= r2)
    pos = (r2 - d2) > 0.0
    disc = torch.where(inside & pos, r2 - d2, 1.0)
    thc = torch.where(inside & pos, torch.sqrt(disc), 0.0)
    t0, t1 = tca - thc, tca + thc
    t = torch.where(t0 > EPS, t0, torch.where(t1 > EPS, t1, INF))
    return torch.where(inside, t, INF)


def _rotate(x, y, angle):
    s, c = torch.sin(angle), torch.cos(angle)
    return x * c - y * s, x * s + y * c


def _normalize(x, y, eps=1e-20):
    n2 = _dot(x, y, x, y)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp(n2, min=eps)),
                      0.0)
    return x * inv, y * inv


class Work(NamedTuple):
    """What the trace needed: ray-bounces of rays alive at the start of
    their bounce (each sweeps every wall for the nearest hit) and shadow
    rays heard (each sweeps every wall for an occluder)."""

    alive: int
    heard: int


class Deposits:
    """IR sums ``[E, L, T, K]`` in ``acc_dtype``; :meth:`add` takes hit
    records of rays of known entries."""

    def __init__(self, n_entries, n_listeners, ir_length, n_bands,
                 sample_rate, acc_dtype, device):
        self.t = ir_length
        self.sr = sample_rate
        self.sum = torch.zeros(n_entries * n_listeners * (ir_length + 1),
                               n_bands, dtype=acc_dtype, device=device)
        self.n_l = n_listeners
        self.shape = (n_entries, n_listeners, ir_length + 1, n_bands)

    def add(self, ent, delay, energy, valid):
        """``delay``, ``valid`` ``[n, L]``, ``energy`` ``[n, L, K]`` of rays of
        entries ``ent`` ``[n]``."""
        bins = torch.floor(delay * self.sr).to(torch.int64)
        ok = valid & (bins >= 0) & (bins < self.t)
        lis = torch.arange(self.n_l, device=bins.device)[None, :]
        rows = (ent[:, None] * self.n_l + lis) * (self.t + 1) + bins
        self.sum.index_add_(0, rows[ok], energy[ok].to(self.sum.dtype))

    def result(self) -> torch.Tensor:
        return self.sum.reshape(self.shape)[:, :, :self.t]


def trace_ir(w: Tables, pose: Pose, seed: int, *, n_rays: int,
             n_bounces: int, n_frames: int, sample_rate: int,
             ir_length: int, entries: Optional[List[int]] = None,
             entry_ids: Optional[List[int]] = None,
             frame_offset: int = 0, dtype=torch.float32,
             acc_dtype=torch.float64):
    """Frame-summed IRs ``[E, L, T, K]`` (in ``acc_dtype``) of E entries,
    and the :class:`Work` they needed. Entry ``e`` traces scene row
    ``entries[e]`` (default ``e``) with pose row ``entries[e]``, drawing the
    Philox numbers of entry id ``entry_ids[e]`` (default ``e``) for frames
    ``frame_offset ..``; ray ``r`` of frame ``f`` draws counter ``(r, f, b,
    id)``."""
    rows = list(range(pose.source.shape[0])) if entries is None \
        else list(entries)
    ids = rows if entry_ids is None else list(entry_ids)
    dev = w.ax.device
    n_e, n_l = len(rows), pose.listeners.shape[1]
    dep = Deposits(n_e, n_l, ir_length, w.absorption.shape[-1],
                   sample_rate, acc_dtype, dev)
    per_group = max(1, RAYS_PER_GROUP // (n_rays * n_frames))
    alive_n = heard_n = 0
    for g0 in range(0, n_e, per_group):
        g = list(range(g0, min(n_e, g0 + per_group)))
        a, h = _trace_group(w, pose, seed, g, rows, ids, dep, n_rays,
                            n_bounces, n_frames, frame_offset, dtype)
        alive_n += a
        heard_n += h
    return dep.result(), Work(alive_n, heard_n)


def _trace_group(w, pose, seed, group, rows, ids, dep, n_rays, n_bounces,
                 n_frames, frame_offset, dtype):
    dev = w.ax.device
    k = w.absorption.shape[-1]
    single = w.ax.shape[0] == 1
    # the rays of the group: entry slot, scene row, Philox id, frame, ray
    n = len(group) * n_frames * n_rays
    slot = torch.tensor(group, device=dev).repeat_interleave(
        n_frames * n_rays)
    row = torch.tensor(rows, device=dev)[slot]
    pid = torch.tensor(ids, device=dev, dtype=torch.int64)[slot]
    frame = torch.arange(n_frames, device=dev).repeat_interleave(
        n_rays).repeat(len(group)) + frame_offset
    ray = torch.arange(n_rays, device=dev).repeat(len(group) * n_frames)
    ent = None if single else row

    # emission (Raytrace2D.compute:52)
    jitter = philox.emission_jitter(seed, ray, frame, pid,
                                    n_bounces).to(dtype)
    idx = ray.to(dtype)
    angle = (idx + jitter) / idx.new_tensor(float(n_rays)) * (2.0 * PI)
    dx, dy = torch.cos(angle), torch.sin(angle)
    src = pose.source.to(device=dev, dtype=dtype)[row]
    px, py = src[:, 0].clone(), src[:, 1].clone()
    energy = torch.full((n, k), float(pose.gain), dtype=dtype, device=dev)
    time = torch.zeros(n, dtype=dtype, device=dev)
    dist = torch.zeros(n, dtype=dtype, device=dev)
    speed = torch.full((n,), float(pose.speed), dtype=dtype, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    lis = pose.listeners.to(device=dev, dtype=dtype)
    c = torch.tensor(float(pose.speed), dtype=dtype, device=dev)
    radius = torch.tensor(float(pose.radius), dtype=dtype, device=dev)
    alive_n = heard_n = 0

    for b in range(n_bounces):
        live = alive.nonzero()[:, 0]
        alive_n += live.numel()
        for s in _sliced(live.numel(), w.n_walls):
            r = live[s]
            u = philox.ray_uniforms(seed, ray[r], frame[r], pid[r],
                                    b).to(dtype)
            heard = _bounce(w, lis, radius, c, dep, r, row[r],
                            None if single else row[r], u,
                            px, py, dx, dy, energy, time, dist, speed,
                            depth, alive, slot, dtype)
            heard_n += heard
    return alive_n, heard_n


def _bounce(w, lis_all, radius, c, dep, r, row, ent, u, px, py, dx, dy,
            energy, time, dist, speed, depth, alive, slot, dtype):
    """One bounce of rays ``r`` (alive), updating the state tensors in
    place and depositing their hits. Returns the shadow rays heard."""
    ox, oy = px[r][:, None], py[r][:, None]
    ddx, ddy = dx[r][:, None], dy[r][:, None]
    st_e, st_t, st_d = energy[r], time[r], dist[r]
    st_s, st_depth = speed[r], depth[r]

    closest, hit = _nearest(_hit_distance(ox, oy, ddx, ddy, w, ent))
    hit_wall = hit >= 0

    # direct capture at the listener circles, only outside walls
    lis = lis_all[row]                                       # [n, L, 2]
    lx, ly = lis[..., 0], lis[..., 1]
    t_lis = _circle(ox, oy, ddx, ddy, lx, ly, radius)        # [n, L]
    direct_ok = (st_depth == 0)[:, None] & (t_lis < closest[:, None]) \
        & (t_lis < INF)
    total = st_d[:, None] + t_lis
    direct_e = st_e[:, None, :] / torch.clamp(total * total,
                                              min=1.0)[..., None]
    direct_delay = st_t[:, None] + t_lis / st_s[:, None]

    # advance to the wall
    adv = torch.where(hit_wall, closest, 0.0)
    qx = ox[:, 0] + ddx[:, 0] * adv
    qy = oy[:, 0] + ddy[:, 0] * adv
    t_new = st_t + adv / st_s
    d_new = st_d + adv

    widx = torch.where(hit_wall, hit, 0)
    wrow = row if ent is not None else torch.zeros_like(row)
    wnx, wny = w.nx[wrow, widx], w.ny[wrow, widx]
    w_abs = w.absorption[wrow, widx]                         # [n, K]
    w_scat = w.scattering[wrow, widx]
    w_trans = w.transmission[wrow, widx]
    w_ior = w.ior[wrow, widx]

    # next-event estimate with occlusion (compute:101-119)
    sx, sy = qx + wnx * EPS, qy + wny * EPS
    tx, ty = lx - qx[:, None], ly - qy[:, None]
    d_lis = torch.sqrt(torch.clamp(_dot(tx, ty, tx, ty), min=1e-20))
    vdx = (lx - sx[:, None]) / d_lis
    vdy = (ly - sy[:, None]) / d_lis
    sign = torch.where(_dot(ddx[:, 0], ddy[:, 0], wnx, wny) > 0.0, -1.0,
                       1.0).to(dtype)
    enx, eny = wnx * sign, wny * sign
    ux, uy = tx / d_lis, ty / d_lis
    cos_t = torch.clamp(_dot(enx[:, None], eny[:, None], ux, uy), min=0.0)
    total_n = d_new[:, None] + d_lis
    geom = cos_t * 0.5 / (total_n * total_n)
    nee_e = st_e[:, None, :] * (1.0 - w_abs)[:, None, :] * geom[..., None]
    heard = hit_wall[:, None] & (st_depth == 0)[:, None] \
        & (nee_e.amax(dim=-1) > NEE_CUTOFF)
    limit = d_lis - OCCLUSION_SLACK
    occ = torch.full_like(limit, INF)
    hr, hl = heard.nonzero(as_tuple=True)
    if hr.numel():
        hx, hy = sx[hr][:, None], sy[hr][:, None]
        hent = None if ent is None else ent[hr]
        mins = []
        for s in _sliced(hr.numel(), w.n_walls):
            t = _hit_distance(hx[s], hy[s], vdx[hr[s], hl[s]][:, None],
                              vdy[hr[s], hl[s]][:, None], w,
                              None if hent is None else hent[s])
            mins.append(t.min(dim=-1).values)
        occ[hr, hl] = torch.cat(mins)
    nee_ok = heard & (occ >= limit)
    nee_delay = t_new[:, None] + d_lis / c

    ents = slot[r]
    dep.add(ents, direct_delay, direct_e, direct_ok)
    dep.add(ents, nee_delay, nee_e, nee_ok)

    # absorption and the energy cutoff (compute:121-122)
    e_new = st_e * torch.where(hit_wall[:, None], 1.0 - w_abs, 1.0)
    live = hit_wall & (e_new.amax(dim=-1) >= ENERGY_CUTOFF)

    # transmission with refraction (compute:124-147)
    into = _dot(ddx[:, 0], ddy[:, 0], wnx, wny) < 0.0
    flip = torch.where(into, 1.0, -1.0).to(dtype)
    nnx, nny = wnx * flip, wny * flip
    wall_speed = c / w_ior
    next_speed = torch.where(into, wall_speed,
                             torch.where(st_depth <= 1, c, wall_speed))
    eta = next_speed / st_s
    cosi = -_dot(ddx[:, 0], ddy[:, 0], nnx, nny)
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr_ok = cost2 > 0.0
    root = torch.sqrt(torch.where(refr_ok, cost2, 1.0))
    fx = (eta * ddx[:, 0] + (eta * cosi - root) * nnx) * refr_ok.to(dtype)
    fy = (eta * ddy[:, 0] + (eta * cosi - root) * nny) * refr_ok.to(dtype)
    transmit = (u[:, 0] < w_trans) & refr_ok
    jitter = (u[:, 1] - 0.5) * 2.0 * w_scat
    trx, try_ = _normalize(*_rotate(fx, fy, jitter))

    # reflection: specular / diffuse lerp (compute:149-154)
    dd = _dot(ddx[:, 0], ddy[:, 0], nnx, nny)
    spx = ddx[:, 0] - 2.0 * dd * nnx
    spy = ddy[:, 0] - 2.0 * dd * nny
    diff = torch.asin(torch.clamp(2.0 * u[:, 2] - 1.0, -1.0, 1.0))
    dfx, dfy = _rotate(nnx, nny, diff)
    rfx, rfy = _normalize(spx + (dfx - spx) * w_scat,
                          spy + (dfy - spy) * w_scat)

    new_dx = torch.where(transmit, trx, rfx)
    new_dy = torch.where(transmit, try_, rfy)
    new_speed = torch.where(transmit, next_speed, st_s)
    new_depth = torch.where(
        transmit, torch.where(into, st_depth + 1,
                              torch.clamp(st_depth - 1, min=0)), st_depth)
    qx = qx + torch.where(transmit, new_dx * EPS, nnx * EPS)
    qy = qy + torch.where(transmit, new_dy * EPS, nny * EPS)

    keep = r[live]
    px[keep], py[keep] = qx[live], qy[live]
    dx[keep], dy[keep] = new_dx[live], new_dy[live]
    energy[keep] = e_new[live]
    time[keep], dist[keep] = t_new[live], d_new[live]
    speed[keep], depth[keep] = new_speed[live], new_depth[live]
    alive[r] = live
    return int(hr.numel())
