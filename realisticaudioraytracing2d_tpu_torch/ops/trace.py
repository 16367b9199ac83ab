"""Batched 2D acoustic path tracing, plain PyTorch (the oracle).

Port of ``realisticaudioraytracing2d_tpu/ops/trace.py`` (spec: the
reference's ``Trace`` compute kernel, ``Raytrace2D.compute:49-156``):
stratified angular emission, a fixed-depth bounce loop with nearest-wall
intersection, direct listener-circle capture while outside walls,
next-event estimation (NEE) to the listener with occlusion, absorption
with an energy cutoff, probabilistic transmission with Snell refraction
and medium speed change, and a specular/diffuse reflection lerp.

Unlike the JAX version, the uniforms are an argument (``emit[R]``,
``u[B, R, 3]``): the parity tests pass JAX's threefry draws, production
draws them from :mod:`.rng`. The hand kernels
(``ops/cuda/bounce_kernel.py``) are held against this module on the card.

``trace(..., use_kernels=True)``, the counterpart of the JAX function's
``use_pallas``, sends the two ``[rays, walls]`` passes of every bounce (the
nearest-wall search and the NEE occlusion sweep) through the hand kernels
K1 and K2 (``ops/cuda/trace_kernel.py``), which take any listener, band
and wall count (past ``BOX_WALK_MIN_WALLS`` walls by the box walk); they
skip the rays whose results no one reads (dead rays; shadow rays off a
wall no live ray hit, inside walls or under the NEE cutoff) and stop
each shadow ray at the listener. The rest of the bounce stays tensor
code. ``n_debug > 0``
also records :class:`DebugPaths`, the ray-path gizmo of the first rays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..device import resolve
from ..models.scene import Scene
from .cuda import trace_kernel as tk
from .directivity import fourier_gain
from .geometry import (EPS, INF, PI, dot2, nearest_hit, normalize,
                       pairwise_ray_segment_t, ray_circle_intersect, reflect,
                       refract, rotate)

# Cutoffs verbatim from the reference kernel.
ENERGY_CUTOFF = 1e-3       # Raytrace2D.compute:122
NEE_CONTRIB_CUTOFF = 1e-5  # Raytrace2D.compute:111
OCCLUSION_SLACK = 0.1      # checkVis tolerance, Raytrace2D.compute:44


class TraceParams(NamedTuple):
    """Trace inputs that are not shapes. Every tensor lies on one device.
    ``directivity``: the source's Fourier power-gain coefficients ``[C]``
    (``ops/directivity.py``; ``[S, C]`` per source in a mixdown), weighted
    at emission; ``mic_directivity``: ``[C]`` shared or ``[L, C]`` per
    listener, weighted at direct capture and NEE by the direction the
    sound arrives from. None is the reference's omni emission and
    pickup."""

    source: torch.Tensor           # [2] source position ([S, 2]: mixdown)
    listeners: torch.Tensor        # [L, 2] listener centers
    listener_radius: torch.Tensor  # scalar
    speed_of_sound: torch.Tensor   # scalar
    input_gain: torch.Tensor       # scalar ([S]: per-source gains)
    directivity: Optional[torch.Tensor] = None
    mic_directivity: Optional[torch.Tensor] = None

    @staticmethod
    def make(source, listeners, listener_radius=0.5, speed_of_sound=343.0,
             input_gain=1.0, directivity=None, mic_directivity=None,
             device=None) -> "TraceParams":
        device = resolve(device)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return TraceParams(
            source=f32(source).reshape(-1, 2).squeeze(0),
            listeners=f32(listeners).reshape(-1, 2),
            listener_radius=f32(listener_radius),
            speed_of_sound=f32(speed_of_sound),
            input_gain=f32(input_gain),
            directivity=None if directivity is None else f32(directivity),
            mic_directivity=(None if mic_directivity is None
                             else f32(mic_directivity)))

    def to(self, device) -> "TraceParams":
        return TraceParams(*(None if x is None else x.to(device)
                             for x in self))


class Hits(NamedTuple):
    """Fixed-shape hit records. Axes: [bounce, slot, ray, listener] with
    slot 0 = direct circle capture, slot 1 = NEE; ``energy`` carries a
    trailing band axis [K]."""

    delay: torch.Tensor    # [B, 2, R, L] seconds
    energy: torch.Tensor   # [B, 2, R, L, K]
    valid: torch.Tensor    # [B, 2, R, L] bool

    @property
    def n_bands(self) -> int:
        return self.energy.shape[-1]


class DebugPaths(NamedTuple):
    """Per-bounce positions/energies of the first ``n_debug`` rays, the
    equivalent of the reference's ``debugRays`` gizmo buffer
    (``Raytrace2D.compute:63-64,87-88,96-97``)."""

    pos: torch.Tensor      # [B+1, D, 2]
    energy: torch.Tensor   # [B+1, D] (max over bands)
    alive: torch.Tensor    # [B+1, D] bool


class _RayState(NamedTuple):
    pos: torch.Tensor      # [R, 2]
    dir: torch.Tensor      # [R, 2]
    energy: torch.Tensor   # [R, K]
    time: torch.Tensor     # [R] accumulated seconds
    dist: torch.Tensor     # [R] accumulated path length
    speed: torch.Tensor    # [R] current medium speed
    depth: torch.Tensor    # [R] int32 wall nesting depth
    alive: torch.Tensor    # [R] bool


def check_single_source(params: TraceParams) -> None:
    """Raise ``ValueError`` unless ``params`` holds one source ``[2]``. A
    batch of sources ``[S, 2]`` belongs to
    :func:`..parallel.multisource.trace_sources_mixdown`."""
    if tuple(params.source.shape) != (2,):
        raise ValueError(
            f"this path traces one source [2], got a source of shape "
            f"{tuple(params.source.shape)}; trace S sources [S, 2] with "
            "parallel.multisource.trace_sources_mixdown")


def check_patterns(params: TraceParams) -> None:
    """Raise ``ValueError`` unless the patterns of a single-source
    ``params`` have their shapes: ``directivity`` ``[C]``,
    ``mic_directivity`` ``[C]`` or ``[L, C]``, each with an odd C."""
    n_l = params.listeners.shape[0]
    for name, c, dims in (("directivity", params.directivity, ((),)),
                          ("mic_directivity", params.mic_directivity,
                           ((), (n_l,)))):
        if c is None:
            continue
        if tuple(c.shape[:-1]) not in dims or c.dim() == 0 \
                or c.shape[-1] % 2 != 1:
            raise ValueError(
                f"{name} must be [2M+1]" + (" or [L, 2M+1]" if len(dims) > 1
                                           else "")
                + f" (L = {n_l}); got {tuple(c.shape)}")


def _check_supported(params: TraceParams) -> None:
    """Raise for a batch of sources and for patterns of the wrong shape."""
    check_single_source(params)
    check_patterns(params)


def emission_angle(n_rays: int, emit_jitter: torch.Tensor) -> torch.Tensor:
    """Stratified-jittered emission angles (``Raytrace2D.compute:52``):
    angle_i = (i + u_i) / R * 2*pi."""
    idx = torch.arange(n_rays, dtype=torch.float32,
                       device=emit_jitter.device)
    # Divide by a tensor, not a Python number: on CUDA, torch divides by a
    # host scalar as a multiply by its reciprocal, which is not IEEE
    # division: unless R is a power of two, some angles move by an ulp and
    # their rays drift from the hand kernel's (which, like the JAX oracle,
    # divides exactly).
    return (idx + emit_jitter) / idx.new_tensor(float(n_rays)) * (2.0 * PI)


def _emit(params: TraceParams, n_rays: int, n_bands: int,
          emit_jitter: torch.Tensor) -> _RayState:
    """Stratified-jittered angular emission (:func:`emission_angle`),
    each ray's energy weighted by the source pattern at its direction."""
    dev = emit_jitter.device
    angle = emission_angle(n_rays, emit_jitter)
    direction = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
    gain = params.input_gain.expand(n_rays)
    if params.directivity is not None:
        gain = gain * fourier_gain(direction[:, 0], direction[:, 1],
                                   params.directivity)
    return _RayState(
        pos=params.source.expand(n_rays, 2).clone(),
        dir=direction,
        energy=gain[:, None].expand(n_rays, n_bands).clone(),
        time=torch.zeros(n_rays, dtype=torch.float32, device=dev),
        dist=torch.zeros(n_rays, dtype=torch.float32, device=dev),
        speed=params.speed_of_sound.expand(n_rays).clone(),
        depth=torch.zeros(n_rays, dtype=torch.int32, device=dev),
        alive=torch.ones(n_rays, dtype=torch.bool, device=dev))


def _bounce(scene: Scene, params: TraceParams, st: _RayState,
            u: torch.Tensor, walls: Optional[tk.Walls] = None,
            transmission_surrogate: bool = False
            ) -> Tuple[_RayState, Tuple]:
    """One bounce for all rays; ``u[R, 3]`` are this bounce's uniforms
    (transmission test / refraction jitter / diffuse angle). When
    ``walls`` (``trace_kernel.sweep_walls``) is given, the two rays x
    walls passes run as the kernels K1 and K2 (their plain versions on the
    CPU). Returns the next state and ``(delay, energy, valid, pos,
    hit_wall)``: the hit records, the position each ray advanced to
    (offset off the wall, not frozen for a dying ray) and whether it hit
    a wall. A record that is not valid holds what the arithmetic gives for
    wall 0 where no wall was hit.

    ``transmission_surrogate=True`` swaps the hard ``u < transmission``
    branch (``Raytrace2D.compute:124``, zero pathwise gradient almost
    everywhere) for the JAX function's importance-sampled relaxation: the
    branch is drawn from a detached proposal ``q`` and the likelihood
    ratio ``t/q`` or ``(1-t)/(1-q)`` rides the continuing ray's energy,
    so the expected IR is unchanged and ``d/d(transmission)`` flows
    through the weight. With every transmission exactly 0 it is the hard
    branch bit for bit (q = 0, weight 1)."""
    listeners = params.listeners                     # [L, 2]
    c = params.speed_of_sound

    # --- nearest wall (Raytrace2D.compute:69-72) ---------------------------
    if walls is not None:    # a dead ray is not swept: (INF, -1)
        closest, hit_idx = tk.nearest_hit(st.pos, st.dir, walls, st.alive)
    else:
        t_wall = pairwise_ray_segment_t(st.pos, st.dir, scene.a, scene.b)
        closest, hit_idx = nearest_hit(t_wall)       # [R], [R]
    hit_wall = (hit_idx >= 0) & st.alive

    # --- direct listener capture, only outside walls (compute:74-84) -------
    t_lis = ray_circle_intersect(st.pos[:, None, :], st.dir[:, None, :],
                                 listeners[None, :, :],
                                 params.listener_radius)   # [R, L]
    direct_valid = (st.alive & (st.depth == 0))[:, None] \
        & (t_lis < closest[:, None]) & (t_lis < INF)
    total_d = st.dist[:, None] + t_lis
    direct_energy = st.energy[:, None, :] / \
        torch.clamp(total_d * total_d, min=1.0)[..., None]  # [R, L, K]
    mic = params.mic_directivity
    if mic is not None:
        # the sound arrives from -(ray direction)
        direct_energy = direct_energy * fourier_gain(
            -st.dir[:, 0:1], -st.dir[:, 1:2], mic)[..., None]
    direct_delay = st.time[:, None] + t_lis / st.speed[:, None]

    # --- advance to the wall (compute:92-94) --------------------------------
    adv = torch.where(hit_wall, closest, 0.0)
    pos = st.pos + st.dir * adv[:, None]
    time = st.time + adv / st.speed
    dist = st.dist + adv

    # --- gather hit-wall attributes (wall 0 for a ray that hit none) -------
    widx = torch.where(hit_wall, hit_idx, 0).long()
    w_n = scene.normal[widx]            # [R, 2]
    w_abs = scene.absorption[widx]      # [R, K]
    w_scat = scene.scattering[widx]     # [R]
    w_trans = scene.transmission[widx]  # [R]
    w_ior = scene.ior[widx]             # [R]

    # --- NEE with occlusion check (compute:101-119) -------------------------
    # Shadow ray starts offset along the *unflipped* wall normal; direction
    # is normalized by the unoffset distance — both reference quirks kept.
    nee_src = pos + w_n * EPS                                # [R, 2]
    to_lis = listeners[None, :, :] - pos[:, None, :]         # [R, L, 2]
    dist_lis = torch.sqrt(torch.clamp(dot2(to_lis, to_lis), min=1e-20))
    vis_dir = (listeners[None, :, :] - nee_src[:, None, :]) \
        / dist_lis[..., None]

    eff_sign = torch.where(dot2(st.dir, w_n) > 0.0, -1.0, 1.0)  # [R]
    eff_n = w_n * eff_sign[:, None]
    unit = to_lis / dist_lis[..., None]                       # [R, L, 2]
    cos_t = torch.clamp(dot2(eff_n[:, None, :], unit), min=0.0)
    total_d_nee = dist[:, None] + dist_lis
    geom = cos_t * 0.5 / (total_d_nee * total_d_nee)          # [R, L]
    nee_energy = st.energy[:, None, :] * (1.0 - w_abs)[:, None, :] \
        * geom[..., None]                                     # [R, L, K]
    heard = hit_wall[:, None] & (st.depth == 0)[:, None] \
        & (nee_energy.amax(dim=-1) > NEE_CONTRIB_CUTOFF)     # [R, L]
    limit = dist_lis - OCCLUSION_SLACK
    if walls is not None:
        # only the shadow rays NEE reads, each only up to its listener:
        # the minimum where it is below the limit, INF elsewhere
        occ_min = tk.occlusion_min(nee_src[:, None, :].expand_as(vis_dir),
                                   vis_dir, walls, heard, limit)
    else:
        t_occ = pairwise_ray_segment_t(nee_src[:, None, :], vis_dir,
                                       scene.a, scene.b)     # [R, L, W]
        occ_min = t_occ.min(dim=-1).values
    nee_valid = heard & (occ_min >= limit)
    if mic is not None:
        # after the cutoff, which tests the path and not the pickup; the
        # sound arrives from the bounce point, -unit
        nee_energy = nee_energy * fourier_gain(
            -unit[..., 0], -unit[..., 1], mic)[..., None]
    # Listener leg uses the *rest-frame* speed of sound, matching the
    # reference (compute:114 divides by speedOfSound, not curSpeed).
    nee_delay = time[:, None] + dist_lis / c

    # --- absorption + cutoff (compute:121-122) ------------------------------
    energy = st.energy * torch.where(hit_wall[:, None], 1.0 - w_abs, 1.0)
    alive = hit_wall & (energy.amax(dim=-1) >= ENERGY_CUTOFF)

    # --- transmission w/ refraction (compute:124-147) -----------------------
    entering = dot2(st.dir, w_n) < 0.0
    n_eff = w_n * torch.where(entering, 1.0, -1.0)[:, None]
    wall_speed = c / w_ior
    next_speed = torch.where(entering, wall_speed,
                             torch.where(st.depth <= 1, c, wall_speed))
    eta = next_speed / st.speed
    refr, refr_ok = refract(st.dir, n_eff, eta)
    if transmission_surrogate:
        t_det = w_trans.detach()
        # the proposal follows the detached t, clipped away from 0 and 1 so
        # both branches keep support where t lies inside (0, 1); q = 0
        # where t == 0 keeps those rays on the reflect branch, weight 1
        q = torch.where(t_det > 0.0, torch.clamp(t_det, 0.05, 0.95), 0.0)
        transmit = (u[:, 0] < q) & refr_ok
        w_branch = torch.where(
            transmit, w_trans / torch.clamp(q, min=1e-6),
            (1.0 - w_trans) / (1.0 - q))
        w_branch = torch.where(refr_ok, w_branch, 1.0)
    else:
        transmit = (u[:, 0] < w_trans) & refr_ok
    jitter = (u[:, 1] - 0.5) * 2.0 * w_scat
    trans_dir = normalize(rotate(refr, jitter))

    # --- reflection: specular/diffuse lerp (compute:149-154) ----------------
    spec_dir = reflect(st.dir, n_eff)
    diff_ang = torch.asin(torch.clamp(2.0 * u[:, 2] - 1.0, -1.0, 1.0))
    diff_dir = rotate(n_eff, diff_ang)
    refl_dir = normalize(spec_dir +
                         (diff_dir - spec_dir) * w_scat[:, None])

    if transmission_surrogate:
        # the ratio weights the continuing energy only: this bounce's NEE
        # and direct records predate the branch, and the cutoff above
        # stays on the unweighted energy (a detached routing decision)
        energy = energy * w_branch[:, None]
    new_dir = torch.where(transmit[:, None], trans_dir, refl_dir)
    new_speed = torch.where(transmit, next_speed, st.speed)
    new_depth = torch.where(
        transmit,
        torch.where(entering, st.depth + 1, torch.clamp(st.depth - 1, min=0)),
        st.depth)
    pos = pos + torch.where(transmit[:, None], new_dir * EPS, n_eff * EPS)

    sel = alive
    st_next = _RayState(
        pos=torch.where(sel[:, None], pos, st.pos),
        dir=torch.where(sel[:, None], new_dir, st.dir),
        energy=torch.where(sel[:, None], energy, st.energy),
        time=torch.where(sel, time, st.time),
        dist=torch.where(sel, dist, st.dist),
        speed=torch.where(sel, new_speed, st.speed),
        depth=torch.where(sel, new_depth, st.depth),
        alive=sel)

    out = (torch.stack([direct_delay, nee_delay]),            # [2, R, L]
           torch.stack([direct_energy, nee_energy]),          # [2, R, L, K]
           torch.stack([direct_valid, nee_valid]),            # [2, R, L]
           pos, hit_wall)
    return st_next, out


def trace(scene: Scene, params: TraceParams, emit: torch.Tensor,
          u: torch.Tensor, *, n_debug: int = 0, use_kernels: bool = False,
          transmission_surrogate: bool = False
          ) -> Tuple[Hits, Optional[DebugPaths]]:
    """Trace ``R = emit.shape[0]`` rays for ``B = u.shape[0]`` bounces with
    the given uniforms (``emit[R]``, ``u[B, R, 3]``). Returns fixed-shape
    :class:`Hits` and, when ``n_debug > 0``, the :class:`DebugPaths` of
    the first ``n_debug`` rays (else None). ``use_kernels`` routes the
    rays x walls passes through the hand kernels K1 and K2 (on a CPU
    scene: their plain versions); ``transmission_surrogate`` takes the
    relaxed transmission branch of :func:`_bounce` (with or without the
    kernels: the branch is tensor code either way). Without the kernels
    the trace is differentiable (``diff.py``): the kernels have no
    backward."""
    _check_supported(params)
    n_rays = emit.shape[0]
    if u.shape[1:] != (n_rays, 3):
        raise ValueError(f"u must be [B, {n_rays}, 3], got {tuple(u.shape)}")
    if not 0 <= n_debug <= n_rays:
        raise ValueError(f"n_debug must lie in [0, {n_rays}], got {n_debug}")
    walls = tk.sweep_walls(scene) if use_kernels else None
    st = _emit(params, n_rays, scene.n_bands, emit)
    d = n_debug
    dbg_pos, dbg_energy, dbg_alive = [], [], []
    if d:
        dbg_pos.append(params.source.expand(d, 2))
        dbg_energy.append(st.energy[:d].amax(dim=-1))
        dbg_alive.append(torch.ones(d, dtype=torch.bool, device=emit.device))
    delays, energies, valids = [], [], []
    for b in range(u.shape[0]):
        prev = st
        st, (delay, energy, valid, pos, hit_wall) = _bounce(
            scene, params, st, u[b], walls, transmission_surrogate)
        delays.append(delay)
        energies.append(energy)
        valids.append(valid)
        if d:
            # Miss rays draw an escape stub of length 20 like the reference
            # gizmo path (compute:87-88).
            esc = prev.pos[:d] + prev.dir[:d] * 20.0
            dbg_pos.append(torch.where(hit_wall[:d, None], pos[:d], esc))
            dbg_energy.append(st.energy[:d].amax(dim=-1))
            dbg_alive.append(st.alive[:d])
    hits = Hits(delay=torch.stack(delays), energy=torch.stack(energies),
                valid=torch.stack(valids))
    debug = DebugPaths(pos=torch.stack(dbg_pos),
                       energy=torch.stack(dbg_energy),
                       alive=torch.stack(dbg_alive)) if d else None
    return hits, debug


def trace_hits_only(scene: Scene, params: TraceParams, emit: torch.Tensor,
                    u: torch.Tensor, *, use_kernels: bool = False,
                    transmission_surrogate: bool = False) -> Hits:
    """Hits-only wrapper of :func:`trace`."""
    hits, _ = trace(scene, params, emit, u, use_kernels=use_kernels,
                    transmission_surrogate=transmission_surrogate)
    return hits
