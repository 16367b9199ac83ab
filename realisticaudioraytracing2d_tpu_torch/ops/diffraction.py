"""Edge diffraction (Maekawa knife-edge model), orders 1 and 2.

Port of ``realisticaudioraytracing2d_tpu/ops/diffraction.py``. The
reference has hard shadows: a listener with no unoccluded path hears
nothing (``Raytrace2D.compute:101-119``). This deterministic pass adds the
sound that bends around wall endpoints:

* the candidate edges are the endpoints of every real wall; interior
  junctions of collinear walls are excluded, and corners shared by several
  walls count once (:func:`edge_table`);
* a path source -> edge -> listener contributes when the straight source
  -> listener segment is occluded and both legs are clear, with the
  reference's spreading law over the bent length times the Maekawa
  attenuation ``1 / (3 + 20 N)``, ``N = 2 delta f / c``
  (:func:`diffraction_paths`), and the source and microphone patterns at
  the leg directions (:func:`_pattern_weights`);
* order 2 adds edge-to-edge paths S -> E1 -> E2 -> L with one Maekawa
  factor per wedge (:func:`diffraction_paths2`, O(W^3): room-scale
  scenes).

On a CUDA scene :func:`diffraction_ir` and :func:`add_diffraction` run
hand-written launches (``ops/cuda/diffraction_kernel.py``): the edge
table and every visibility segment of both orders, once; a sweep an
order by K2 (``ops/cuda/trace_kernel.py::occlusion_min``, the minimum
wall distance of each segment's ray, searched only up to the segment's
end), order 1's segments, then the edge pairs; and the paths judged and
added into their bins. The torch chain below is the CPU route,
``use_kernels=False`` on the card, and the oracle the kernels equal bit
for bit on the card. In it the visibility test :func:`_segments_clear`
sweeps the segments of a :func:`diffraction_paths` or
:func:`diffraction_paths2` call at once: through K2 (``use_kernels``
True; its plain version on the CPU) or the plain
``pairwise_ray_segment_t`` over all walls. Both compute every distance in
the same IEEE operations, so they judge every segment alike. The chain
bins the paths by ``ops/ir.py::add_rows`` (a fixed order on either
device).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.scene import Scene
from .air import band_frequencies
from .cuda import diffraction_kernel as dk
from .cuda import trace_kernel as tk
from .directivity import evaluate
from .geometry import EPS, pairwise_ray_segment_t
from .ir import add_rows
from .trace import TraceParams

# Endpoints closer than this are "the same corner"; wall pairs with
# |cross| below this (per unit length) are collinear.
_COINCIDENT_TOL = 1e-4
_COLLINEAR_TOL = 1e-3
# a visibility segment's far end is trimmed by this (_segment_clear)
_SLACK = 1e-3


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def _segment_clear(p: torch.Tensor, q: torch.Tensor, scene: Scene,
                   walls: Optional[tk.Walls], slack: float = _SLACK
                   ) -> torch.Tensor:
    """True where the open segment ``p -> q`` (``[..., 2]``) hits no wall.
    ``slack`` trims the far end so that a segment ending on a wall (at an
    edge) does not count that wall; the near end is trimmed by the ray
    test's own ``t >= EPS``. ``walls`` (``trace_kernel.sweep_walls``) runs
    the sweep as K2, up to the trimmed end, None as the plain all-walls
    test."""
    p, q = torch.broadcast_tensors(p, q)
    d = q - p
    length = _norm(d)
    dn = d / torch.clamp(length, min=EPS)[..., None]
    limit = length - slack
    if walls is not None:
        return ~(tk.occlusion_min(p.contiguous(), dn.contiguous(), walls,
                                  limit=limit) < limit)
    t = pairwise_ray_segment_t(p, dn, scene.a, scene.b)      # [..., W]
    return ~torch.any(t < limit[..., None], dim=-1)


def _segments_clear(segments, scene: Scene, walls: Optional[tk.Walls]
                    ) -> list:
    """:func:`_segment_clear` of several families of segments, ``[(p, q),
    ...]`` with ``p, q`` broadcasting to ``[..., 2]``, in one sweep (one
    K2 launch): the masks in the families' shapes. Each segment's result
    is its own, however the families are batched."""
    ps, qs, shapes = [], [], []
    for p, q in segments:
        p, q = torch.broadcast_tensors(p, q)
        shapes.append(p.shape[:-1])
        ps.append(p.reshape(-1, 2))
        qs.append(q.reshape(-1, 2))
    clear = _segment_clear(torch.cat(ps), torch.cat(qs), scene, walls)
    parts = clear.split([x.shape[0] for x in ps])
    return [c.reshape(shape) for c, shape in zip(parts, shapes)]

def edge_table(scene: Scene):
    """Silhouette-edge candidates of a scene: ``(points[E, 2],
    weight[E])`` with ``E = 2 W``; ``weight`` is 0 for invalid edges
    (padding walls, interior collinear junctions) and ``1 /
    multiplicity`` for corners shared by several walls."""
    pts = torch.cat([scene.a, scene.b], dim=0)                  # [E, 2]
    # direction from the endpoint INTO its wall
    into = torch.cat([scene.b - scene.a, scene.a - scene.b], dim=0)
    length = _norm(into)                                        # [E]
    valid = torch.cat([scene.mask, scene.mask]) & (length > EPS)
    diff = pts[:, None, :] - pts[None, :, :]                    # [E, E, 2]
    coincident = ((diff * diff).sum(-1) < _COINCIDENT_TOL ** 2) \
        & valid[None, :]
    # interior junction: another wall's endpoint at the same corner whose
    # wall continues collinearly on the other side (antiparallel into
    # directions); sound does not diffract through a straight seam
    n_into = into / torch.clamp(length, min=EPS)[..., None]
    cross = (n_into[:, None, 0] * n_into[None, :, 1]
             - n_into[:, None, 1] * n_into[None, :, 0])         # [E, E]
    dot = (n_into[:, None, :] * n_into[None, :, :]).sum(-1)
    not_self = ~torch.eye(pts.shape[0], dtype=torch.bool, device=pts.device)
    straight_seam = torch.any(coincident & not_self
                              & (cross.abs() < _COLLINEAR_TOL)
                              & (dot < 0.0), dim=-1)
    valid = valid & ~straight_seam
    multiplicity = (coincident & valid[None, :]).sum(-1)
    weight = torch.where(valid & (multiplicity > 0),
                         1.0 / torch.clamp(multiplicity, min=1), 0.0)
    return pts, weight.to(torch.float32)


def _setup(scene: Scene, params: TraceParams, band_freqs, use_kernels):
    pts, weight = edge_table(scene)
    walls = tk.sweep_walls(scene) if use_kernels else None
    freqs = torch.as_tensor(band_freqs, dtype=torch.float32,
                            device=scene.device)
    return pts, weight, walls, params.listeners.reshape(-1, 2), freqs


def _use_kernels(scene: Scene, use_kernels: Optional[bool]) -> bool:
    return scene.device.type == "cuda" if use_kernels is None \
        else use_kernels


def diffraction_paths(scene: Scene, params: TraceParams, band_freqs,
                      use_kernels: Optional[bool] = None) -> tuple:
    """All first-order edge paths: ``(delay[L, E], energy[L, E, K],
    valid[L, E])`` for ``E = 2 W`` candidate edges; ``band_freqs`` maps
    the band axis to Hz (``[K]``). ``use_kernels`` (default: on a CUDA
    scene) runs the three visibility sweeps through one K2 launch."""
    pts, weight, walls, lis, freqs = _setup(
        scene, params, band_freqs, _use_kernels(scene, use_kernels))
    src = params.source
    c = params.speed_of_sound
    d1 = _norm(pts - src)                                       # [E]
    src_clear, direct_clear, leg_clear = _segments_clear(
        ((src, pts), (src, lis), (pts[None], lis[:, None])), scene,
        walls)                                  # [E], [L], [L, E]
    d_dir = _norm(lis - src)                                    # [L]
    direct_blocked = ~direct_clear
    d2 = _norm(lis[:, None] - pts[None])                        # [L, E]
    d_tot = d1[None] + d2
    delta = torch.clamp(d_tot - d_dir[:, None], min=0.0)
    fresnel = 2.0 * delta[..., None] * freqs / c                # [L, E, K]
    base = params.input_gain / torch.clamp(d_tot * d_tot, min=1.0)
    energy = (weight * base)[..., None] / (3.0 + 20.0 * fresnel)
    valid = (weight > 0) & src_clear & leg_clear & direct_blocked[:, None]
    energy = energy * valid[..., None]
    energy = energy * _pattern_weights(params, pts, lis)[..., None]
    return d_tot / c, energy, valid


def _pattern_weights(params: TraceParams, pts: torch.Tensor,
                     lis: torch.Tensor) -> torch.Tensor:
    """Directivity weights ``[L, E]`` of bent paths through ``pts``: the
    source pattern at the departure angle (source -> edge) times the
    microphone pattern at the arrival angle (listener -> edge)."""
    w = torch.ones((lis.shape[0], pts.shape[0]), dtype=torch.float32,
                   device=pts.device)
    if params.directivity is not None:
        out = pts - params.source                               # [E, 2]
        w = w * evaluate(params.directivity,
                         torch.atan2(out[:, 1], out[:, 0]))[None, :]
    if params.mic_directivity is not None:
        inc = pts[None, :, :] - lis[:, None, :]                 # [L, E, 2]
        ang = torch.atan2(inc[..., 1], inc[..., 0])             # [L, E]
        c = params.mic_directivity
        if c.dim() == 2:
            c = c[:, None, :]                 # [L, 1, C] against [L, E]
        w = w * evaluate(c, ang)
    return w


def diffraction_paths2(scene: Scene, params: TraceParams, band_freqs,
                       use_kernels: Optional[bool] = None) -> tuple:
    """Second-order (edge-to-edge) paths S -> E1 -> E2 -> L, the Maekawa
    cascade: each wedge its own ``1 / (3 + 20 N)`` with the detour of its
    local triangle. O(W^3) visibility tests (all edge pairs against all
    walls): room-scale scenes; the four visibility sweeps are one K2
    launch. Returns ``(delay[L, E, E], energy[L, E, E, K], valid[L, E,
    E])``."""
    pts, weight, walls, lis, freqs = _setup(
        scene, params, band_freqs, _use_kernels(scene, use_kernels))
    src = params.source
    c = params.speed_of_sound
    d1 = _norm(pts - src)                                       # [E]
    src_clear, pair_clear, direct_clear, leg_clear = _segments_clear(
        ((src, pts), (pts[:, None, :], pts[None, :, :]), (src, lis),
         (pts[None], lis[:, None])), scene,
        walls)                                  # [E], [E, E], [L], [L, E]
    d12 = _norm(pts[:, None, :] - pts[None, :, :])              # [E, E]
    distinct = d12 > _COINCIDENT_TOL
    s_to_e2 = d1                     # straight source -> E2, per E2
    direct_blocked = ~direct_clear
    d2 = _norm(lis[:, None] - pts[None])                        # [L, E]
    d_tot = d1[None, :, None] + d12[None] + d2[:, None, :]      # [L, E, E]
    delta1 = torch.clamp(d1[:, None] + d12 - s_to_e2[None, :], min=0.0)
    delta2 = torch.clamp(d12[None] + d2[:, None, :] - d2[:, :, None],
                         min=0.0)                               # [L, E, E]
    n1 = 2.0 * delta1[None, ..., None] * freqs / c
    n2 = 2.0 * delta2[..., None] * freqs / c
    att = 1.0 / ((3.0 + 20.0 * n1) * (3.0 + 20.0 * n2))         # [L,E,E,K]
    base = params.input_gain / torch.clamp(d_tot * d_tot, min=1.0)
    w2d = weight[:, None] * weight[None, :]
    valid = ((w2d > 0) & distinct & src_clear[:, None] & pair_clear)[None] \
        & leg_clear[:, None, :] & direct_blocked[:, None, None]
    energy = (w2d[None] * base)[..., None] * att * valid[..., None]
    if params.directivity is not None:
        out = pts - src
        g = evaluate(params.directivity, torch.atan2(out[:, 1], out[:, 0]))
        energy = energy * g[None, :, None, None]
    if params.mic_directivity is not None:
        inc = pts[None, :, :] - lis[:, None, :]                 # [L, E2, 2]
        ang = torch.atan2(inc[..., 1], inc[..., 0])
        cm = params.mic_directivity
        if cm.dim() == 2:
            cm = cm[:, None, :]
        energy = energy * evaluate(cm, ang)[:, None, :, None]
    return d_tot / c, energy, valid


def _scatter_paths(delay: torch.Tensor, energy: torch.Tensor,
                   valid: torch.Tensor, sample_rate: int, ir_length: int,
                   k: int) -> torch.Tensor:
    """Bin path families ``delay[L, ...]`` / ``energy[L, ..., K]`` into
    an IR ``[L, T, K]`` through ``add_rows``. Invalid paths carry zero
    energy; they and the out-of-range ones go to a sacrificial bin."""
    n_l = delay.shape[0]
    delay = delay.reshape(n_l, -1)
    energy = energy.reshape(n_l, -1, k)
    bins = torch.floor(delay * sample_rate).to(torch.int32)
    ok = (bins >= 0) & (bins < ir_length)
    energy = energy * ok[..., None]
    keep = ok & valid.reshape(n_l, -1)
    bins = torch.where(keep, bins, ir_length).long()
    rows = bins + (ir_length + 1) * torch.arange(
        n_l, device=bins.device)[:, None]
    ir = add_rows(n_l * (ir_length + 1), rows.reshape(-1),
                  energy.reshape(-1, k), keep.reshape(-1))
    return ir.reshape(n_l, ir_length + 1, k)[:, :ir_length]


def _kernel_route(scene: Scene, use_kernels: Optional[bool]) -> bool:
    return scene.device.type == "cuda" and _use_kernels(scene, use_kernels)


def diffraction_ir(scene: Scene, params: TraceParams, *, sample_rate: int,
                   ir_length: int, band_freqs=None, order: int = 1,
                   use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Deterministic diffraction IR ``[L, T, K]``: add it to a traced
    frame's IR (or ``frames *`` it to an accumulated sum; it has no
    Monte-Carlo variance). ``band_freqs`` defaults to
    :func:`..air.band_frequencies`; ``order=2`` adds edge-to-edge double
    diffraction. ``use_kernels`` (default: on a CUDA scene) runs the
    launches of ``ops/cuda/diffraction_kernel.py`` into zeros on a CUDA
    scene, and the chain's visibility sweeps through K2's plain version on
    the CPU; False is the plain chain."""
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    k = scene.n_bands
    if band_freqs is None:
        band_freqs = band_frequencies(k)
    if _kernel_route(scene, use_kernels):
        ir = torch.zeros((params.listeners.reshape(-1, 2).shape[0],
                          ir_length, k), dtype=torch.float32,
                         device=scene.device)
        return add_diffraction(ir, scene, params, sample_rate=sample_rate,
                               band_freqs=band_freqs, order=order)
    delay, energy, valid = diffraction_paths(scene, params, band_freqs,
                                             use_kernels)
    ir = _scatter_paths(delay, energy, valid, sample_rate, ir_length, k)
    if order >= 2:
        delay2, energy2, valid2 = diffraction_paths2(
            scene, params, band_freqs, use_kernels)
        ir = ir + _scatter_paths(delay2, energy2, valid2, sample_rate,
                                 ir_length, k)
    return ir


def add_diffraction(ir: torch.Tensor, scene: Scene, params: TraceParams, *,
                    sample_rate: int, band_freqs=None, order: int = 1,
                    use_kernels: Optional[bool] = None) -> torch.Tensor:
    """``ir + diffraction_ir(...)`` of an IR ``[L, T, K]``. On the
    kernel route (a CUDA scene, ``use_kernels`` not False) the paths are
    added into ``ir`` in place, which must be contiguous and the caller's
    to change; elsewhere the sum is a new tensor."""
    if not _kernel_route(scene, use_kernels):
        return ir + diffraction_ir(scene, params, sample_rate=sample_rate,
                                   ir_length=ir.shape[-2],
                                   band_freqs=band_freqs, order=order,
                                   use_kernels=use_kernels)
    if band_freqs is None:
        band_freqs = band_frequencies(scene.n_bands)
    return dk.add_paths(ir, scene, params, sample_rate=sample_rate,
                        band_freqs=band_freqs, order=order)
