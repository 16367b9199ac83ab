"""Differentiable acoustics: autograd through the plain trace.

Port of ``realisticaudioraytracing2d_tpu/diff.py``. The forward
simulation (emission, bounces, NEE, IR binning) is plain PyTorch
(``ops/trace.py``, ``ops/ir.py``), so estimating wall materials from a
target impulse response (:func:`fit_materials`) or a source position from
it (:func:`localize_source`) is gradient descent with ``torch.optim.Adam``.

What is differentiable, and why (the JAX module's analysis holds as is):

* **absorption** scales ray energy multiplicatively every bounce: smooth.
* **scattering** lerps specular to diffuse directions and jitters the
  refraction: directions move continuously (visibility-boundary terms
  are ignored, the usual bias of differentiable path tracing).
* **transmission** enters only through the branch ``u < transmission``,
  whose pathwise gradient is zero almost everywhere. The
  importance-sampled surrogate (``simulate_ir(transmission_surrogate=
  True)``, switched on by ``fit_materials(fields=(..., "transmission"))``)
  draws the branch from a detached proposal and puts the smooth
  likelihood ratio on the continuing energy: the same expected IR, a
  pathwise gradient in the transmission.
* **ior** and **positions** act mostly through hit delays, which the hard
  ``floor`` binning flattens; the two-bin splat (``simulate_ir(soft=
  True)``, ``ops/ir.py::scatter_hits_soft``) restores their gradient.

The differentiable forward is the plain trace on the caller's device, the
card too: the hand kernels have no backward, in the JAX package as here
(its ``simulate_ir`` calls ``trace_hits_only`` with ``use_pallas=False``),
so no backward kernel is written. Random numbers follow the port's rule:
a ``seed`` names the Philox stream of ``ops/rng.py::philox_uniforms``
(frame ``f`` of ``seed`` for a multi-frame forward, ``mix_seed(seed, i)``
for fit step ``i`` when resampling, ``mix_seed(seed, j)`` for source
``j`` of a joint localization), and ``uniforms=`` / ``uniforms_fn=`` hand
in explicit draws (the parity tests pass JAX's). Every entry point takes
``device=None``, the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .device import resolve
from .models.scene import Scene
from .ops import ir as irm
from .ops.rng import mix_seed, philox_uniforms
from .ops.trace import TraceParams, trace_hits_only

_LOGIT_EPS = 1e-4

# Fields of MaterialParams with usable pathwise gradients under the plain
# forward; "transmission" switches the fit to the surrogate forward, and
# "ior" needs the soft splat (its signal is mostly delay).
DEFAULT_FIT_FIELDS: Tuple[str, ...] = ("absorption", "scattering")
FIELDS = ("absorption", "scattering", "transmission", "ior")

# The reference's ior slider range (AudioMaterial.cs:20).
IOR_MIN, IOR_MAX = 0.01, 4.0

# uniforms_fn(step, source) -> (emit[F, R], u[F, B, R, 3])
UniformsFn = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]


def _host(x) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _float_on(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor (no host round trip)
    or an array (copied: JAX's buffers are read-only)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _logit(v: torch.Tensor, lo: float = 0.0, hi: float = 1.0
           ) -> torch.Tensor:
    """Logit of ``(v - lo) / (hi - lo)`` clipped into (0, 1). The JAX
    function computes the ratio eagerly (a true division by the float32
    ``hi - lo``); so does this, by a tensor."""
    r = (v - v.new_tensor(lo)) / v.new_tensor(hi - lo)
    r = torch.clamp(r, _LOGIT_EPS, 1.0 - _LOGIT_EPS)
    return torch.log(r) - torch.log1p(-r)


def infer_material_groups(scene: Scene) -> Tuple[np.ndarray, int]:
    """Per-wall material-group ids of a built :class:`Scene`: walls with
    one acoustic signature (banded absorption, scattering, transmission,
    ior) share a group, the inverse of the reference's one material per
    collider (``AudioSurface.cs``). Host numpy: an int32 ``[W]`` array and
    the group count. Padding walls are grouped too; :func:`apply_materials`
    never lets them act (mask guard)."""
    sig = np.concatenate([
        _host(scene.absorption).astype(np.float64),
        _host(scene.scattering).astype(np.float64)[:, None],
        _host(scene.transmission).astype(np.float64)[:, None],
        _host(scene.ior).astype(np.float64)[:, None],
    ], axis=1)
    _, groups = np.unique(sig, axis=0, return_inverse=True)
    groups = groups.reshape(-1).astype(np.int32)
    return groups, int(groups.max()) + 1


class MaterialParams(NamedTuple):
    """Unconstrained (logit-space) per-group material parameters: every
    constrained value stays inside the reference's ranges
    (``AudioMaterial.cs:6-20``) under unconstrained descent."""

    absorption: torch.Tensor    # [G, K] logits
    scattering: torch.Tensor    # [G] logits
    transmission: torch.Tensor  # [G] logits
    ior: torch.Tensor           # [G] logits over [IOR_MIN, IOR_MAX]

    @property
    def n_groups(self) -> int:
        return self.absorption.shape[0]

    @staticmethod
    def from_scene(scene: Scene, groups, n_groups: int) -> "MaterialParams":
        """From a scene's materials (the first wall of each group wins),
        on the scene's device."""
        first = np.zeros((n_groups,), np.int64)
        seen = set()
        for w, g in enumerate(np.asarray(groups)):
            if int(g) not in seen:
                seen.add(int(g))
                first[int(g)] = w
        idx = torch.as_tensor(first, device=scene.a.device)
        return MaterialParams(
            absorption=_logit(scene.absorption[idx]),
            scattering=_logit(scene.scattering[idx]),
            transmission=_logit(scene.transmission[idx]),
            ior=_logit(scene.ior[idx], IOR_MIN, IOR_MAX))

    def constrained(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
        """(absorption [G, K], scattering [G], transmission [G]) in [0, 1]
        and ior [G] in [IOR_MIN, IOR_MAX]."""
        s = torch.sigmoid(self.ior)
        return (torch.sigmoid(self.absorption),
                torch.sigmoid(self.scattering),
                torch.sigmoid(self.transmission),
                s.new_tensor(IOR_MIN) + s * s.new_tensor(IOR_MAX - IOR_MIN))


def apply_materials(scene: Scene, groups, params: MaterialParams,
                    fields: Sequence[str] = DEFAULT_FIT_FIELDS) -> Scene:
    """Rebind the wall materials of ``fields`` from ``params``,
    differentiably. Every other field, and every padding wall (mask
    guard), keeps the scene's own tensors and values."""
    groups = (groups if isinstance(groups, torch.Tensor)
              else torch.from_numpy(np.asarray(groups))).to(
                  scene.a.device, torch.long)
    absorption, scattering, transmission, ior = params.constrained()
    mask1, mask2 = scene.mask, scene.mask[:, None]
    updates = {}
    if "absorption" in fields:
        updates["absorption"] = torch.where(mask2, absorption[groups],
                                            scene.absorption)
    if "scattering" in fields:
        updates["scattering"] = torch.where(mask1, scattering[groups],
                                            scene.scattering)
    if "transmission" in fields:
        updates["transmission"] = torch.where(mask1, transmission[groups],
                                              scene.transmission)
    if "ior" in fields:
        updates["ior"] = torch.where(mask1, ior[groups], scene.ior)
    return scene._replace(**updates)


def simulate_ir(scene: Scene, params: TraceParams, seed: int = 0, *,
                n_rays: int, max_bounces: int, sample_rate: int,
                ir_length: int, frames: int = 1, remat: bool = True,
                soft: bool = False, transmission_surrogate: bool = False,
                uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                device=None) -> torch.Tensor:
    """Differentiable forward model: the mean IR ``[L, T, K]`` of
    ``frames`` Monte-Carlo frames through the plain trace.

    Frame ``f`` draws frame ``f`` of ``seed``'s Philox stream, or
    ``uniforms = (emit[F, R], u[F, B, R, 3])``. With ``remat`` (and more
    than one frame) each frame runs under ``torch.utils.checkpoint``, so
    the backward keeps one frame's residuals at a time and recomputes the
    rest from the same uniforms. ``soft`` bins through the two-bin splat
    (delay gradients), ``transmission_surrogate`` takes the relaxed
    transmission branch. The frames are summed in order and scaled by
    the float32 ``1 / frames``, which is how XLA compiles the JAX
    function's mean."""
    dev = resolve(device)
    scene, params = scene.to(dev), params.to(dev)
    if uniforms is None:
        uniforms = philox_uniforms(seed, frames, max_bounces, n_rays,
                                   device=dev)
    emit, u = (x.to(dev) for x in uniforms)
    if tuple(emit.shape) != (frames, n_rays) \
            or tuple(u.shape) != (frames, max_bounces, n_rays, 3):
        raise ValueError(
            f"uniforms must be emit[{frames}, {n_rays}] and u[{frames}, "
            f"{max_bounces}, {n_rays}, 3], got {tuple(emit.shape)} and "
            f"{tuple(u.shape)}")
    scatter = irm.scatter_hits_soft if soft else irm.scatter_hits

    def one_frame(e, uu):
        hits = trace_hits_only(scene, params, e, uu,
                               transmission_surrogate=transmission_surrogate)
        return scatter(hits, sample_rate, ir_length)

    if frames == 1:
        return one_frame(emit[0], u[0])
    rc = remat and torch.is_grad_enabled()
    total = None
    for f in range(frames):
        ir = (checkpoint(one_frame, emit[f], u[f], use_reentrant=False)
              if rc else one_frame(emit[f], u[f]))
        total = ir if total is None else total + ir
    return total * total.new_tensor(float(np.float32(1.0)
                                          / np.float32(frames)))


# -- losses ------------------------------------------------------------------

def ir_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain L2 on the energy histograms."""
    return torch.mean(torch.square(pred - target))


def edc(ir: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Schroeder energy-decay curve: the reversed cumulative sum of the
    energy histogram along time."""
    return torch.flip(torch.cumsum(torch.flip(ir, (axis,)), dim=axis),
                      (axis,))


def log_edc_loss(pred: torch.Tensor, target: torch.Tensor,
                 floor: float = 1e-8) -> torch.Tensor:
    """L2 between log10 energy-decay curves (a dB-scale match)."""
    return torch.mean(torch.square(torch.log10(edc(pred) + floor)
                                   - torch.log10(edc(target) + floor)))


def combined_loss(pred: torch.Tensor, target: torch.Tensor,
                  mse_weight: float = 2000.0) -> torch.Tensor:
    """log-EDC plus weighted raw-IR MSE: the EDC pins the decay rate, the
    MSE the early-reflection amplitudes it integrates away."""
    return log_edc_loss(pred, target) + mse_weight * ir_mse(pred, target)


_LOSSES = {"mse": ir_mse, "edc": log_edc_loss, "edc+mse": combined_loss}


def gaussian_blur_time(ir: torch.Tensor, sigma, radius: int = 96
                       ) -> torch.Tensor:
    """Blur an ``[L, T, K]`` IR along time with a Gaussian of ``sigma``
    bins (support ``2 * radius + 1``): what makes delay mismatches
    attract from ~``sigma`` bins away. Zero-padded and ``valid``, so the
    result keeps T bins even when T < 2 * radius + 1.

    The kernel is built in float32 as the JAX function builds it (true
    divisions, as its jitted HLO keeps them). The convolution sums in
    float64, rounded once to float32: never TF32 (cuDNN's default for a
    float32 convolution on the card), the same result on the CPU and the
    card up to the last bit of the sum, and its backward a gather
    (``unfold``), deterministic on the card."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=ir.device)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=ir.device)
    kern = torch.exp(-0.5 * torch.square(
        x / torch.maximum(sigma, sigma.new_tensor(0.25))))
    kern = kern / torch.sum(kern)
    n_l, n_t, n_k = ir.shape
    rows = ir.movedim(-1, 1).reshape(n_l * n_k, n_t).double()
    win = torch.nn.functional.pad(rows, (radius, radius)).unfold(
        -1, 2 * radius + 1, 1)                           # [L*K, T, 2r+1]
    out = win @ kern.flip(0).double()
    return out.float().reshape(n_l, n_k, n_t).movedim(1, -1)


def _blur_rel_l2(pred: torch.Tensor, target: torch.Tensor, sigma,
                 scale_invariant: bool = False) -> torch.Tensor:
    """Relative L2 between Gaussian-blurred IRs, the coarse-to-fine
    objective of ``fit_materials(loss="blur")`` and
    :func:`localize_source`. ``scale_invariant`` first scales the blurred
    prediction by its least-squares gain ``<pb, tb> / <pb, pb>``. The
    floors are ``torch.maximum``, which splits a tie's gradient as
    ``jnp.maximum`` does."""
    pb = gaussian_blur_time(pred, sigma)
    tb = gaussian_blur_time(target, sigma)
    tiny = pb.new_tensor(1e-20)
    if scale_invariant:
        pb = pb * (torch.sum(pb * tb)
                   / torch.maximum(torch.sum(pb * pb), tiny))
    return torch.mean(torch.square(pb - tb)) \
        / torch.maximum(torch.mean(torch.square(tb)), tiny)


def _sigma_schedule(steps: int, sigma0: float, sigma_min: float,
                    anneal_steps: float) -> torch.Tensor:
    """Coarse-to-fine blur widths (float32, on the host): ``sigma0``
    halving every ``anneal_steps`` steps, plus ``sigma_min``. Eager in
    JAX, one operation at a time as here."""
    i = torch.arange(steps, dtype=torch.float32)
    half = torch.pow(i.new_tensor(0.5), i / i.new_tensor(anneal_steps))
    return i.new_tensor(sigma0) * half + i.new_tensor(sigma_min)


# -- fitting -----------------------------------------------------------------

class FitResult(NamedTuple):
    params: MaterialParams   # fitted logits
    scene: Scene             # input scene with fitted materials applied
    losses: torch.Tensor     # [steps] loss trajectory


def _loss_fn(loss: str):
    if loss == "blur":
        return _blur_rel_l2
    if loss in _LOSSES:
        base = _LOSSES[loss]
        return lambda pred, tgt, sigma: base(pred, tgt)  # noqa: E731
    raise ValueError(f"loss={loss!r}; pick from {sorted(_LOSSES) + ['blur']}")


def fit_materials(scene: Scene, trace_params: TraceParams, target_ir,
                  seed: int = 0, *, n_rays: int, max_bounces: int,
                  sample_rate: int, frames: int = 1,
                  groups: Optional[np.ndarray] = None,
                  init: Optional[MaterialParams] = None,
                  fields: Sequence[str] = DEFAULT_FIT_FIELDS,
                  loss: str = "edc", steps: int = 100, lr: float = 0.05,
                  resample: bool = True, soft: bool = False,
                  blur_sigma0: float = 16.0, blur_sigma_min: float = 1.0,
                  blur_anneal_steps: float = 25.0,
                  uniforms_fn: Optional[UniformsFn] = None,
                  device=None) -> FitResult:
    """Estimate wall materials from a target IR ``[L, T, K]`` by Adam in
    logit space (``torch.optim.Adam(lr=lr)``, optax's defaults).

    Step ``i`` traces ``mix_seed(seed, i)`` with ``resample`` (unbiased
    stochastic gradients), else ``seed`` every step (common random
    numbers), or ``uniforms_fn(i, 0)``. ``fields`` with "transmission"
    switches the forward to the transmission surrogate (targets may still
    come from the hard forward: the expected IR is the same). "ior" wants
    ``soft=True`` and ``loss="blur"``: relative L2 between Gaussian-blurred
    IRs, sigma annealed ``blur_sigma0 -> blur_sigma_min`` over
    ``blur_anneal_steps``-step halvings."""
    unknown = set(fields) - set(FIELDS)
    if unknown:
        raise ValueError(f"unknown material fields {sorted(unknown)}; "
                         "pick from absorption/scattering/transmission/ior")
    loss_fn = _loss_fn(loss)
    dev = resolve(device)
    scene, trace_params = scene.to(dev), trace_params.to(dev)
    if groups is None:
        groups, n_groups = infer_material_groups(scene)
    else:
        groups = np.asarray(groups, np.int32)
        n_groups = int(groups.max()) + 1
    if init is None:
        init = MaterialParams.from_scene(scene, groups, n_groups)
    target = _float_on(target_ir, dev)
    fields = tuple(fields)
    surrogate = "transmission" in fields
    groups_t = torch.from_numpy(groups).to(dev, torch.long)
    mp = MaterialParams(*(x.detach().to(dev).clone().requires_grad_(True)
                          for x in init))
    opt = torch.optim.Adam(list(mp), lr=lr)
    sigmas = _sigma_schedule(steps, blur_sigma0, blur_sigma_min,
                             blur_anneal_steps).to(dev)
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        fitted = apply_materials(scene, groups_t, mp, fields)
        pred = simulate_ir(
            fitted, trace_params, mix_seed(seed, i) if resample else seed,
            n_rays=n_rays, max_bounces=max_bounces, sample_rate=sample_rate,
            ir_length=target.shape[-2], frames=frames, soft=soft,
            transmission_surrogate=surrogate,
            uniforms=None if uniforms_fn is None else uniforms_fn(i, 0),
            device=dev)
        value = loss_fn(pred, target, sigmas[i])
        value.backward()
        opt.step()
        losses.append(value.detach())
    fitted_mp = MaterialParams(*(x.detach() for x in mp))
    with torch.no_grad():
        fitted_scene = apply_materials(scene, groups_t, fitted_mp, fields)
    return FitResult(params=fitted_mp, scene=fitted_scene,
                     losses=torch.stack(losses) if losses
                     else torch.zeros(0, device=dev))


# -- source localization -----------------------------------------------------

def first_arrival_times(ir, sample_rate: int,
                        threshold_frac: float = 0.02) -> np.ndarray:
    """Per-listener first-arrival time (seconds) of an ``[L, T, K]``
    energy IR: the first bin reaching ``threshold_frac`` of the
    listener's band-summed peak. Host numpy. Raises on a listener whose
    IR is all zero (a bin-0 "arrival" would pull the fit onto that
    listener's radius circle)."""
    e = _host(ir).sum(axis=-1)                          # [L, T]
    peak = e.max(axis=1, keepdims=True)
    if (peak <= 0.0).any():
        empty = np.flatnonzero(peak[:, 0] <= 0.0).tolist()
        raise ValueError(
            f"listeners {empty} have an all-zero target IR — no first "
            "arrival to localize against (trace with more bounces/rays or "
            "a longer IR)")
    bins = np.argmax(e >= peak * threshold_frac, axis=1)  # [L]
    return (bins + 0.5) / float(sample_rate)


def scene_bounds(scene: Scene, shrink: float = 0.05) -> np.ndarray:
    """The AABB of the real walls shrunk by ``shrink`` of its extent per
    side, ``[2 (lo, hi), 2 (x, y)]``: the default search box of
    :func:`localize_source`. For rooms of thick walls it includes the
    wall band, where a hypothesis traces nothing; pass interior
    ``bounds`` there (essential for ``n_sources > 1``)."""
    mask = _host(scene.mask)
    pts = np.concatenate([_host(scene.a)[mask], _host(scene.b)[mask]],
                         axis=0)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    pad = (hi - lo) * shrink
    return np.stack([lo + pad, hi - pad])


class LocalizeResult(NamedTuple):
    position: torch.Tensor   # [2] (or [N, 2] for n_sources=N) best fit
    loss: torch.Tensor       # its final loss
    positions: torch.Tensor  # [S, 2] / [S, N, 2] every start's fit
    losses: torch.Tensor     # [S] every start's final loss


def localize_source(scene: Scene, trace_params: TraceParams, target_ir,
                    seed: int = 0, *, n_rays: int, max_bounces: int,
                    sample_rate: int, n_starts: int = 8, steps: int = 200,
                    lr: float = 0.08, bounds: Optional[np.ndarray] = None,
                    sigma0: float = 24.0, sigma_min: float = 1.0,
                    anneal_steps: float = 30.0, arrival_weight: float = 1.0,
                    ir_weight: float = 30.0,
                    starts_seed: Optional[int] = None, starts=None,
                    gain_invariant: bool = False, n_sources: int = 1,
                    mesh=None, axis: str = "rooms",
                    uniforms_fn: Optional[UniformsFn] = None,
                    device=None) -> LocalizeResult:
    """Estimate the source position from a target IR by gradient descent
    through the trace with the soft splat (hard binning has no position
    gradient). A single listener localizes: its first arrival fixes a
    range circle, the reflections pick the point on it.

    Loss = ``arrival_weight`` x trilateration (the line-of-sight delay
    ``(|s - l| - r) / c`` against the target's first arrivals, in ms^2;
    N = 1 only) + ``ir_weight`` x the relative L2 of Gaussian-blurred IRs,
    sigma annealed ``sigma0 -> sigma_min`` over ``anneal_steps`` halvings.
    ``n_starts`` starts drawn uniformly over ``bounds`` (default
    :func:`scene_bounds`) from a ``torch.Generator`` seeded with
    ``starts_seed`` (default ``mix_seed(seed, 0x10C8)``), or ``starts``
    (``[2]``, ``[S, 2]`` or ``[S, N, 2]``). All starts are one ``[S, N,
    2]`` parameter under one Adam, each start's loss backpropagated on
    its own (Adam is elementwise: each moves as under its own optimizer),
    every step on the same draws (common random numbers): ``seed``, or
    ``mix_seed(seed, j)`` for source ``j`` of ``n_sources > 1`` (whose
    predicted IR is the sum over sources), or ``uniforms_fn(step, j)``.
    Each start is scored at the last sigma (on ``uniforms_fn(steps,
    j)``). ``gain_invariant`` projects
    out the target's absolute level. ``trace_params.source`` is ignored.

    ``mesh`` (a :class:`.parallel.mesh.Mesh`) splits the starts over
    ``mesh[axis]``: shard ``d`` runs its starts on its device under its
    own Adam (each start's problem is its own: Adam is elementwise, the
    draws are common, each loss is backpropagated alone), and the result
    gathers them in order on the mesh's first device. ``n_starts`` must
    divide evenly by the axis size."""
    dev = resolve(device)
    scene, trace_params = scene.to(dev), trace_params.to(dev)
    target = _float_on(target_ir, dev)
    bounds = np.asarray(scene_bounds(scene) if bounds is None else bounds,
                        np.float32)
    fa_target = torch.as_tensor(
        first_arrival_times(target, sample_rate).astype(np.float32),
        device=dev)
    if starts is not None:
        starts = _float_on(starts, "cpu").reshape(-1, n_sources, 2)
    else:
        gen = torch.Generator().manual_seed(
            mix_seed(seed, 0x10C8) if starts_seed is None else starts_seed)
        lo, hi = torch.from_numpy(bounds[0]), torch.from_numpy(bounds[1])
        draw = torch.rand((n_starts, n_sources, 2), generator=gen)
        starts = torch.maximum(lo, draw * (hi - lo) + lo)
    n_starts = starts.shape[0]
    sigmas = _sigma_schedule(steps, sigma0, sigma_min, anneal_steps)
    fit = dict(seed=seed, n_rays=n_rays, max_bounces=max_bounces,
               sample_rate=sample_rate, steps=steps, lr=lr,
               arrival_weight=arrival_weight, ir_weight=ir_weight,
               gain_invariant=gain_invariant, uniforms_fn=uniforms_fn)
    if mesh is None:
        positions, losses = _fit_starts(scene, trace_params, target,
                                        fa_target, starts, sigmas, dev,
                                        **fit)
    else:
        from .parallel.mesh import gather, on_device
        n_dev = mesh.shape[axis]
        if n_starts % n_dev != 0:
            raise ValueError(f"{n_starts} starts not divisible by "
                             f"{axis}={n_dev}")
        local = n_starts // n_dev
        shards = []
        for d, dev_d in enumerate(mesh.axis_devices(axis)):
            with on_device(dev_d):
                shards.append(_fit_starts(
                    scene.to(dev_d), trace_params.to(dev_d),
                    target.to(dev_d), fa_target.to(dev_d),
                    starts[d * local:(d + 1) * local], sigmas, dev_d,
                    **fit))
        positions = gather(mesh, [p for p, _ in shards])
        losses = gather(mesh, [loss for _, loss in shards])
    if n_sources == 1:   # keep the single-source [2] / [S, 2] API
        positions = positions[:, 0, :]
    best = int(torch.argmin(losses))
    return LocalizeResult(position=positions[best], loss=losses[best],
                          positions=positions, losses=losses)


def _fit_starts(scene, trace_params, target, fa_target, starts, sigmas, dev,
                *, seed, n_rays, max_bounces, sample_rate, steps, lr,
                arrival_weight, ir_weight, gain_invariant, uniforms_fn):
    """The multi-start fit of :func:`localize_source` on one device: the
    starts ``[S, N, 2]`` as one parameter under one Adam. Returns the
    fitted positions ``[S, N, 2]`` and each start's final loss ``[S]``."""
    n_starts, n_src = starts.shape[:2]
    ir_length = target.shape[-2]
    sigmas = sigmas.to(dev)
    listeners = trace_params.listeners
    c, r = trace_params.speed_of_sound, trace_params.listener_radius

    def loss_fn(srcs: torch.Tensor, sigma: torch.Tensor, step: int):
        def one(j):
            return simulate_ir(
                scene, trace_params._replace(source=srcs[j]),
                seed if n_src == 1 else mix_seed(seed, j), n_rays=n_rays,
                max_bounces=max_bounces, sample_rate=sample_rate,
                ir_length=ir_length, soft=True,
                uniforms=None if uniforms_fn is None
                else uniforms_fn(step, j), device=dev)

        pred = one(0)
        for j in range(1, n_src):
            pred = pred + one(j)
        l_ir = _blur_rel_l2(pred, target, sigma,
                            scale_invariant=gain_invariant)
        if n_src > 1:
            # a mixed IR's first arrival is the min over sources: the
            # trilateration term applies to one source only
            return ir_weight * l_ir
        d = torch.sqrt(torch.sum(torch.square(listeners - srcs[0][None, :]),
                                 dim=-1))
        fa_pred = torch.maximum(d - r, d.new_tensor(0.0)) / c
        l_fa = torch.mean(torch.square((fa_pred - fa_target) * 1e3))
        return arrival_weight * l_fa + ir_weight * l_ir

    src = starts.to(dev).clone().requires_grad_(True)
    opt = torch.optim.Adam([src], lr=lr)
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        for s in range(n_starts):
            loss_fn(src[s], sigmas[i], i).backward()
        opt.step()
    with torch.no_grad():
        positions = src.detach()
        losses = torch.stack([loss_fn(positions[s], sigmas[-1], steps)
                              for s in range(n_starts)])
    return positions, losses
