"""Cluster-early-out kernels of the large-scene path: wrappers, plain
versions and launch counts.

Two entry points launch the kernels of ``csrc/accel_kernel.cu`` on a scene
that :func:`prepare` Morton-sorts and boxes (:func:`..accel.cluster_scene`)
once and keeps for later calls on the same scene tensors:

* :func:`trace_frames_ir_accel` (K7): every bounce of ``n_frames`` frames
  in one launch, 1 <= K <= 8 bands; it replaces ``ops/pallas/
  bounce_kernel.py::trace_frames_ir_accel`` of the JAX package;
* :func:`trace_frames_ir_accel_sorted` (K8): one launch per bounce over
  all frames' rays, the rays re-sorted along a Morton curve of their
  positions between launches (the kernel writes the keys, the wrapper
  sorts them, the next launch reads its rays through the permutation) and
  each block visiting the super boxes near to far from its own rays, K =
  1; it replaces ``::trace_frames_ir_accel_sorted``.

Both take directive sources and microphones (``TraceParams.directivity`` /
``mic_directivity``) through the kernels' directive instantiation, as the
bounce kernel does (``bounce_kernel.pattern_tables``).

Both return the frame-SUMMED IR ``[L, T, K]`` float32 and draw Philox
numbers in the kernel under the key of ``seed``, counter (ray, frame,
bounce, 0): the numbers K4 draws, so on a sorted scene K7 (K = 1) and K8
equal K4 bit for bit. ``early_out=False`` visits every cluster (the
brute-force yardstick) and gives the same bits.

On a CUDA scene they launch the kernel or raise; on a CPU scene they run
their plain version, :func:`trace_frames_ir_accel_plain` (the plain trace
+ scatter on the sorted scene) and :func:`trace_frames_ir_accel_sorted_plain`
(the same bounce by bounce on the re-sorted rays), which are also what the
kernels are held against on the card. Each entry point counts its
launches in ``.launches``: one per K7 call, ``max_bounces`` per K8 call;
``prepare.builds`` counts the scenes :func:`prepare` really sorted.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from ...models.scene import Scene
from .. import accel, rng
from ..ir import scatter_hits
from ..trace import (Hits, TraceParams, _bounce, _check_supported, _emit,
                     _RayState, check_patterns)
from . import bounce_kernel as bk
from . import build

MAX_BANDS = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_FRAMES_ARGTYPES = (_P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P,
                    _I, _P,
                    ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, _I, _I,
                    _I, _I, _P, _P, _P, _I, _P, _P)
_BOUNCE_ARGTYPES = (_P, _P, _I, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _I,
                    _P, _P,
                    ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, _I, _I,
                    _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P)
# scenes whose sorted tables prepare() keeps
PREPARED_SCENES = 8


def _fn(name, argtypes):
    fn = getattr(build.load_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


class AccelScene(NamedTuple):
    """A scene ready for the cluster kernels: Morton-sorted and padded to
    ``C * cluster_size`` walls, its wall table, cluster and super boxes,
    and the window the rays' sort keys are quantized in."""

    scene: Scene
    walls: torch.Tensor    # [11 + K - 1, Wp] f32 (pack_walls + bands 1..)
    geo: torch.Tensor      # [Wp, 4] f32: ax, ay, v2x, v2y (16-byte loads)
    aabb: torch.Tensor     # [C, 4] f32
    saabb: torch.Tensor    # [C / group, 4] f32
    bounds: torch.Tensor   # [4] f32: accel.scene_bounds lo x, lo y, span x, y
    cluster_size: int
    group: int

    @property
    def n_clusters(self) -> int:
        return self.aabb.shape[0]


def pack_walls_banded(scene: Scene) -> torch.Tensor:
    """:func:`.bounce_kernel.pack_walls` ``[11, W]`` with the absorption
    of bands 1 .. K-1 appended as rows 11 .. 9 + K."""
    walls = bk.pack_walls(scene)
    if scene.n_bands == 1:
        return walls
    return torch.cat([walls, scene.absorption[:, 1:].T], dim=0).contiguous()


def _build(scene: Scene, cs: int, group: int) -> AccelScene:
    scene_s, aabb = accel.cluster_scene(scene, cs, group)
    walls = pack_walls_banded(scene_s)
    return AccelScene(scene_s, walls, walls[:4].T.contiguous(),
                      aabb.contiguous(),
                      accel.super_aabbs(aabb, group).contiguous(),
                      torch.cat(accel.scene_bounds(aabb)).contiguous(), cs,
                      group)


def _scene_key(scene: Scene, layout):
    """What defines a scene's tables: the identity of its tensors, their
    version counters, which every in-place edit advances (through any
    view), and the cluster layout. None for tensors that keep no counter
    (inference mode)."""
    try:
        return (layout, *((id(x), x._version) for x in scene))
    except RuntimeError:
        return None


_prepared: "OrderedDict[tuple, tuple]" = OrderedDict()


def prepare(scene: Scene) -> AccelScene:
    """Sort and box ``scene`` with the port's cluster size and group
    (:func:`..accel.accel_layout`), once per scene: the result is kept
    under the identity and versions of the scene's tensors (the last
    :data:`PREPARED_SCENES` scenes), so a stream or an engine on a large
    scene sorts its walls at the first call only. A new :class:`Scene`
    (a moved collider builds one) or an in-place edit of a tensor is
    another key and is sorted anew. An entry holds its scene's tensors, so
    an identity cannot be reused while it is cached."""
    layout = accel.accel_layout(scene.n_walls)
    key = _scene_key(scene, layout)
    if key is not None and key in _prepared:
        _prepared.move_to_end(key)
        return _prepared[key][1]
    prep = _build(scene, *layout)
    prepare.builds += 1
    if key is not None:
        _prepared[key] = (scene, prep)
        while len(_prepared) > PREPARED_SCENES:
            _prepared.popitem(last=False)
    return prep


def check_accel_supported(scene: Scene, params: TraceParams,
                          max_bands: int = MAX_BANDS) -> None:
    """Raise for a configuration the cluster kernels do not take; such a
    configuration is never rerouted to the plain path."""
    if scene.n_bands > max_bands:
        raise NotImplementedError(
            f"the cluster kernels trace at most {max_bands} band(s) (scene "
            f"has K={scene.n_bands}); wider bands are still to port "
            "(ROADMAP queue 2 A2). backend='plain' traces them.")
    bk.check_single_source(params)
    check_patterns(params)
    if params.listeners.shape[0] > bk.MAX_LISTENERS:
        raise NotImplementedError(
            f"{params.listeners.shape[0]} listeners exceed the kernels' "
            f"{bk.MAX_LISTENERS}-listener table; blocked listener launches "
            "are still to port (ROADMAP queue 2 A3)")


def _patterns(params: TraceParams):
    """The kernel arguments of the patterns: (source ptr, C_s, microphone
    ptr, C_m) and the tables that keep them alive; nulls for omni."""
    src, mic = bk.pattern_tables(params.directivity, params.mic_directivity,
                                 1, params.listeners.shape[0],
                                 params.listeners.device)
    if src is None:
        return (None, 0, None, 0), ()
    return (src.data_ptr(), src.shape[-1], mic.data_ptr(),
            mic.shape[-1]), (src, mic)


def _uniforms(scene, seed, n_frames, n_rays, max_bounces, uniforms):
    if uniforms is None:
        return rng.philox_uniforms(seed, n_frames, max_bounces, n_rays,
                                   scene.device)
    emit, u = uniforms
    if emit.shape != (n_frames, n_rays) or \
            u.shape != (n_frames, max_bounces, n_rays, 3):
        raise ValueError(
            f"uniforms must be emit[{n_frames}, {n_rays}] and u[{n_frames}, "
            f"{max_bounces}, {n_rays}, 3]; got {tuple(emit.shape)} and "
            f"{tuple(u.shape)}")
    return emit, u


def _trace_rays_plain(prep: AccelScene, params: TraceParams,
                      emit: torch.Tensor, u: torch.Tensor, *, resort: bool,
                      ray_chunk: Optional[int], sample_rate: int,
                      ir_length: int) -> torch.Tensor:
    """The ``F * R`` rays of all frames bounce by bounce through
    ``ops/trace.py::_bounce`` on the sorted scene, each fed the numbers of
    its original (frame, ray) id and its hits scattered after every
    bounce; with ``resort`` each bounce leaves the rays' sort keys
    (:func:`..accel.morton_ray_keys`) and the next one reads its rays
    through the permutation that sorts them, as K8 does. ``ray_chunk`` runs
    each bounce over slices of that many rays (all at once if None): the
    rays are independent, so the slices bound the ``[rays, walls]``
    temporaries and move only the float summation order of the IR."""
    n_frames, n_rays = emit.shape
    frames = [_emit(params, n_rays, prep.scene.n_bands, emit[f])
              for f in range(n_frames)]
    st = _RayState(*(torch.cat(xs) for xs in zip(*frames)))
    n = n_frames * n_rays
    step = n if ray_chunk is None else ray_chunk
    ids = torch.arange(n, device=emit.device)
    lo, span = prep.bounds[:2], prep.bounds[2:]
    ir = 0.0
    perm = None
    for b in range(u.shape[1]):
        if perm is not None:    # slot s holds the ray the sort put there
            st = _RayState(*(x[perm] for x in st))
            ids = ids[perm]
        ub = u[:, b].reshape(-1, 3)[ids]
        parts = []
        for r0 in range(0, n, step):
            s = slice(r0, r0 + step)
            part, (delay, energy, valid, _, _) = _bounce(
                prep.scene, params, _RayState(*(x[s] for x in st)), ub[s])
            ir = ir + scatter_hits(
                Hits(delay[None], energy[None], valid[None]), sample_rate,
                ir_length)
            parts.append(part)
        st = _RayState(*(torch.cat(xs) for xs in zip(*parts)))
        if resort and b + 1 < u.shape[1]:
            perm = torch.sort(accel.morton_ray_keys(
                st.pos[:, 0], st.pos[:, 1], st.alive, lo, span)).indices
    return ir


def trace_frames_ir_accel_plain(scene: Scene, params: TraceParams, seed: int,
                                n_frames: int, *, n_rays: int,
                                max_bounces: int, sample_rate: int,
                                ir_length: int, uniforms=None,
                                ray_chunk: Optional[int] = None
                                ) -> torch.Tensor:
    """Plain version of K7: :func:`.bounce_kernel.trace_frames_ir_plain`
    on the :func:`..accel.cluster_scene`-sorted scene, fed the Philox
    numbers the kernel draws for ``seed`` or host ``uniforms = (emit[F,
    R], u[F, B, R, 3])``. Returns ``[L, T, K]``. With ``ray_chunk`` the
    same trace runs each bounce over slices of that many rays (a
    ``[131072, 40008]`` f32 temporary would take 21 GB), scattering the
    hits bounce by bounce."""
    emit, u = _uniforms(scene, seed, n_frames, n_rays, max_bounces, uniforms)
    prep = prepare(scene)
    if ray_chunk is None:
        return bk.trace_frames_ir_plain(prep.scene, params, emit, u,
                                        sample_rate=sample_rate,
                                        ir_length=ir_length)
    _check_supported(params)
    return _trace_rays_plain(prep, params, emit, u, resort=False,
                             ray_chunk=ray_chunk, sample_rate=sample_rate,
                             ir_length=ir_length)


def trace_frames_ir_accel_sorted_plain(scene: Scene, params: TraceParams,
                                       seed: int, n_frames: int, *,
                                       n_rays: int, max_bounces: int,
                                       sample_rate: int, ir_length: int,
                                       uniforms=None,
                                       ray_chunk: Optional[int] = None
                                       ) -> torch.Tensor:
    """Plain version of K8: the ``F * R`` rays of all frames bounce by
    bounce through ``ops/trace.py::_bounce`` on the sorted scene, each fed
    the numbers of its original (frame, ray) id, their hits scattered
    after every bounce, and the rays re-sorted by
    :func:`..accel.morton_ray_keys` between bounces. ``ray_chunk`` runs
    each bounce over slices of that many rays. Returns ``[L, T, K]``."""
    emit, u = _uniforms(scene, seed, n_frames, n_rays, max_bounces, uniforms)
    _check_supported(params)
    return _trace_rays_plain(prepare(scene), params, emit, u, resort=True,
                             ray_chunk=ray_chunk, sample_rate=sample_rate,
                             ir_length=ir_length)


def trace_frames_ir_accel(scene: Scene, params: TraceParams, seed: int,
                          n_frames: int, *, n_rays: int, max_bounces: int,
                          sample_rate: int, ir_length: int,
                          early_out: bool = True,
                          work_counts: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """K7: ``n_frames`` frames of any wall count and 1 <= K <= 8 bands in
    one launch -> frame-summed IR ``[L, T, K]``. CPU scenes run
    :func:`trace_frames_ir_accel_plain`.

    ``work_counts``: an int64 CUDA tensor ``[3]`` to which the launch adds
    the wall tests, wall sweeps and slab tests it really made."""
    if scene.device.type != "cuda":
        return trace_frames_ir_accel_plain(
            scene, params, seed, n_frames, n_rays=n_rays,
            max_bounces=max_bounces, sample_rate=sample_rate,
            ir_length=ir_length)
    check_accel_supported(scene, params)
    prep = prepare(scene)
    dev = scene.device
    n_l, n_k = params.listeners.shape[0], scene.n_bands
    lis = params.listeners.contiguous()
    scal = bk.pack_scalars(params)
    for name, x in (("listeners", lis), ("scalars", scal)):
        bk._check_tensor(name, x, dev)
    if work_counts is not None:
        bk._check_tensor("work_counts", work_counts, dev, (3,), torch.int64)
    scale = bk.fixed_point_scale(params, n_frames, n_rays,
                                 max_bounces).reshape(1)
    acc = torch.empty((n_l, ir_length, n_k), dtype=torch.int64, device=dev)
    out = torch.empty((n_l, ir_length, n_k), dtype=torch.float32, device=dev)
    key = rng.seed_key(seed)
    pats, _keep = _patterns(params)
    err = _fn("art_accel_frames", _FRAMES_ARGTYPES)(
        prep.walls.data_ptr(), prep.geo.data_ptr(), prep.walls.shape[1], n_k,
        prep.aabb.data_ptr(), prep.saabb.data_ptr(), prep.n_clusters,
        prep.group, prep.cluster_size, lis.data_ptr(), n_l, *pats,
        scal.data_ptr(),
        float(sample_rate), key[0], key[1], n_rays, max_bounces, n_frames,
        ir_length, scale.data_ptr(), acc.data_ptr(), out.data_ptr(),
        int(early_out),
        work_counts.data_ptr() if work_counts is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "accel kernel K7")
    trace_frames_ir_accel.launches += 1
    return out


def trace_frames_ir_accel_sorted(scene: Scene, params: TraceParams,
                                 seed: int, n_frames: int, *, n_rays: int,
                                 max_bounces: int, sample_rate: int,
                                 ir_length: int, early_out: bool = True,
                                 work_counts: Optional[torch.Tensor] = None,
                                 keys_out: Optional[list] = None
                                 ) -> torch.Tensor:
    """K8: ``max_bounces`` launches over the ``F * R`` rays of all frames,
    K = 1 -> frame-summed IR ``[L, T, 1]``. A launch writes every ray to
    its slot of a second state buffer together with its next sort key
    (:func:`..accel.morton_ray_keys`, computed in the kernel; dead rays
    last); between two launches the wrapper only sorts the keys (one
    ``torch.sort``), and the next launch reads slot ``s``'s ray at
    ``perm[s]`` of the buffer the last one wrote. Each block orders the
    super boxes near to far from its own rays in the kernel; the order
    changes only the speed. CPU scenes run
    :func:`trace_frames_ir_accel_sorted_plain`. ``work_counts`` as for
    :func:`trace_frames_ir_accel`, summed over the launches. ``keys_out``,
    a list, receives after each launch ``(state[8, N], istate[2, N],
    keys[N])`` as the kernel left them (clones: a check of the in-kernel
    keys against :func:`..accel.morton_ray_keys`)."""
    if scene.device.type != "cuda":
        return trace_frames_ir_accel_sorted_plain(
            scene, params, seed, n_frames, n_rays=n_rays,
            max_bounces=max_bounces, sample_rate=sample_rate,
            ir_length=ir_length)
    check_accel_supported(scene, params, max_bands=1)
    prep = prepare(scene)
    dev = scene.device
    n_l = params.listeners.shape[0]
    lis = params.listeners.contiguous()
    scal = bk.pack_scalars(params)
    for name, x in (("listeners", lis), ("scalars", scal)):
        bk._check_tensor(name, x, dev)
    if work_counts is not None:
        bk._check_tensor("work_counts", work_counts, dev, (3,), torch.int64)
    scale = bk.fixed_point_scale(params, n_frames, n_rays,
                                 max_bounces).reshape(1)
    n = n_frames * n_rays
    state = torch.empty((2, 8, n), dtype=torch.float32, device=dev)
    istate = torch.empty((2, 2, n), dtype=torch.int32, device=dev)
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    acc = torch.zeros((n_l, ir_length), dtype=torch.int64, device=dev)
    key = rng.seed_key(seed)
    pats, _keep = _patterns(params)
    fn = _fn("art_accel_bounce", _BOUNCE_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    perm = None
    for b in range(max_bounces):
        src, dst = (b + 1) % 2, b % 2
        err = fn(prep.walls.data_ptr(), prep.geo.data_ptr(),
                 prep.walls.shape[1], prep.aabb.data_ptr(),
                 prep.saabb.data_ptr(), prep.n_clusters, prep.group,
                 prep.cluster_size, lis.data_ptr(), n_l, *pats,
                 scal.data_ptr(), prep.bounds.data_ptr(), float(sample_rate),
                 key[0], key[1], n_rays, n, max_bounces, b, ir_length,
                 scale.data_ptr(),
                 perm.data_ptr() if perm is not None else None,
                 state[src].data_ptr(), istate[src].data_ptr(),
                 state[dst].data_ptr(), istate[dst].data_ptr(),
                 keys.data_ptr(), acc.data_ptr(), int(early_out),
                 work_counts.data_ptr() if work_counts is not None else None,
                 stream)
        _check(err, "accel kernel K8")
        trace_frames_ir_accel_sorted.launches += 1
        if keys_out is not None:
            keys_out.append((state[dst].clone(), istate[dst].clone(),
                             keys.clone()))
        if b + 1 < max_bounces:
            perm = torch.sort(keys).indices
    out = torch.empty((n_l, ir_length, 1), dtype=torch.float32, device=dev)
    _check(_fn("art_fixed_to_float", (_P, _P, _P, ctypes.c_longlong, _P))(
        acc.data_ptr(), scale.data_ptr(), out.data_ptr(), acc.numel(),
        stream), "fixed-to-float")
    return out


trace_frames_ir_accel.launches = 0
trace_frames_ir_accel_sorted.launches = 0
prepare.builds = 0
