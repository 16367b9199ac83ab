"""Cluster-early-out kernels of the large-scene path: wrappers, plain
versions and launch counts.

One entry point, :func:`trace_frames_ir_accel_sorted`, launches the sorted
bounce kernel of ``csrc/accel_kernel.cu`` on a scene that :func:`prepare`
Morton-sorts and boxes (:func:`..accel.cluster_scene`) once and keeps for
later calls on the same scene tensors: one launch per bounce over all
frames' rays, the rays re-sorted along a Morton curve of their positions
between launches (the kernel writes the keys, the wrapper sorts them, the
next launch reads its rays through the permutation), each block visiting
the super boxes near to far from its own rays. It covers two TPU kernels
of the JAX package (``ops/pallas/bounce_kernel.py``):

* K8 (``::trace_frames_ir_accel_sorted``): the kernel's one-band
  instantiation, K = 1;
* K7 (``::trace_frames_ir_accel``): its banded instantiations, any K: a
  ray's K energies ride with it in an energy buffer (in registers for
  K <= 8, :data:`BAND_BUCKETS`; past that the kernel works on them in
  place), and frames whose energies would exceed
  :data:`.bounce_kernel.SCRATCH_FLOATS` run in passes of B launches.
  :func:`trace_frames_ir_accel` keeps the JAX name and calls the same
  function.

The kernel takes directive sources and microphones
(``TraceParams.directivity`` / ``mic_directivity``) through its directive
instantiation, as the bounce kernel does
(``bounce_kernel.pattern_tables``), and any listener count: listeners
past what one block's shared memory holds beside the super boxes run in
blocks, one call's launches each, over the same random
numbers and scale, so the blocks give the whole launch's bits.

They return the frame-SUMMED IR ``[L, T, K]`` and draw Philox numbers in
the kernel under the key of ``seed``, counter (ray, frame, bounce,
entry): with ``entry=0`` the numbers K4 draws, so on a sorted scene K7
and K8 equal K4 bit for bit. ``frame_offset`` moves the frames to
``frame_offset ..`` of the stream, as K4's does (the shard of a
frame-sharded run); 0 gives the bits of the launch without it.
``early_out=False`` visits every cluster (the brute-force yardstick) and
gives the same bits.

:func:`trace_rooms_ir_accel` is the batched path of scenes past the bounce
kernel's wall limit (sweeps and mixdowns): one K8 (K = 1) or K7 call per
entry, entry ``e`` drawing the numbers of entry ``entry_offset + e``, as
K9 and its plain version do.

On a CUDA scene they launch the kernel or raise; on a CPU scene they run
their plain version, :func:`trace_frames_ir_accel_sorted_plain` (the plain
trace bounce by bounce on the re-sorted rays), which is also what the
kernels are held against on the card; :func:`trace_frames_ir_accel_plain`
(the plain trace + scatter on the sorted scene, rays in their emission
order) is the tests' reference for the unsorted order. The launches
count by instantiation, K8's in ``trace_frames_ir_accel_sorted.launches``
and K7's in ``trace_frames_ir_accel.launches``: ``max_bounces`` per
listener block and pass of frames; ``prepare.builds`` counts the scenes
:func:`prepare` really sorted.
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

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_BOUNCE_ARGTYPES = (_P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P,
                    _I, _P, _P, ctypes.c_float, _U, _U, _U, _U, _I, _I, _I,
                    _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                    _P, _P)
# frames a launch can draw: the Philox counter's frame word is 32 bits
FRAME_WORDS = 1 << 32
# scenes whose sorted tables prepare() keeps
PREPARED_SCENES = 8
# K7's register buckets of a ray's band energies (csrc/accel_kernel.cu::
# kAccelLargestBucket); past the last one the wide kernel, which works on
# the energies in place in the energy buffer
BAND_BUCKETS = (1, 8)


def _fn(name, argtypes):
    fn = getattr(build.load_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


class AccelScene(NamedTuple):
    """A scene ready for the cluster kernels and the wall sweeps' box walk:
    Morton-sorted and padded to ``C * cluster_size`` walls, its wall table,
    cluster and super boxes, the window the rays' sort keys are quantized
    in, and the sort's permutation (``ids``: the caller's index of each
    sorted wall, which K1 reports)."""

    scene: Scene
    walls: torch.Tensor    # [11 + K - 1, Wp] f32 (pack_walls + bands 1..)
    geo: torch.Tensor      # [Wp, 4] f32: ax, ay, v2x, v2y (16-byte loads)
    aabb: torch.Tensor     # [C, 4] f32
    saabb: torch.Tensor    # [C / group, 4] f32
    bounds: torch.Tensor   # [4] f32: accel.scene_bounds lo x, lo y, span x, y
    cluster_size: int
    group: int
    ids: torch.Tensor      # [Wp] i32: the index in the scene of each wall

    @property
    def n_clusters(self) -> int:
        return self.aabb.shape[0]


def _build(scene: Scene, cs: int, group: int) -> AccelScene:
    scene_s, aabb, ids = accel.cluster_scene_ids(scene, cs, group)
    walls = bk.pack_walls_banded(scene_s)
    return AccelScene(scene_s, walls, walls[:4].T.contiguous(),
                      aabb.contiguous(),
                      accel.super_aabbs(aabb, group).contiguous(),
                      torch.cat(accel.scene_bounds(aabb)).contiguous(), cs,
                      group, ids.contiguous())


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


def check_accel_supported(scene: Scene, params: TraceParams) -> None:
    """Raise for a configuration the cluster kernels do not take (a batch
    of sources, patterns of the wrong shape); such a configuration is
    never rerouted to the plain path. Any band and listener count
    passes."""
    bk.check_single_source(params)
    check_patterns(params)


def _listener_step(prep: "AccelScene", n_src: int, n_mic: int) -> int:
    """Listeners per launch: what one block's shared memory holds beside
    the super boxes (16 B each), their visit order and keys (8 B each) and
    the order reduction's 96 B."""
    n_super = prep.n_clusters // prep.group
    boxes = n_super * 6 + 24
    step = bk.listener_block(0, n_src, n_mic, table_floats=boxes)
    if step < 1:
        raise NotImplementedError(
            f"{n_super} super boxes and {n_src} + {n_mic} pattern "
            "coefficients exceed a block's shared memory; backend='plain' "
            "traces them")
    return step


def check_frame_offset(frame_offset: int, n_frames: int) -> None:
    """Raise for frames ``frame_offset .. frame_offset + n_frames - 1``
    that leave the Philox counter's 32-bit frame word (the kernel refuses
    such a launch; nothing wraps)."""
    if frame_offset < 0 or frame_offset + n_frames > FRAME_WORDS:
        raise ValueError(
            f"frames {frame_offset} .. {frame_offset + n_frames - 1} leave "
            f"the Philox frame word [0, {FRAME_WORDS})")


def _uniforms(scene, seed, n_frames, n_rays, max_bounces, uniforms,
              entry=0, frame_offset=0):
    check_frame_offset(frame_offset, n_frames)
    if uniforms is None:
        return rng.philox_uniforms(seed, n_frames, max_bounces, n_rays,
                                   scene.device, entry=entry,
                                   first_frame=frame_offset)
    if frame_offset:
        raise ValueError("uniforms= are the frames' numbers themselves: a "
                         "frame offset names Philox frames and takes no "
                         "uniforms")
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
                                ray_chunk: Optional[int] = None,
                                entry: int = 0,
                                frame_offset: int = 0) -> torch.Tensor:
    """The unsorted reference of K7 and K8 (the tests'; the JAX K7's
    order): :func:`.bounce_kernel.trace_frames_ir_plain`
    on the :func:`..accel.cluster_scene`-sorted scene, fed the Philox
    numbers the kernel draws for ``seed``, ``entry`` and ``frame_offset``
    or host ``uniforms = (emit[F, R], u[F, B, R, 3])``. Returns
    ``[L, T, K]``.
    With ``ray_chunk`` the same trace runs each bounce over slices of that
    many rays (a ``[131072, 40008]`` f32 temporary would take 21 GB),
    scattering the hits bounce by bounce."""
    emit, u = _uniforms(scene, seed, n_frames, n_rays, max_bounces, uniforms,
                        entry, frame_offset)
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
                                       ray_chunk: Optional[int] = None,
                                       entry: int = 0,
                                       frame_offset: int = 0
                                       ) -> torch.Tensor:
    """Plain version of K7 and K8: the ``F * R`` rays of all frames bounce
    by bounce through ``ops/trace.py::_bounce`` on the sorted scene, each fed
    the numbers of its original (frame, ray) id (and ``entry``; frame
    ``f`` draws Philox frame ``frame_offset + f``), their hits scattered
    after every bounce, and the rays re-sorted by
    :func:`..accel.morton_ray_keys` between bounces. ``ray_chunk`` runs
    each bounce over slices of that many rays. Returns ``[L, T, K]``."""
    emit, u = _uniforms(scene, seed, n_frames, n_rays, max_bounces, uniforms,
                        entry, frame_offset)
    _check_supported(params)
    return _trace_rays_plain(prepare(scene), params, emit, u, resort=True,
                             ray_chunk=ray_chunk, sample_rate=sample_rate,
                             ir_length=ir_length)


def trace_frames_ir_accel(scene: Scene, params: TraceParams, seed: int,
                          n_frames: int, *, n_rays: int, max_bounces: int,
                          sample_rate: int, ir_length: int,
                          early_out: bool = True, entry: int = 0,
                          frame_offset: int = 0,
                          work_counts: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """K7: ``n_frames`` frames of any wall count and any K bands ->
    frame-summed IR ``[L, T, K]``. K7 is the banded instantiations of the
    sorted bounce kernel, so this is :func:`trace_frames_ir_accel_sorted`
    (the name mirrors the JAX package's ``trace_frames_ir_accel``); its
    launches at K > 1 count in ``trace_frames_ir_accel.launches``, those at
    K = 1 in K8's."""
    return trace_frames_ir_accel_sorted(
        scene, params, seed, n_frames, n_rays=n_rays,
        max_bounces=max_bounces, sample_rate=sample_rate,
        ir_length=ir_length, early_out=early_out, entry=entry,
        frame_offset=frame_offset, work_counts=work_counts)


def _blocks(prep: AccelScene, params: TraceParams):
    """The listener blocks of a K7/K8 call: (pattern arguments and the
    tables that keep them alive, first listener, count) of each."""
    src, mic = bk.pattern_tables(params.directivity, params.mic_directivity,
                                 1, params.listeners.shape[0],
                                 params.listeners.device)
    n_src, n_mic = bk._pattern_sizes(src, mic)
    n_l = params.listeners.shape[0]
    step = _listener_step(prep, n_src, n_mic)
    for l0 in range(0, n_l, step):
        n_b = min(step, n_l - l0)
        if src is None:
            yield ((None, 0, None, 0), ()), l0, n_b
        else:
            mic_b = mic[0, l0:l0 + n_b].contiguous()
            yield ((src.data_ptr(), n_src, mic_b.data_ptr(), n_mic),
                   (src, mic_b)), l0, n_b


def energy_rows(n_bands: int) -> int:
    """Floats per ray of K7's energy buffer: K padded to a multiple of 4
    (the register bucket's ray-major rows, read by 16-byte loads; the
    wide kernel keeps its K bands band-major in the same buffer); 0 at
    K = 1, whose energy rides in the state."""
    return 0 if n_bands == 1 else -(-n_bands // 4) * 4


def frames_per_pass(n_bands: int, n_frames: int, n_rays: int) -> int:
    """The frames one pass of B launches takes: all of them, unless the
    two energy buffers of K > 1 bands would exceed
    :data:`.bounce_kernel.SCRATCH_FLOATS`; then as many as fit (at least
    one)."""
    per_frame = 2 * n_rays * energy_rows(n_bands)
    if per_frame == 0:
        return n_frames
    return max(1, min(n_frames, bk.SCRATCH_FLOATS // per_frame))


def _run_sorted(scene, params, seed, n_frames, n_rays, max_bounces,
                sample_rate, ir_length, early_out, entry, frame_offset,
                work_counts, keys_out) -> torch.Tensor:
    """The launches of a K7/K8 call. For each listener block and each pass
    of frames (:func:`frames_per_pass`): ``max_bounces`` launches over the
    pass's rays, each drawing its frames from ``frame_offset`` on (a
    pass's ray ids, ``id0``, count from the call's first frame); a launch
    writes every ray to its slot of a second state buffer (and, at K > 1,
    its energies to a second energy buffer, of :func:`energy_rows` floats
    a ray) together with its next sort key, and between two launches the
    wrapper only sorts the keys. All passes add
    to one u64 accumulator, converted once. The launches count in K8's
    ``.launches`` at K = 1 and in K7's past it."""
    check_accel_supported(scene, params)
    check_frame_offset(frame_offset, n_frames)
    prep = prepare(scene)
    dev = scene.device
    n_k = scene.n_bands
    counter = (trace_frames_ir_accel_sorted if n_k == 1
               else trace_frames_ir_accel)
    scal = bk.pack_scalars(params)
    bk._check_tensor("scalars", scal, dev)
    bk._check_tensor("listeners", params.listeners, dev)
    if work_counts is not None:
        bk._check_tensor("work_counts", work_counts, dev, (3,), torch.int64)
    scale = bk.fixed_point_scale(params, n_frames, n_rays,
                                 max_bounces).reshape(1)
    chunk = frames_per_pass(n_k, n_frames, n_rays)
    n = chunk * n_rays
    state = torch.empty((2, 8, n), dtype=torch.float32, device=dev)
    istate = torch.empty((2, 2, n), dtype=torch.int32, device=dev)
    kp = energy_rows(n_k)
    energy = torch.empty((2, n * kp), dtype=torch.float32,
                         device=dev) if kp else None
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    key = rng.seed_key(seed)
    fn = _fn("art_accel_bounce", _BOUNCE_ARGTYPES)
    convert = _fn("art_fixed_to_float", (_P, _P, _P, ctypes.c_longlong, _P))
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = []
    for pats, l0, n_b in _blocks(prep, params):
        lis = params.listeners[l0:l0 + n_b].contiguous()
        acc = torch.zeros((n_b, ir_length, n_k), dtype=torch.int64,
                          device=dev)
        for f0 in range(0, n_frames, chunk):
            n_pass = min(chunk, n_frames - f0) * n_rays
            perm = None
            for b in range(max_bounces):
                src, dst = (b + 1) % 2, b % 2
                err = fn(prep.walls.data_ptr(), prep.geo.data_ptr(),
                         prep.walls.shape[1], n_k, prep.aabb.data_ptr(),
                         prep.saabb.data_ptr(), prep.n_clusters, prep.group,
                         prep.cluster_size, lis.data_ptr(), n_b, *pats[0],
                         scal.data_ptr(), prep.bounds.data_ptr(),
                         float(sample_rate), key[0], key[1],
                         int(entry) & 0xFFFFFFFF, int(frame_offset),
                         n_rays, f0 * n_rays, n_pass, max_bounces, b,
                         ir_length, scale.data_ptr(),
                         perm.data_ptr() if perm is not None else None,
                         state[src].data_ptr(), istate[src].data_ptr(),
                         state[dst].data_ptr(), istate[dst].data_ptr(),
                         bk._ptr(None if energy is None else energy[src]),
                         bk._ptr(None if energy is None else energy[dst]),
                         keys.data_ptr(), acc.data_ptr(),
                         int(early_out),
                         work_counts.data_ptr() if work_counts is not None
                         else None, stream)
                _check(err, "accel kernel")
                counter.launches += 1
                if keys_out is not None:
                    keys_out.append((state[dst, :, :n_pass].clone(),
                                     istate[dst, :, :n_pass].clone(),
                                     keys[:n_pass].clone()))
                if b + 1 < max_bounces:
                    perm = torch.sort(keys[:n_pass]).indices
        out = torch.empty((n_b, ir_length, n_k), dtype=torch.float32,
                          device=dev)
        _check(convert(acc.data_ptr(), scale.data_ptr(), out.data_ptr(),
                       acc.numel(), stream), "fixed-to-float")
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def trace_frames_ir_accel_sorted(scene: Scene, params: TraceParams,
                                 seed: int, n_frames: int, *, n_rays: int,
                                 max_bounces: int, sample_rate: int,
                                 ir_length: int, early_out: bool = True,
                                 entry: int = 0, frame_offset: int = 0,
                                 work_counts: Optional[torch.Tensor] = None,
                                 keys_out: Optional[list] = None
                                 ) -> torch.Tensor:
    """K8 and K7: ``max_bounces`` launches over the ``F * R`` rays of all
    frames -> frame-summed IR ``[L, T, K]``, through the sorted bounce
    kernel's one-band instantiation (K8; the JAX K8 traces K = 1) or its
    banded ones (K7, any K: a ray's K energies ride with it in an energy
    buffer, in registers for K <= 8). A launch writes every
    ray to its slot of a second state buffer together with its next sort
    key (:func:`..accel.morton_ray_keys`, computed in the kernel; dead rays
    last); between two launches the wrapper only sorts the keys (one
    ``torch.sort``), and the next launch reads slot ``s``'s ray at
    ``perm[s]`` of the buffer the last one wrote. Each block orders the
    super boxes near to far from its own rays in the kernel; the order
    changes only the speed. CPU scenes run
    :func:`trace_frames_ir_accel_sorted_plain`.

    ``entry``: Philox counter word 3, the global id of a batch entry (0:
    K4's numbers). ``frame_offset``: frame ``f`` draws Philox frame
    ``frame_offset + f`` (counter word 1, as K4's argument of that name:
    the shard of a frame-sharded run), in every pass and listener block;
    0 keeps the bits of the call without it. ``work_counts``: an int64
    CUDA tensor ``[3]`` to which the launches add the wall tests, wall
    sweeps and slab tests they really made (a listener block reruns every
    bounce on the same rays). ``keys_out``, a list, receives after each
    launch ``(state[8, N], istate[2, N], keys[N])`` as
    the kernel left them (clones: a check of the in-kernel keys against
    :func:`..accel.morton_ray_keys`)."""
    if scene.device.type != "cuda":
        return trace_frames_ir_accel_sorted_plain(
            scene, params, seed, n_frames, n_rays=n_rays,
            max_bounces=max_bounces, sample_rate=sample_rate,
            ir_length=ir_length, entry=entry, frame_offset=frame_offset)
    return _run_sorted(scene, params, seed, n_frames, n_rays, max_bounces,
                       sample_rate, ir_length, early_out, entry, frame_offset,
                       work_counts, keys_out)


def _accel_entries(scenes: Scene, sources, listeners, kw):
    """The scene, params and entry id of each entry of a large-scene
    batch: ``scenes`` stacked ``[E, W, ...]`` or one scene (unstacked, or
    stacked with a leading 1) that every entry shares, which is then
    prepared once."""
    shared = scenes.a.dim() == 2 or scenes.a.shape[0] == 1
    one = scenes if scenes.a.dim() == 2 else (
        scenes.row(0) if shared else None)
    stacked = scenes if scenes.a.dim() == 3 else Scene(
        *(x[None] for x in scenes))
    src, lis, radius, c, gain = bk._batch_inputs(
        stacked, sources, listeners, kw["listener_radius"],
        kw["speed_of_sound"], kw["input_gain"])
    entries = bk.batch_params(src, lis, radius, c, gain, kw["directivity"],
                              kw["mic_directivity"], scenes.device)
    for e, params in enumerate(entries):
        yield (one if shared else scenes.row(e)), params, \
            kw["entry_offset"] + e


def _rooms_kw(listener_radius, speed_of_sound, input_gain, entry_offset,
              directivity, mic_directivity):
    return dict(listener_radius=listener_radius,
                speed_of_sound=speed_of_sound, input_gain=input_gain,
                entry_offset=entry_offset, directivity=directivity,
                mic_directivity=mic_directivity)


def trace_rooms_ir_accel_plain(scenes: Scene, sources, listeners, seed: int,
                               n_frames: int, *, n_rays: int,
                               max_bounces: int, sample_rate: int,
                               ir_length: int, listener_radius=0.5,
                               speed_of_sound=343.0, input_gain=1.0,
                               entry_offset: int = 0, directivity=None,
                               mic_directivity=None,
                               ray_chunk: Optional[int] = None
                               ) -> torch.Tensor:
    """Plain version of :func:`trace_rooms_ir_accel`: each entry through
    :func:`trace_frames_ir_accel_sorted_plain` on the numbers of entry
    ``entry_offset + e``. Returns ``[E, L, T, K]``."""
    kw = _rooms_kw(listener_radius, speed_of_sound, input_gain, entry_offset,
                   directivity, mic_directivity)
    irs = []
    for scene, params, entry in _accel_entries(scenes, sources, listeners,
                                               kw):
        irs.append(trace_frames_ir_accel_sorted_plain(
            scene, params, seed, n_frames, n_rays=n_rays,
            max_bounces=max_bounces, sample_rate=sample_rate,
            ir_length=ir_length, ray_chunk=ray_chunk, entry=entry))
    return torch.stack(irs)


def trace_rooms_ir_accel(scenes: Scene, sources, listeners, seed: int,
                         n_frames: int, *, n_rays: int, max_bounces: int,
                         sample_rate: int, ir_length: int,
                         listener_radius=0.5, speed_of_sound=343.0,
                         input_gain=1.0, entry_offset: int = 0,
                         directivity=None, mic_directivity=None
                         ) -> torch.Tensor:
    """The batched paths (sweep, mixdown) on scenes past the bounce
    kernel's wall limit: one K8 (K = 1) or K7 call per entry,
    entry ``e`` drawing the Philox numbers of entry ``entry_offset + e``
    (the numbers it draws in K9 and in
    :func:`.bounce_kernel.trace_rooms_ir_mega_plain`). The arguments are
    :func:`.bounce_kernel.trace_rooms_ir_mega`'s; ``scenes`` may also be
    one unstacked scene that every entry shares. Each distinct scene is
    sorted by :func:`prepare` (which keeps the last
    :data:`PREPARED_SCENES`); a shared scene is sorted once. Returns the
    frame-summed ``[E, L, T, K]``. CPU scenes run
    :func:`trace_rooms_ir_accel_plain`."""
    kw = _rooms_kw(listener_radius, speed_of_sound, input_gain, entry_offset,
                   directivity, mic_directivity)
    if scenes.device.type != "cuda":
        return trace_rooms_ir_accel_plain(
            scenes, sources, listeners, seed, n_frames, n_rays=n_rays,
            max_bounces=max_bounces, sample_rate=sample_rate,
            ir_length=ir_length, **kw)
    irs = []
    for scene, params, entry in _accel_entries(scenes, sources, listeners,
                                               kw):
        irs.append(trace_frames_ir_accel_sorted(
            scene, params, seed, n_frames, n_rays=n_rays,
            max_bounces=max_bounces, sample_rate=sample_rate,
            ir_length=ir_length, entry=entry))
    return torch.stack(irs)


trace_frames_ir_accel.launches = 0
trace_frames_ir_accel_sorted.launches = 0
prepare.builds = 0
