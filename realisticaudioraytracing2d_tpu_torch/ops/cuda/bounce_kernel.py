"""Bounce kernels: wrappers, plain versions and launch counts.

Three entry points launch the one whole-frame CUDA template of
``csrc/bounce_kernel.cu``:

* :func:`trace_frames_ir_whole` (K3) takes host uniforms ``emit[F, R]`` and
  ``u[F, B, R, 3]``; it replaces ``ops/pallas/bounce_kernel.py::
  trace_frame_ir_whole`` of the JAX package;
* :func:`trace_frames_ir_mega` (K4) draws Philox numbers in the kernel
  from an integer seed; it replaces ``::trace_frames_ir_mega``;
* :func:`trace_rooms_ir_mega` (K9) is K4 over a batch of E entries (the
  rooms of a sweep, or the sources of a mixdown over one shared scene),
  each with its own tables, random stream and fixed-point scale; it
  replaces ``::trace_rooms_ir_mega``.

Two more serve one frame:

* :func:`trace_fused_rows` (K5) returns the raw hit rows ``[B, 8, R]`` of
  one frame (one listener, one band), the hit-record form that
  :func:`scatter_hits_rows` bins and :func:`trace_fused` turns into
  :class:`..trace.Hits`; it replaces ``::trace_fused_rows``. Its kernel,
  ``frame_rows_kernel``, runs the same bounce loop as K3 (all B bounces
  of a ray in one launch, in lane groups) and stores each bounce's hits
  as rows in place of binning them;
* :func:`trace_frame_ir_fused` (K6) returns one frame's IR ``[L, T, 1]``
  binned in the kernel; it replaces ``::trace_frame_ir_fused``, and it is
  K3's launch at one frame (K4's with a seed), so it equals K3 on the
  same uniforms and K4 on the same seed bit for bit.

:func:`trace_accumulate_fused` is the JAX function's ``exact_scatter``
route: a K5 pass per listener and a float scatter of its rows.

Every entry point takes directive sources and microphones
(``TraceParams.directivity`` / ``mic_directivity``; K9 per-entry tables):
the kernels' directive instantiation weights emission and every hit by
the patterns, evaluated by ``ops/directivity.py::fourier_gain``'s
recurrence, and an omni-coded pattern ``[1.]`` gives the omni bits. When
only one of the two patterns is given, the other goes to the kernel as
``[1.]``.

K3, K4 and K9 take any band count K (a ray's K energies in registers up to
32 bands, :data:`BAND_BUCKETS`, past that in a device scratch) and any
listener count: where a scene's listeners and its wall table do not fit
one block's shared memory together, the wrapper launches the listeners in
blocks over the same random numbers and the same fixed-point scale, which
reproduces the whole launch bit for bit (ray physics never reads the
listener table). K5 and K6 take one band, as in the JAX package, and K6
at most 16 listeners. A K3, K4, K5 or K9 launch too small to fill the
card (the stream's one frame of 15,000 rays) runs in lane groups, 4
threads per ray that split its wall scans (:func:`lane_group`), with the
same bits.

K3 and K4 return the frame-SUMMED IR ``[L, T, K]`` float32, K9
``[E, L, T, K]``. On a CUDA scene they launch the kernel or raise; on a
CPU scene they run their plain version, :func:`trace_frames_ir_plain`
(the oracle trace + scatter, summed over frames),
:func:`trace_frames_ir_mega_plain` and :func:`trace_rooms_ir_mega_plain`
(the same on the kernel's Philox numbers), :func:`trace_fused_rows_plain`
and :func:`trace_frame_ir_fused_plain` (``ops/trace.py::_bounce`` one
bounce at a time on an explicit state), which are also what the kernels
are held against on the card. Each entry point counts its launches in
``.launches`` (K5 and K6: one per call; K3, K4 and K9 one per listener
block, or one per chunk of (entry, frame) planes where the scratch takes
them in chunks).

K3, K4 and K6 get their launch's arguments (the wall table, the scalars
and the fixed-point scale) from one launch of :func:`k4_args`
(``csrc/k4_args_kernel.cu``), counted in ``k4_args.launches``; its plain
twin :func:`k4_args_plain` (:func:`pack_walls_banded`,
:func:`pack_scalars`, :func:`fixed_point_scale`) gives the same bits and
is the CPU path. K9 packs its batch with PyTorch calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...models.scene import Scene
from .. import rng
from ..ir import IRState, add_rows, scatter_hits
from ..directivity import max_gain
from ..trace import (Hits, TraceParams, _bounce, _check_supported as
                     _check_trace_supported, _emit, check_patterns,
                     check_single_source, trace_hits_only)
from . import build
from ...utils.profiling import span

# 44 B per wall in the 227 KB of shared memory a block can use, leaving
# room for 16 listeners (kMaxWalls in csrc/bounce_kernel.cu): the routing
# limit, past which scenes go to the cluster kernels
MAX_WALLS = (232448 - 2 * 16 * 4) // (11 * 4)
# batch entries ride the grid's z axis
MAX_ENTRIES = 65535
# the register buckets of a ray's band energies in K3/K4/K9
# (trace_common.cuh::by_bucket): a launch takes the smallest that holds K;
# past the last one the energies live in a device scratch
BAND_BUCKETS = (1, 8, 32)
# the most floats of band scratch a launch allocates (1 GiB); a launch
# whose (entry, frame) planes need more runs them in chunks
SCRATCH_FLOATS = 1 << 28

# the shared memory a block can use, in floats
SMEM_FLOATS = 232448 // 4
# The lane group of K3/K4/K9 (csrc/bounce_kernel.cu::kLaneGroup): lanes
# per (ray, frame, entry) of a launch whose items times LANE_GROUP stay
# within LANE_THREADS, 16 warps per SM of an H100's 132
# (scripts/torch_redesign_k7_k4.py times groups of 2, 4 and 8 and 64-thread
# blocks without groups: PERF.md)
LANE_GROUP = 4
LANE_THREADS = 132 * 16 * 32

_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
             ctypes.c_uint32, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p)


def _kernel_fn():
    fn = build.load_library().art_trace_frames_ir
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def listener_block(n_walls: int, n_src: int = 0, n_mic: int = 0,
                   table_floats: Optional[int] = None) -> int:
    """The most listeners one block's shared memory takes beside a wall
    table of ``n_walls`` walls (``table_floats`` floats in place of the
    bounce kernel's ``11 * n_walls``) and the patterns of a directive
    trace (``n_src`` source and ``n_mic`` microphone coefficients per
    listener; 0 for omni): 2 floats per listener, plus ``n_mic``. A launch
    with more listeners runs them in blocks of this size. 0: not even one
    listener fits."""
    used = (11 * n_walls if table_floats is None else table_floats) + n_src
    return max(0, (SMEM_FLOATS - used) // (2 + n_mic))


def lane_group(n_items: int, n_bands: int) -> int:
    """Lanes per (ray, frame, entry) of a K3/K4/K9 launch of ``n_items``
    such items: :data:`LANE_GROUP` where its ``n_items * LANE_GROUP``
    threads stay within :data:`LANE_THREADS`, so that a small grid spreads
    over the card with lanes that split each ray's scans; 1 for a larger
    grid and for the scratch past 32 bands (the kernel before lane
    groups). Either gives the same IR bit for bit."""
    if band_bucket(n_bands) != 0 and n_items * LANE_GROUP <= LANE_THREADS:
        return LANE_GROUP
    return 1


def band_bucket(n_bands: int, buckets: Optional[tuple] = None) -> int:
    """The register bucket of ``buckets`` (default :data:`BAND_BUCKETS`)
    a launch of ``n_bands`` bands takes (0: the device scratch)."""
    return next((b for b in buckets or BAND_BUCKETS if n_bands <= b), 0)


def _check_supported(n_walls: int, n_src: int = 0, n_mic: int = 0) -> None:
    """``n_src`` / ``n_mic``: the source and per-listener microphone
    coefficients of a directive trace (0 for omni), which share the
    block's shared memory with the wall table."""
    if n_walls <= MAX_WALLS and not listener_block(n_walls, n_src, n_mic):
        raise NotImplementedError(
            f"{n_walls} walls and {n_src} + {n_mic} pattern coefficients "
            "exceed a block's shared memory; trace fewer harmonics, or the "
            "scene with backend='accel' (the cluster kernels) or "
            "backend='plain'")
    if n_walls > MAX_WALLS:
        raise ValueError(
            f"{n_walls} walls exceed the bounce kernel's shared-memory "
            f"limit of {MAX_WALLS}; the cluster kernels K7/K8 "
            "(ops/cuda/accel_kernel.py) trace such scenes, and "
            "engine.trace_accumulate, sweep_rooms and "
            "trace_sources_mixdown route them there")


def _pattern_sizes(src, mic):
    return (0, 0) if src is None else (src.shape[-1], mic.shape[-1])


def check_kernel_supported(scene: Scene, params: TraceParams) -> tuple:
    """Raise for a configuration the kernel does not take
    (``NotImplementedError`` for patterns too large for a block's shared
    memory, ``ValueError`` for a scene past :data:`MAX_WALLS`, which
    ``engine.trace_accumulate`` sends to the cluster kernels, or for
    patterns of the wrong shape). Such configurations are never rerouted
    to the plain path. Any band and listener count passes. Returns the
    kernel's pattern tables ``(src, mic)`` (:func:`pattern_tables`)."""
    check_single_source(params)
    check_patterns(params)
    src, mic = pattern_tables(params.directivity, params.mic_directivity, 1,
                              params.listeners.shape[0], scene.device)
    _check_supported(scene.n_walls, *_pattern_sizes(src, mic))
    return src, mic


def check_batch_supported(scenes: Scene,
                          src: Optional[torch.Tensor] = None,
                          mic: Optional[torch.Tensor] = None) -> None:
    """:func:`check_kernel_supported` for a batch (K9): stacked scenes
    ``[E or 1, W, ...]`` and the per-entry pattern tables of
    :func:`pattern_tables`."""
    _check_supported(scenes.n_walls, *_pattern_sizes(src, mic))


def pattern_tables(directivity, mic_directivity, n_entries: int,
                   n_listeners: int, device):
    """The kernels' per-entry pattern tables, source ``[E, C_s]`` and
    microphones ``[E, L, C_m]`` (float32, contiguous), broadcast from
    ``directivity`` ``[C]`` or ``[E, C]`` and ``mic_directivity`` ``[C]``,
    ``[L, C]`` or ``[E, L, C]`` as the JAX ``trace_rooms_ir_mega`` does;
    a missing one is omni-coded (``[1.]``, the gain 1 exactly).
    ``(None, None)`` when neither is given: the omni kernels."""
    if directivity is None and mic_directivity is None:
        return None, None

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    one = torch.ones(1, dtype=torch.float32, device=device)
    src = one if directivity is None else f32(directivity)
    mic = one if mic_directivity is None else f32(mic_directivity)
    for name, c, lead in (("directivity", src, ((), (1,), (n_entries,))),
                          ("mic_directivity", mic,
                           ((), (n_listeners,), (n_entries, n_listeners)))):
        if c.dim() == 0 or tuple(c.shape[:-1]) not in lead \
                or c.shape[-1] % 2 != 1:
            raise ValueError(
                f"{name} must be [C]" + "".join(
                    f" or [{', '.join(map(str, d))}, C]" for d in lead[1:])
                + f" with an odd C; got {tuple(c.shape)}")
    src = torch.broadcast_to(src.reshape(-1, src.shape[-1]) if src.dim() == 2
                             else src[None], (n_entries, src.shape[-1]))
    if mic.dim() == 1:
        mic = mic[None, None]
    elif mic.dim() == 2:
        mic = mic[None]
    mic = torch.broadcast_to(mic, (n_entries, n_listeners, mic.shape[-1]))
    return src.contiguous(), mic.contiguous()


def pattern_gain_bound(src: Optional[torch.Tensor],
                       mic: Optional[torch.Tensor]):
    """Each entry's bound of the source gain times the loudest
    microphone gain (``[E]`` float64; 1.0 for omni), which the fixed-point
    scale allows for."""
    if src is None:
        return 1.0
    return max_gain(src) * max_gain(mic).amax(-1)


def _check_tensor(name, x, device, shape=None, dtype=torch.float32):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the scene on {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")


def pack_walls_banded(scene: Scene) -> torch.Tensor:
    """The kernels' wall table ``[..., 10 + K, W]``: :func:`pack_walls`
    with the absorption of bands 1 .. K-1 appended as rows 11 .. 9 + K
    (read from global memory, for the hit wall only)."""
    walls = pack_walls(scene)
    if scene.n_bands == 1:
        return walls
    return torch.cat([walls, scene.absorption[..., 1:].transpose(-1, -2)],
                     dim=-2).contiguous()


def pack_walls(scene: Scene) -> torch.Tensor:
    """Wall table ``[..., 11, W]``: ax, ay, v2x, v2y, cc, nx, ny,
    absorption, scattering, transmission, ior (the kernel's shared-memory
    layout), with the leading batch axes of a stacked scene. ``v2`` and
    ``cc`` are computed as the plain trace computes them."""
    ax, ay = scene.a[..., 0], scene.a[..., 1]
    v2x = scene.b[..., 0] - ax
    v2y = scene.b[..., 1] - ay
    cc = v2x * ay - v2y * ax
    return torch.stack([ax, ay, v2x, v2y, cc, scene.normal[..., 0],
                        scene.normal[..., 1], scene.absorption[..., 0],
                        scene.scattering, scene.transmission,
                        scene.ior], dim=-2).contiguous()


def fixed_point_scales(sources: torch.Tensor, listeners: torch.Tensor,
                       gains: torch.Tensor, n_frames: int, n_rays: int,
                       max_bounces: int, pattern_gain=1.0) -> torch.Tensor:
    """Each batch entry's fixed-point scale ``S_e`` (float64 ``[E]`` on the
    inputs' device; computed there, so no host sync) for sources
    ``[E, 2]``, listeners ``[E, L, 2]`` and gains ``[E]``.

    A bin can receive at most ``n_frames * n_rays * 2 * max_bounces`` hits
    of one listener (one direct and one NEE hit per bounce). A direct
    hit carries at most the input gain; an NEE hit at most
    ``gain * 0.5 / d^2`` with ``d`` >= the source-listener distance (the
    path through the wall is no shorter). ``S_e`` is the largest power of
    two that keeps that worst-case sum below 2^62, so no u64 bin
    overflows and ``S_e`` itself is exact. Each entry gets its own: a
    room whose listener sits near its source has a large NEE bound and a
    small ``S_e`` without coarsening the others. A directive entry's
    hits are weighted by at most ``pattern_gain`` (``[E]`` or a number,
    :func:`pattern_gain_bound`); omni and omni-coded patterns give 1 and
    the omni scale.

    The same scale serves every band. Each band has its own u64 bins, and
    band ``k``'s energy starts at the gain, as band 0's does, and is then
    multiplied only by what band 0's is (distances, the NEE geometry, the
    patterns) and by its own ``keep = 1 - absorption`` at each wall, which
    is at most 1 for an absorption in [0, 1] (every material's): so no
    band's hit can exceed the bound above, and a K-band IR has the
    one-band scale."""
    d2 = ((listeners.double() - sources.double()[:, None]) ** 2
          ).sum(-1).amin(-1).clamp(min=1e-12)
    e_max = gains.double() * torch.clamp(0.5 / d2, min=1.0)
    if not isinstance(pattern_gain, float):
        e_max = e_max * pattern_gain
    # clamped at 1 so a zero gain still gives a finite S (at most 2^62)
    bound = (float(n_frames * n_rays * 2 * max_bounces) * e_max).clamp(min=1.0)
    return torch.exp2(torch.floor(62.0 - torch.log2(bound)))


def fixed_point_scale(params: TraceParams, n_frames: int, n_rays: int,
                      max_bounces: int) -> torch.Tensor:
    """The single-scene kernel's (K3, K4) scale ``S``: a 0-d float64
    tensor, :func:`fixed_point_scales` of the one entry of ``params``."""
    src, mic = pattern_tables(params.directivity, params.mic_directivity, 1,
                              params.listeners.shape[0],
                              params.listeners.device)
    return fixed_point_scales(params.source[None], params.listeners[None],
                              params.input_gain.reshape(1), n_frames, n_rays,
                              max_bounces, pattern_gain_bound(src, mic))[0]


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _launch(host_uniforms, walls, listeners, scal, emit, u, key,
            entry_offset, n_frames, n_rays, max_bounces, sample_rate,
            ir_length, scales, work_counts, src=None, mic=None, n_bands=1,
            counter=None, frame_offset=0):
    """One launch over ``E = listeners.shape[0]`` entries: walls
    ``[E or 1, 10 + K, W]`` (:func:`pack_walls_banded`), listeners
    ``[E, L, 2]``, scal ``[E, 5]``, scales ``[E]`` float64, and for a
    directive launch the pattern tables ``src`` ``[E, C_s]`` and ``mic``
    ``[E, L, C_m]``, all on one CUDA device, in the lane groups of
    :func:`lane_group`. Listeners that do not fit one
    block's shared memory beside the walls (:func:`listener_block`) run in
    blocks, one call each; ``counter.launches`` counts the trace kernel's
    launches (more than one a call where the scratch takes the planes in
    chunks). In-kernel draws take Philox counter word 3 = ``entry_offset
    + e`` and word 1 = ``frame_offset + f`` (0 with host uniforms).
    Returns ``[E, L, T, K]``."""
    dev = walls.device
    n_e, n_l = listeners.shape[:2]
    for name, x in (("walls", walls), ("listeners", listeners),
                    ("scalars", scal)):
        _check_tensor(name, x, dev)
    if src is not None:
        _check_tensor("source patterns", src, dev, (n_e, src.shape[-1]))
        _check_tensor("microphone patterns", mic, dev,
                      (n_e, n_l, mic.shape[-1]))
    _check_tensor("scales", scales, dev, (n_e,), torch.float64)
    if work_counts is not None:
        _check_tensor("work_counts", work_counts, dev, (3,), torch.int64)
    n_walls = walls.shape[-1]
    n_src, n_mic = _pattern_sizes(src, mic)
    step = listener_block(n_walls, n_src, n_mic)
    if step < 1:
        raise ValueError("no listener fits a block beside the walls")
    lanes = lane_group(n_rays * n_frames * n_e, n_bands)
    scratch = None
    n_scratch = 0
    if band_bucket(n_bands) == 0:
        plane = -(-n_rays // 256) * 256 * n_bands
        n_scratch = max(plane, min(plane * n_e * n_frames, SCRATCH_FLOATS))
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = []
    for l0 in range(0, n_l, step):
        lis = listeners[:, l0:l0 + step].contiguous()
        mic_b = None if mic is None else mic[:, l0:l0 + step].contiguous()
        n_b = lis.shape[1]
        acc = torch.empty((n_e, n_b, ir_length, n_bands), dtype=torch.int64,
                          device=dev)
        out = torch.empty((n_e, n_b, ir_length, n_bands),
                          dtype=torch.float32, device=dev)
        launched = ctypes.c_int(0)
        err = fn(
            int(host_uniforms), walls.data_ptr(),
            0 if walls.shape[0] == 1 else (10 + n_bands) * n_walls, n_walls,
            n_bands, lis.data_ptr(), n_b, _ptr(src), n_src, _ptr(mic_b),
            n_mic, scal.data_ptr(), float(sample_rate),
            emit.data_ptr() if emit is not None else None,
            u.data_ptr() if u is not None else None, key[0], key[1],
            int(entry_offset) & 0xFFFFFFFF, int(frame_offset) & 0xFFFFFFFF,
            n_e, n_rays, max_bounces,
            n_frames, ir_length, lanes, _ptr(scratch), n_scratch,
            scales.data_ptr(), acc.data_ptr(), out.data_ptr(),
            work_counts.data_ptr() if work_counts is not None else None,
            ctypes.byref(launched), stream)
        if err != 0:
            raise RuntimeError(f"bounce kernel launch failed: cudaError {err}")
        if counter is not None:
            counter.launches += launched.value
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def pack_scalars(params: TraceParams) -> torch.Tensor:
    """The kernels' per-entry scalars ``[5]``: source x, source y, listener
    radius, speed of sound, input gain."""
    return torch.stack([params.source[0], params.source[1],
                        params.listener_radius, params.speed_of_sound,
                        params.input_gain]).to(torch.float32)


def k4_args_plain(scene: Scene, params: TraceParams, n_frames: int,
                  n_rays: int, max_bounces: int, tables=None):
    """Plain version of :func:`k4_args`: the wall table ``[1, 10 + K, W]``
    (:func:`pack_walls_banded`), the scalars ``[1, 5]``
    (:func:`pack_scalars`) and the scale ``[1]`` float64
    (:func:`fixed_point_scale`; with ``tables``, the ``(src, mic)`` of
    :func:`pattern_tables` for ``params``, its patterns' bound from
    them)."""
    if tables is None:
        scale = fixed_point_scale(params, n_frames, n_rays, max_bounces)
    else:
        scale = fixed_point_scales(
            params.source[None], params.listeners[None],
            params.input_gain.reshape(1), n_frames, n_rays, max_bounces,
            pattern_gain_bound(*tables))[0]
    return (pack_walls_banded(scene)[None], pack_scalars(params)[None],
            scale[None])


# the scene's fields k4_args_kernel reads, with their shapes ("W": walls,
# "K": bands)
_SCENE_FIELDS = (("a", ("W", 2)), ("b", ("W", 2)), ("normal", ("W", 2)),
                 ("absorption", ("W", "K")), ("scattering", ("W",)),
                 ("transmission", ("W",)), ("ior", ("W",)))
# the scalar inputs, in the order of f64_mask's bits
_SCALAR_FIELDS = (("source", (2,)), ("listener_radius", ()),
                  ("speed_of_sound", ()), ("input_gain", ()))


def k4_args_inputs(scene: Scene, params: TraceParams):
    """The inputs of one ``k4_args_kernel`` launch, checked before it:
    the scene's fields (float32 on its device, ``a`` ``[W, 2]`` of one
    scene and ``absorption`` ``[W, K]``, the rows 10 .. 9 + K of the
    table), the listeners ``[L, 2]`` float32 with L >= 1, and the scalar
    inputs (source ``[2]``, then radius, speed of sound and gain of one
    element each), each contiguous. A scalar input of another dtype is
    converted to float64 once (a float64 one is passed as it is) and its
    bit set in the returned mask: the kernel reads it in double for the
    scale and rounds it to float32 for the scalars, as the plain twin's
    ``.double()`` and ``stack(...).to(float32)`` see it. Raises
    ``ValueError`` on a wrong device, dtype or shape. Returns ``(scene
    fields, listeners, scalars, f64_mask)``."""
    dev = scene.device
    if scene.a.dim() != 2:
        raise ValueError(f"one scene's a [W, 2] expected, got "
                         f"{tuple(scene.a.shape)}: a stacked scene goes to "
                         "trace_rooms_ir_mega")
    sizes = {"W": scene.n_walls, "K": scene.n_bands}
    fields = []
    for name, dims in _SCENE_FIELDS:
        x = getattr(scene, name)
        _check_tensor(name, x, dev, tuple(sizes.get(d, d) for d in dims))
        fields.append(x.contiguous())
    if scene.n_bands < 1:
        raise ValueError("absorption must hold at least one band")
    lis = params.listeners
    if lis.dim() != 2 or lis.shape[0] < 1:
        raise ValueError(f"listeners must be [L, 2] with L >= 1, got "
                         f"{tuple(lis.shape)}")
    _check_tensor("listeners", lis, dev, (lis.shape[0], 2))
    mask = 0
    scalars = []
    for bit, (name, shape) in enumerate(_SCALAR_FIELDS):
        x = getattr(params, name)
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the scene on {dev}")
        if x.numel() != (shape[0] if shape else 1) \
                or (shape and tuple(x.shape) != shape):
            raise ValueError(f"{name} must have shape {shape} (or one "
                             f"element), got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            x = x.to(torch.float64)
            mask |= 1 << bit
        scalars.append(x.contiguous())
    return fields, lis.contiguous(), scalars, mask


_ARGS_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int, ctypes.c_int)
                  + (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_double)
                  + (ctypes.c_void_p,) * 4)


def _args_fn():
    fn = build.load_library().art_k4_args
    fn.argtypes = _ARGS_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def k4_args(scene: Scene, params: TraceParams, n_frames: int, n_rays: int,
            max_bounces: int, tables=None):
    """The arguments of a single-scene K3/K4/K6 launch in ONE launch of
    ``k4_args_kernel`` (``csrc/k4_args_kernel.cu``), on the current stream
    with no host sync: the wall table ``[1, 10 + K, W]`` float32, the
    scalars ``[1, 5]`` float32 and the fixed-point scale ``[1]`` float64,
    equal to :func:`k4_args_plain` bit for bit. ``tables``: the ``(src,
    mic)`` of :func:`pattern_tables` for ``params``, if the caller has
    them (computed otherwise); a directive trace's gain bound
    (:func:`pattern_gain_bound`) reaches the kernel by pointer. Counts its
    launches in ``.launches``. A CPU scene runs :func:`k4_args_plain`."""
    if scene.device.type != "cuda":
        return k4_args_plain(scene, params, n_frames, n_rays, max_bounces,
                             tables)
    dev = scene.device
    fields, lis, scalars, mask = k4_args_inputs(scene, params)
    if tables is None:
        tables = pattern_tables(params.directivity, params.mic_directivity,
                                1, lis.shape[0], dev)
    bound = pattern_gain_bound(*tables)      # 1.0 for omni: no pointer
    if not isinstance(bound, torch.Tensor):
        bound = None
    else:
        _check_tensor("pattern gain bound", bound, dev, (1,), torch.float64)
        bound = bound.contiguous()
    n_walls, n_bands = scene.n_walls, scene.n_bands
    walls = torch.empty((1, 10 + n_bands, n_walls), dtype=torch.float32,
                        device=dev)
    scal = torch.empty((1, 5), dtype=torch.float32, device=dev)
    scale = torch.empty((1,), dtype=torch.float64, device=dev)
    err = _args_fn()(
        *(x.data_ptr() for x in fields), n_walls, n_bands,
        *(x.data_ptr() for x in scalars), mask, lis.data_ptr(),
        lis.shape[0], _ptr(bound),
        float(n_frames * n_rays * 2 * max_bounces), walls.data_ptr(),
        scal.data_ptr(), scale.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"argument kernel launch failed: cudaError {err}")
    k4_args.launches += 1
    return walls, scal, scale


def _launch_scene(host_uniforms, scene, params, emit, u, key, n_frames,
                  n_rays, max_bounces, sample_rate, ir_length, work_counts,
                  counter, entry=0, frame_offset=0):
    """K3/K4: one scene, one entry (its Philox entry id ``entry``). The
    arguments' preparation, everything before :func:`_launch`, is the span
    ``art.k4.prep`` (K3's and K6's launches share it): the checks and one
    launch of :func:`k4_args`."""
    with span("k4.prep"):
        src, mic = check_kernel_supported(scene, params)
        walls, scal, scales = k4_args(scene, params, n_frames, n_rays,
                                      max_bounces, (src, mic))
        listeners = params.listeners.contiguous()[None]
    return _launch(host_uniforms, walls, listeners, scal, emit, u,
                   key, entry, n_frames, n_rays, max_bounces, sample_rate,
                   ir_length, scales, work_counts, src, mic,
                   scene.n_bands, counter, frame_offset)[0]


def trace_frames_ir_plain(scene: Scene, params: TraceParams,
                          emit: torch.Tensor, u: torch.Tensor, *,
                          sample_rate: int, ir_length: int) -> torch.Tensor:
    """Plain PyTorch version: the oracle trace + scatter of every frame
    (``emit[F, R]``, ``u[F, B, R, 3]``), summed over frames.
    Returns ``[L, T, K]``."""
    ir = torch.zeros((params.listeners.shape[0], ir_length, scene.n_bands),
                     dtype=torch.float32, device=scene.device)
    for f in range(emit.shape[0]):
        hits = trace_hits_only(scene, params, emit[f], u[f])
        ir = ir + scatter_hits(hits, sample_rate, ir_length)
    return ir


def trace_frames_ir_mega_plain(scene: Scene, params: TraceParams, seed: int,
                               n_frames: int, *, n_rays: int,
                               max_bounces: int, sample_rate: int,
                               ir_length: int, entry: int = 0,
                               frame_offset: int = 0) -> torch.Tensor:
    """Plain version of K4: :func:`trace_frames_ir_plain` on the Philox
    numbers the kernel draws for ``seed``, ``entry`` and ``frame_offset``
    (:func:`..rng.philox_uniforms`)."""
    emit, u = rng.philox_uniforms(seed, n_frames, max_bounces, n_rays,
                                  scene.device, entry=entry,
                                  first_frame=frame_offset)
    return trace_frames_ir_plain(scene, params, emit, u,
                                 sample_rate=sample_rate, ir_length=ir_length)


def trace_frames_ir_whole(scene: Scene, params: TraceParams,
                          emit: torch.Tensor, u: torch.Tensor, *,
                          sample_rate: int, ir_length: int,
                          work_counts: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """K3: ``F`` frames with host uniforms ``emit[F, R]``, ``u[F, B, R, 3]``
    -> frame-summed IR ``[L, T, K]``. CUDA scenes launch the kernel; CPU
    scenes run :func:`trace_frames_ir_plain`."""
    if scene.device.type != "cuda":
        return trace_frames_ir_plain(scene, params, emit, u,
                                     sample_rate=sample_rate,
                                     ir_length=ir_length)
    n_frames, n_rays = emit.shape
    max_bounces = u.shape[1]
    _check_tensor("emit", emit, scene.device, (n_frames, n_rays))
    _check_tensor("u", u, scene.device, (n_frames, max_bounces, n_rays, 3))
    return _launch_scene(True, scene, params, emit.contiguous(),
                         u.contiguous(), (0, 0), n_frames, n_rays,
                         max_bounces, sample_rate, ir_length, work_counts,
                         trace_frames_ir_whole)


def trace_frames_ir_mega(scene: Scene, params: TraceParams, seed: int,
                         n_frames: int, *, n_rays: int, max_bounces: int,
                         sample_rate: int, ir_length: int,
                         entry: int = 0, frame_offset: int = 0,
                         work_counts: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """K4: ``n_frames`` frames in one launch, uniforms drawn in the kernel
    (Philox-4x32-10 under the key of ``seed``) -> frame-summed IR
    ``[L, T, K]``. CPU scenes run :func:`trace_frames_ir_mega_plain`.

    ``entry`` (Philox counter word 3, the shard of a ray-sharded trace)
    and ``frame_offset`` (the first frame's counter word 1, the shard of a
    frame-sharded run) name the stream; both 0 by default, which gives the
    bits of the launch without them.

    ``work_counts`` (K3, K4 and K9 alike): an int64 CUDA tensor ``[3]`` to
    which the launch adds the wall tests it really made, the wall sweeps
    (nearest or occlusion) they belong to and its slab tests (none here;
    the cluster kernels make them), for a bound computed from the run's
    data (``chip_smoke.py``)."""
    if scene.device.type != "cuda":
        return trace_frames_ir_mega_plain(
            scene, params, seed, n_frames, n_rays=n_rays,
            max_bounces=max_bounces, sample_rate=sample_rate,
            ir_length=ir_length, entry=entry, frame_offset=frame_offset)
    return _launch_scene(False, scene, params, None, None,
                         rng.seed_key(seed), n_frames, n_rays, max_bounces,
                         sample_rate, ir_length, work_counts,
                         trace_frames_ir_mega, entry, frame_offset)


def _batch_inputs(scenes: Scene, sources, listeners, listener_radius,
                  speed_of_sound, input_gain):
    """The batch's per-entry inputs as float32 tensors on the scenes'
    device: sources ``[E, 2]``, listeners ``[E, L, 2]`` and radius, speed
    of sound and gain ``[E]`` (each a scalar or ``[E]``)."""
    dev = scenes.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    src = f32(sources)
    lis = f32(listeners)
    if lis.dim() == 2:
        lis = lis[:, None]
    n_e = src.shape[0]
    if src.shape != (n_e, 2) or lis.dim() != 3 or lis.shape[0] != n_e \
            or lis.shape[-1] != 2:
        raise ValueError(f"sources must be [E, 2] and listeners [E, 2] or "
                         f"[E, L, 2]; got {tuple(src.shape)} and "
                         f"{tuple(lis.shape)}")
    if scenes.a.dim() != 3 or scenes.a.shape[0] not in (1, n_e):
        raise ValueError(f"scenes must be stacked with a leading dim of "
                         f"{n_e} (or 1 for a shared scene); got a of shape "
                         f"{tuple(scenes.a.shape)}")
    per_entry = [torch.broadcast_to(f32(x), (n_e,))
                 for x in (listener_radius, speed_of_sound, input_gain)]
    return (src, lis, *per_entry)


def batch_params(src, lis, radius, c, gain, directivity, mic_directivity,
                 device) -> list:
    """The :class:`..trace.TraceParams` of each entry of a batch (the
    per-entry inputs of :func:`_batch_inputs` and the patterns broadcast
    by :func:`pattern_tables`)."""
    d_tab, m_tab = pattern_tables(directivity, mic_directivity,
                                  src.shape[0], lis.shape[1], device)
    return [TraceParams(
        source=src[e], listeners=lis[e], listener_radius=radius[e],
        speed_of_sound=c[e], input_gain=gain[e],
        directivity=None if directivity is None else d_tab[e],
        mic_directivity=None if mic_directivity is None else m_tab[e])
        for e in range(src.shape[0])]


def trace_rooms_ir_mega_plain(scenes: Scene, sources, listeners, seed: int,
                              n_frames: int, *, n_rays: int,
                              max_bounces: int, sample_rate: int,
                              ir_length: int, listener_radius=0.5,
                              speed_of_sound=343.0, input_gain=1.0,
                              entry_offset: int = 0,
                              uniforms=None, directivity=None,
                              mic_directivity=None) -> torch.Tensor:
    """Plain version of K9: :func:`trace_frames_ir_plain` for each entry
    ``e`` on the Philox numbers the kernel draws for it
    (``philox_uniforms(seed, ..., entry=entry_offset + e)``), or on host
    uniforms ``uniforms = (emit[E, F, R], u[E, F, B, R, 3])`` (the JAX
    parity tests pass JAX's), with entry ``e``'s patterns (see
    :func:`trace_rooms_ir_mega`). Returns the frame-summed
    ``[E, L, T, K]``."""
    src, lis, radius, c, gain = _batch_inputs(
        scenes, sources, listeners, listener_radius, speed_of_sound,
        input_gain)
    n_e = src.shape[0]
    if uniforms is not None:
        emit, u = uniforms
        want = ((n_e, n_frames, n_rays), (n_e, n_frames, max_bounces, n_rays,
                                          3))
        if (tuple(emit.shape), tuple(u.shape)) != want:
            raise ValueError(f"uniforms must be emit{list(want[0])} and "
                             f"u{list(want[1])}; got {tuple(emit.shape)} and "
                             f"{tuple(u.shape)}")
    shared = scenes.a.shape[0] == 1
    entries = batch_params(src, lis, radius, c, gain, directivity,
                           mic_directivity, scenes.device)
    irs = []
    for e, params in enumerate(entries):
        if uniforms is None:
            emit_e, u_e = rng.philox_uniforms(
                seed, n_frames, max_bounces, n_rays, scenes.device,
                entry=entry_offset + e)
        else:
            emit_e, u_e = uniforms[0][e], uniforms[1][e]
        irs.append(trace_frames_ir_plain(
            scenes.row(0 if shared else e), params, emit_e, u_e,
            sample_rate=sample_rate, ir_length=ir_length))
    return torch.stack(irs)


def trace_rooms_ir_mega(scenes: Scene, sources, listeners, seed: int,
                        n_frames: int, *, n_rays: int, max_bounces: int,
                        sample_rate: int, ir_length: int,
                        listener_radius=0.5, speed_of_sound=343.0,
                        input_gain=1.0, entry_offset: int = 0,
                        uniforms=None, directivity=None,
                        mic_directivity=None,
                        work_counts: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K9: ``E`` batch entries x ``n_frames`` frames in ONE launch, uniforms
    drawn in the kernel -> frame-SUMMED IRs ``[E, L, T, K]`` (the contract
    of the JAX ``trace_rooms_ir_mega``); listeners past what one block's
    shared memory takes run in blocks, one launch each.

    ``scenes`` is stacked with a leading dim of ``E`` (a room dataset) or
    1 (one scene every entry shares: a multi-source batch, whose wall
    table the kernel reads with stride 0). ``sources`` ``[E, 2]``,
    ``listeners`` ``[E, 2]`` or ``[E, L, 2]``; ``listener_radius``,
    ``speed_of_sound`` and ``input_gain`` a scalar or ``[E]``. Entry ``e``
    draws Philox counter word 3 = ``entry_offset + e``, its global id, so
    a batch cut into pieces draws the same rays as the whole.
    ``directivity`` (``[C]`` shared or ``[E, C]`` per entry: each source
    of a mixdown can carry its own aim) and ``mic_directivity`` (``[C]``,
    ``[L, C]`` or ``[E, L, C]``) go to the kernel as per-entry tables; a
    block reads its own entry's rows. CPU scenes run
    :func:`trace_rooms_ir_mega_plain`, which alone takes host
    ``uniforms``; the kernel draws its own numbers and refuses them."""
    kw = dict(n_rays=n_rays, max_bounces=max_bounces,
              sample_rate=sample_rate, ir_length=ir_length,
              listener_radius=listener_radius,
              speed_of_sound=speed_of_sound, input_gain=input_gain,
              entry_offset=entry_offset, directivity=directivity,
              mic_directivity=mic_directivity)
    if scenes.device.type != "cuda":
        return trace_rooms_ir_mega_plain(scenes, sources, listeners, seed,
                                         n_frames, uniforms=uniforms, **kw)
    if uniforms is not None:
        raise ValueError("the kernel draws its own numbers: uniforms= "
                         "needs backend='plain'")
    src, lis, radius, c, gain = _batch_inputs(
        scenes, sources, listeners, listener_radius, speed_of_sound,
        input_gain)
    d_tab, m_tab = pattern_tables(directivity, mic_directivity,
                                  src.shape[0], lis.shape[1], scenes.device)
    check_batch_supported(scenes, d_tab, m_tab)
    if src.shape[0] > MAX_ENTRIES:
        raise ValueError(f"{src.shape[0]} entries exceed the grid's "
                         f"{MAX_ENTRIES}; split the batch (entry_offset "
                         "keeps the streams)")
    scal = torch.stack([src[:, 0], src[:, 1], radius, c, gain], dim=-1)
    scales = fixed_point_scales(src, lis, gain, n_frames, n_rays, max_bounces,
                                pattern_gain_bound(d_tab, m_tab))
    return _launch(False, pack_walls_banded(scenes), lis.contiguous(),
                   scal.contiguous(), None, None, rng.seed_key(seed),
                   entry_offset, n_frames, n_rays, max_bounces, sample_rate,
                   ir_length, scales, work_counts, d_tab, m_tab,
                   scenes.n_bands, trace_rooms_ir_mega)


# --- one frame: K5 (hit rows) and K6 (K3/K4 at one frame) --------------------

# hit-row indices of the [B, 8, R] rows (rows 6 and 7 are zero padding)
HD_DELAY, HD_EN, HD_VAL, HN_DELAY, HN_EN, HN_VAL = range(6)
HIT_ROWS = 8
# K6 takes at most 16 listeners (the JAX kernel 4), one band
MAX_FUSED_LISTENERS = 16

_ROWS_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def _rows_fn():
    fn = build.load_library().art_trace_frame_rows
    fn.argtypes = _ROWS_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_uniforms(scene, emit, u):
    """Host uniforms of one frame: ``emit[R]``, ``u[B, R, 3]`` float32 on
    the scene's device. Returns ``(R, B)``."""
    if emit.dim() != 1 or u.dim() != 3:
        raise ValueError(f"uniforms must be emit[R] and u[B, R, 3]; got "
                         f"{tuple(emit.shape)} and {tuple(u.shape)}")
    n_rays, max_bounces = emit.shape[0], u.shape[0]
    _check_tensor("emit", emit, scene.device, (n_rays,))
    _check_tensor("u", u, scene.device, (max_bounces, n_rays, 3))
    return n_rays, max_bounces


def _check_fused_supported(scene: Scene, params: TraceParams) -> None:
    """K6 and :func:`trace_accumulate_fused` take one band, as the JAX
    ``trace_frame_ir_fused`` does, and at most :data:`MAX_FUSED_LISTENERS`
    listeners, on any device; K3/K4 take any band and listener count."""
    n_l = params.listeners.shape[0]
    if scene.n_bands != 1 or n_l > MAX_FUSED_LISTENERS:
        raise ValueError(
            f"trace_frame_ir_fused takes one band and at most "
            f"{MAX_FUSED_LISTENERS} listeners, got {scene.n_bands} bands and "
            f"{n_l} listeners; trace_frames_ir_whole / trace_frames_ir_mega "
            "take any")


def _check_rows_supported(scene: Scene, params: TraceParams) -> None:
    """K5 takes one listener and one band (the JAX ``trace_fused_rows``
    contract) on a scene the whole-table kernels take."""
    if params.listeners.shape[0] != 1:
        raise ValueError(
            f"trace_fused takes exactly one listener, got "
            f"{params.listeners.shape[0]}; trace(use_kernels=True) traces "
            "hits for any listener count (engine.trace_hits routes there)")
    if scene.n_bands != 1:
        raise ValueError(
            f"trace_fused takes n_bands == 1, got {scene.n_bands}; "
            "trace(use_kernels=True) traces hits for any band count")
    check_kernel_supported(scene, params)


def _bounce_records(scene: Scene, params: TraceParams, emit: torch.Tensor,
                    u: torch.Tensor):
    """The plain trace one bounce at a time on an explicit state: yields
    each bounce's ``(delay[2, R, L], energy[2, R, L, K], valid[2, R, L])``."""
    _check_trace_supported(params)
    n_rays = emit.shape[0]
    if u.shape[1:] != (n_rays, 3):
        raise ValueError(f"u must be [B, {n_rays}, 3], got {tuple(u.shape)}")
    st = _emit(params, n_rays, scene.n_bands, emit)
    for b in range(u.shape[0]):
        st, (delay, energy, valid, _, _) = _bounce(scene, params, st, u[b])
        yield delay, energy, valid


def trace_fused_rows_plain(scene: Scene, params: TraceParams,
                           emit: torch.Tensor, u: torch.Tensor
                           ) -> torch.Tensor:
    """Plain version of K5: the hit rows ``[B, 8, R]`` of one frame from
    ``ops/trace.py::_bounce``, one bounce at a time. As in the kernel, the
    delay and energy of a hit that did not happen are zeros."""
    if params.listeners.shape[0] != 1 or scene.n_bands != 1:
        raise ValueError("hit rows hold one listener and one band")
    rows = []
    for delay, energy, valid in _bounce_records(scene, params, emit, u):
        d, e, v = delay[..., 0], energy[..., 0, 0], valid[..., 0]  # [2, R]
        zero = torch.zeros_like(d[0])
        rows.append(torch.stack([
            torch.where(v[0], d[0], zero), torch.where(v[0], e[0], zero),
            v[0].to(d.dtype),
            torch.where(v[1], d[1], zero), torch.where(v[1], e[1], zero),
            v[1].to(d.dtype), zero, zero]))
    return torch.stack(rows)


def trace_fused_rows(scene: Scene, params: TraceParams, emit: torch.Tensor,
                     u: torch.Tensor, *,
                     work_counts: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """K5: one frame with host uniforms ``emit[R]``, ``u[B, R, 3]`` -> raw
    hit rows ``[B, 8, R]`` float32 (rows: direct delay/energy/valid, NEE
    delay/energy/valid, two of padding), the form
    :func:`scatter_hits_rows` consumes: all B bounces in one launch of the
    bounce loop K3 runs, in its lane groups (:func:`lane_group`), with the
    hits stored as rows. The rows of a hit that did not happen, and of
    every bounce after a ray dies, are zeros. One listener, one band.
    ``work_counts`` as for :func:`trace_frames_ir_mega`: K3's counts on the
    same uniforms. CPU scenes run :func:`trace_fused_rows_plain`."""
    if scene.device.type != "cuda":
        return trace_fused_rows_plain(scene, params, emit, u)
    _check_rows_supported(scene, params)
    n_rays, max_bounces = _check_uniforms(scene, emit, u)
    dev = scene.device
    walls = pack_walls(scene)
    lis = params.listeners.contiguous()
    scal = pack_scalars(params)
    for name, x in (("walls", walls), ("listeners", lis), ("scalars", scal)):
        _check_tensor(name, x, dev)
    src, mic = pattern_tables(params.directivity, params.mic_directivity, 1,
                              1, dev)
    n_src, n_mic = _pattern_sizes(src, mic)
    if work_counts is not None:
        _check_tensor("work_counts", work_counts, dev, (3,), torch.int64)
    emit, u = emit.contiguous(), u.contiguous()
    rows = torch.empty((max_bounces, HIT_ROWS, n_rays), dtype=torch.float32,
                       device=dev)
    err = _rows_fn()(
        walls.data_ptr(), walls.shape[-1], lis.data_ptr(), _ptr(src), n_src,
        _ptr(mic), n_mic, scal.data_ptr(), emit.data_ptr(), u.data_ptr(),
        n_rays, max_bounces, lane_group(n_rays, 1), rows.data_ptr(),
        _ptr(work_counts), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hit-row kernel launch failed: cudaError {err}")
    trace_fused_rows.launches += 1
    return rows


def scatter_hits_rows(hits_rows: torch.Tensor, sample_rate: int,
                      ir_length: int) -> torch.Tensor:
    """Deposit raw hit rows ``[B, 8, R]`` into IR bins ``[1, T, 1]`` (the
    contract of ``..ir.scatter_hits`` for L = K = 1) without any layout
    change of the row tensors: all direct rows, then all NEE rows, as the
    JAX function orders them."""
    delay = torch.cat([hits_rows[:, HD_DELAY], hits_rows[:, HN_DELAY]]
                      ).reshape(-1)
    energy = torch.cat([hits_rows[:, HD_EN], hits_rows[:, HN_EN]]
                       ).reshape(-1)
    valid = torch.cat([hits_rows[:, HD_VAL], hits_rows[:, HN_VAL]]
                      ).reshape(-1)
    bins = torch.floor(delay * sample_rate).to(torch.int32)
    ok = (valid > 0.5) & (bins >= 0) & (bins < ir_length)
    bins = torch.where(ok, bins, ir_length).long()
    ir = add_rows(ir_length + 1, bins, energy * ok.to(energy.dtype), ok)
    return ir[:ir_length][None, :, None]


def hits_from_rows(hits_rows: torch.Tensor) -> Hits:
    """Hit rows ``[B, 8, R]`` as :class:`..trace.Hits` ``[B, 2, R, 1]``
    (energy ``[B, 2, R, 1, 1]``)."""
    delay = torch.stack([hits_rows[:, HD_DELAY], hits_rows[:, HN_DELAY]],
                        dim=1)[..., None]
    energy = torch.stack([hits_rows[:, HD_EN], hits_rows[:, HN_EN]],
                         dim=1)[..., None, None]
    valid = torch.stack([hits_rows[:, HD_VAL], hits_rows[:, HN_VAL]],
                        dim=1)[..., None] > 0.5
    return Hits(delay=delay, energy=energy, valid=valid)


def trace_fused(scene: Scene, params: TraceParams, emit: torch.Tensor,
                u: torch.Tensor) -> Hits:
    """K5 as the standard :class:`..trace.Hits` layout ``[B, 2, R, 1]``:
    the interop wrapper around :func:`trace_fused_rows`."""
    return hits_from_rows(trace_fused_rows(scene, params, emit, u))


def trace_frame_ir_fused_plain(scene: Scene, params: TraceParams,
                               emit: torch.Tensor, u: torch.Tensor, *,
                               sample_rate: int, ir_length: int
                               ) -> torch.Tensor:
    """Plain version of K6: one frame's bounces one at a time on an
    explicit state, their hits binned by ``..ir.scatter_hits`` in the
    order the whole-frame plain version bins them, so it equals
    :func:`trace_frames_ir_plain` of that frame bit for bit. Returns
    ``[L, T, K]``."""
    records = list(_bounce_records(scene, params, emit, u))
    hits = Hits(*(torch.stack(x) for x in zip(*records)))
    ir = torch.zeros((params.listeners.shape[0], ir_length, scene.n_bands),
                     dtype=torch.float32, device=scene.device)
    return ir + scatter_hits(hits, sample_rate, ir_length)


def trace_frame_ir_fused(scene: Scene, params: TraceParams,
                         emit: Optional[torch.Tensor] = None,
                         u: Optional[torch.Tensor] = None, *,
                         seed: Optional[int] = None,
                         n_rays: Optional[int] = None,
                         max_bounces: Optional[int] = None,
                         sample_rate: int, ir_length: int,
                         work_counts: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """K6: ONE frame -> IR ``[L, T, 1]`` binned in the kernel (hits never
    reach device memory as records). Either host uniforms ``emit[R]``,
    ``u[B, R, 3]`` or, the counterpart of the JAX function's
    ``in_kernel_rng``, a ``seed`` with ``n_rays`` and ``max_bounces``: the
    kernel then draws frame 0 of that seed's Philox stream. It is K3's
    launch at one frame (K4's with a seed), counted here: the IR equals
    :func:`trace_frames_ir_whole` of the same one frame bit for bit, and
    with a seed ``trace_frames_ir_mega(seed, 1)``. One band and at most
    :data:`MAX_FUSED_LISTENERS` listeners, as the JAX contract (4
    listeners there), on any device. CPU scenes run
    :func:`trace_frame_ir_fused_plain` (on the seed's Philox numbers)."""
    if (seed is None) == (emit is None and u is None):
        raise ValueError("give either host uniforms (emit, u) or a seed")
    if seed is not None and (n_rays is None or max_bounces is None):
        raise ValueError("a seed needs n_rays and max_bounces")
    _check_fused_supported(scene, params)
    if scene.device.type != "cuda":
        if seed is not None:
            emit, u = rng.philox_uniforms(seed, 1, max_bounces, n_rays,
                                          scene.device)
            emit, u = emit[0], u[0]
        return trace_frame_ir_fused_plain(scene, params, emit, u,
                                          sample_rate=sample_rate,
                                          ir_length=ir_length)
    if seed is None:
        n_rays, max_bounces = _check_uniforms(scene, emit, u)
        return _launch_scene(True, scene, params, emit.contiguous()[None],
                             u.contiguous()[None], (0, 0), 1, n_rays,
                             max_bounces, sample_rate, ir_length,
                             work_counts, trace_frame_ir_fused)
    return _launch_scene(False, scene, params, None, None,
                         rng.seed_key(seed), 1, n_rays, max_bounces,
                         sample_rate, ir_length, work_counts,
                         trace_frame_ir_fused)


def trace_accumulate_fused(scene: Scene, params: TraceParams, state: IRState,
                           emit: torch.Tensor, u: torch.Tensor, *,
                           sample_rate: int, exact_scatter: bool = False
                           ) -> IRState:
    """Fused-kernel counterpart of ``engine.trace_accumulate`` for host
    uniforms ``emit[F, R]``, ``u[F, B, R, 3]``: each frame through K6
    (:func:`trace_frame_ir_fused`), or, with ``exact_scatter``, a K5 pass
    per listener (the ray paths do not depend on the listener) whose rows
    :func:`scatter_hits_rows` bins in float32, the route of the JAX
    ``trace_accumulate_fused(exact_scatter=True)``. K6's contract on either
    route: one band, at most :data:`MAX_FUSED_LISTENERS` listeners."""
    _check_fused_supported(scene, params)
    ir_length = state.ir_length
    total = state.sum
    for f in range(emit.shape[0]):
        if exact_scatter:
            irs = []
            mic = params.mic_directivity
            for l0 in range(params.listeners.shape[0]):
                p1 = params._replace(
                    listeners=params.listeners[l0:l0 + 1],
                    mic_directivity=(mic[l0:l0 + 1] if mic is not None
                                     and mic.dim() == 2 else mic))
                irs.append(scatter_hits_rows(
                    trace_fused_rows(scene, p1, emit[f], u[f]), sample_rate,
                    ir_length))
            ir = torch.cat(irs)
        else:
            ir = trace_frame_ir_fused(scene, params, emit[f], u[f],
                                      sample_rate=sample_rate,
                                      ir_length=ir_length)
        total = total + ir
    return IRState(sum=total, frames=state.frames + emit.shape[0])


k4_args.launches = 0
trace_frames_ir_whole.launches = 0
trace_frames_ir_mega.launches = 0
trace_rooms_ir_mega.launches = 0
trace_fused_rows.launches = 0
trace_frame_ir_fused.launches = 0
