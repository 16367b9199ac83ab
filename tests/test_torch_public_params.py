"""PyTorch port: every parameter of every public JAX function and class has
a counterpart.

The walk is ``test_torch_public_names.py``'s (its modules, ``RENAMED`` and
``TPU_ONLY``). For each public function, each class (its constructor) and
each public method of a class, every parameter of the JAX signature
(``inspect.signature``) must be one of:

* a parameter of the same name in the port's counterpart;
* a rename: ``RENAMED_PARAMS`` for one function, or ``RENAMED_ANYWHERE``
  where the port renamed it throughout (``key`` -> ``seed``); the port
  parameters named must exist;
* a ``TPU_ONLY_PARAMS`` reason: a Pallas tile knob, a VMEM budget, the TPU
  core PRNG switch, or ``bin_offset`` (recorded: the port's IR lives in
  global memory at any length, so a window of it is a slice, which
  ``test_bin_offset_window_is_a_slice_of_the_port_ir`` shows against
  JAX's kernel in interpret mode).

Where the port takes ``**kw`` (``streaming.stream_chunk``), the JAX
parameters it lacks by name are resolved against the function the
keywords are forwarded to (``FORWARDS``), and the port's source is checked
to forward them there. Exception classes, which take the builtin
constructor's ``*args`` on both sides, are held to being exceptions.

The one parameter that the audit found neither renamed nor TPU-only,
``ops.rng.bounce_uniforms(n_listeners=)``, is ported (the draws do not
depend on it, as in JAX): ``test_bounce_uniforms_take_n_listeners_as_jax``.
"""

import ast
import importlib
import inspect
import textwrap

import jax
import numpy as np
import pytest
import torch
from test_torch_public_names import (JAX_ROOT, PORT_ROOT, RENAMED, TPU_ONLY,
                                     jax_modules, port_path, top_level_names)
from torch_parity import CPU, to_numpy, to_torch

# JAX parameter -> the port's, in every function where the port has it
RENAMED_ANYWHERE = {
    "key": ("seed",),          # a PRNG key -> an integer seed (Philox)
    "starts_key": ("starts_seed",),
    "dry": ("dry_chunk",),
    "use_pallas": ("use_kernels",),
    "seed_offset": ("entry_offset",),   # the entry id of a batch
    "walls_packed": ("walls",),         # the port's own packing
}
# A JAX key and the shapes it is drawn at -> the draws themselves: these
# port functions take the uniforms ``(emit[F, R], u[F, B, R, 3])`` JAX
# draws from ``key`` (rng.philox_uniforms or rng.bounce_uniforms make
# them), whose shapes carry n_rays, max_bounces and n_frames.
_DRAWS = {"key": ("emit", "u"), "n_rays": ("emit",),
          "max_bounces": ("u",)}
# (JAX module, qualified name) -> {JAX parameter: port parameters}
RENAMED_PARAMS = {
    ("ops.trace", "trace"): _DRAWS,
    ("ops.trace", "trace_hits_only"): _DRAWS,
    ("ops.pallas.bounce_kernel", "trace_frame_ir_whole"): _DRAWS,
    ("ops.pallas.bounce_kernel", "trace_fused_rows"): _DRAWS,
    ("ops.pallas.bounce_kernel", "trace_fused"): _DRAWS,
    ("ops.pallas.bounce_kernel", "trace_accumulate_fused"):
        dict(_DRAWS, n_frames=("emit", "u")),
    # the wall endpoints -> the scene that holds them
    ("ops.pallas.trace_kernel", "pack_walls"): {"a": ("scene",),
                                                "b": ("scene",)},
    # a JAX key -> a torch Generator
    ("ops.rng", "bounce_uniforms"): {"key": ("generator",)},
}
_TILE = "a Pallas tile width (the CUDA kernels size their own blocks)"
_VMEM = ("a VMEM budget of the TPU kernel (ROADMAP, 'Not to port'); the "
         "CUDA listener blocks are sized from shared memory")
_RNG = ("the TPU core PRNG switch; the port splits the two draws into two "
        "entry points: K3 (host uniforms, trace_frames_ir_whole) and K4 "
        "(in-kernel Philox, trace_frames_ir_mega)")
_CLUSTER = ("the TPU cluster width; the port sizes its clusters for the "
            "H100 (ops/accel.py::accel_cluster_size)")
_BIN_OFFSET = ("a VMEM time window's first bin (its callers are the "
               "windows, ROADMAP 'Not to port'); the port's IR lives in "
               "global memory at any length, so a window is a slice of it")
# (JAX module, qualified name or None for any function, parameter) -> why
# the port has none
TPU_ONLY_PARAMS = {
    ("ops.pallas.bounce_kernel", None, "tile_r"): _TILE,
    ("ops.pallas.trace_kernel", None, "tile_r"): _TILE,
    ("ops.pallas.bounce_kernel", None, "in_kernel_rng"): _RNG,
    ("ops.pallas.bounce_kernel", None, "cluster_size"): _CLUSTER,
    ("ops.pallas.bounce_kernel", None, "bin_offset"): _BIN_OFFSET,
    ("ops.pallas.bounce_kernel", "listener_block", "n_bands"): _VMEM,
    ("ops.pallas.bounce_kernel", "listener_block", "ir_length"): _VMEM,
}
# (JAX module, qualified name) -> (port module, function) that the port's
# **kw are forwarded to
FORWARDS = {
    ("streaming", "stream_chunk"): ("streaming", "wet_chunk"),
}


def _port_module(rel, name):
    where, as_ = RENAMED.get((rel, name), (port_path(rel), name))
    return importlib.import_module(f"{PORT_ROOT}.{where}"), as_


def public_callables():
    """(JAX module, qualified name, JAX object, port object) of every
    public function and class of the JAX package and of every public
    method defined in such a class."""
    out = []
    for rel in jax_modules():
        if (rel, None) in TPU_ONLY:
            continue
        jm = importlib.import_module(f"{JAX_ROOT}.{rel}")
        for name in top_level_names(jm):
            obj = getattr(jm, name)
            if (rel, name) in TPU_ONLY or not callable(obj):
                continue
            pm, as_ = _port_module(rel, name)
            port = getattr(pm, as_)
            out.append((rel, name, obj, port))
            if not inspect.isclass(obj):
                continue
            for attr, member in vars(obj).items():
                if attr.startswith("_"):
                    continue
                fn = getattr(member, "__func__", member)
                if inspect.isfunction(fn):
                    out.append((rel, f"{name}.{attr}", fn,
                                getattr(port, attr, None)))
    return out


CALLABLES = public_callables()


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _forwards_kw(port_fn, target_name):
    """Whether ``port_fn``'s body calls ``target_name`` with its ``**kw``."""
    varkw = next(p.name for p in inspect.signature(port_fn).parameters
                 .values() if p.kind == p.VAR_KEYWORD)
    tree = ast.parse(textwrap.dedent(inspect.getsource(port_fn)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) \
                == target_name:
            if any(k.arg is None and getattr(k.value, "id", None) == varkw
                   for k in node.keywords):
                return True
    return False


def unmatched(rel, qual, jax_obj, port_obj):
    """The JAX parameters of ``rel.qual`` that the port matches by none of
    the three means, and the exceptions it used."""
    used = set()
    if port_obj is None:
        return ["<no port counterpart>"], used
    js, ps = _signature(jax_obj), _signature(port_obj)
    if js is None or ps is None:
        both_exc = all(inspect.isclass(o) and issubclass(o, BaseException)
                       for o in (jax_obj, port_obj))
        return ([] if both_exc and js is None and ps is None
                else ["<signature>"]), used
    have = set(ps.parameters)
    kinds = {p.kind for p in ps.parameters.values()}
    if inspect.Parameter.VAR_KEYWORD in kinds and (rel, qual) in FORWARDS:
        frel, fname = FORWARDS[rel, qual]
        target = getattr(importlib.import_module(f"{PORT_ROOT}.{frel}"),
                         fname)
        if _forwards_kw(port_obj, fname):
            have |= set(inspect.signature(target).parameters)
            used.add(("forward", rel, qual))
    missing = []
    for name, p in js.parameters.items():
        if name in ("self", "cls") or name in have:
            continue
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and p.kind in kinds:
            continue
        renamed = RENAMED_PARAMS.get((rel, qual), {}).get(name)
        if renamed is not None and set(renamed) <= have:
            used.add(("renamed", rel, qual, name))
            continue
        renamed = RENAMED_ANYWHERE.get(name)
        if renamed is not None and set(renamed) <= have:
            used.add(("anywhere", name))
            continue
        key = next((k for k in ((rel, qual, name), (rel, None, name))
                    if k in TPU_ONLY_PARAMS), None)
        if key is not None and name not in have:
            used.add(("tpu_only",) + key)
            continue
        missing.append(name)
    return missing, used


def test_the_walk_sees_functions_classes_and_methods():
    quals = {(rel, qual) for rel, qual, _, _ in CALLABLES}
    assert {("engine", "trace_accumulate"), ("streaming", "Streamer"),
            ("streaming", "Streamer.stream_clip"),
            ("ops.pallas.bounce_kernel", "trace_frames_ir_accel"),
            ("posefeed", "PoseFeedError")} <= quals
    assert len(CALLABLES) > 250


@pytest.mark.parametrize("rel", sorted({rel for rel, *_ in CALLABLES}))
def test_every_jax_parameter_has_a_counterpart(rel):
    gaps = {}
    for m, qual, jax_obj, port_obj in CALLABLES:
        if m == rel:
            missing, _ = unmatched(m, qual, jax_obj, port_obj)
            if missing:
                gaps[qual] = missing
    assert not gaps, f"{rel}: JAX parameters without a counterpart {gaps}"


def test_every_exception_is_used_and_names_a_jax_parameter():
    """No entry of the maps is stale: each is needed by some JAX
    parameter the port lacks by name, and a TPU-only one by name
    everywhere in the port."""
    used = set()
    for rel, qual, jax_obj, port_obj in CALLABLES:
        used |= unmatched(rel, qual, jax_obj, port_obj)[1]
    for name in RENAMED_ANYWHERE:
        assert ("anywhere", name) in used, name
    for (rel, qual), names in RENAMED_PARAMS.items():
        for name in names:
            assert ("renamed", rel, qual, name) in used, (rel, qual, name)
    for key in TPU_ONLY_PARAMS:
        assert ("tpu_only",) + key in used, key
    for rel, qual in FORWARDS:
        assert ("forward", rel, qual) in used, (rel, qual)


# -- bin_offset: recorded, a window is a slice --------------------------------

def test_bin_offset_window_is_a_slice_of_the_port_ir():
    """JAX's ``trace_frame_ir_whole(..., bin_offset=512)`` (interpret mode)
    is the window ``[512, 512 + T)`` of the IR; the port's plain whole-frame
    trace over ``512 + T`` bins, sliced there, on the same uniforms, agrees
    within K3's parity limits (``test_torch_bounce_kernel.py``: energy 1%,
    L1 2%, and no further from the TPU kernel than JAX's own jnp oracle,
    since the TPU kernel bins through bf16 one-hots)."""
    from realisticaudioraytracing2d_tpu.models import rooms as jax_rooms
    from realisticaudioraytracing2d_tpu.ops import ir as jax_ir
    from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
    from realisticaudioraytracing2d_tpu.ops import trace as jax_trace
    from realisticaudioraytracing2d_tpu.ops.pallas import \
        bounce_kernel as jax_bk
    from realisticaudioraytracing2d_tpu_torch import convert
    from realisticaudioraytracing2d_tpu_torch.ops.cuda import \
        bounce_kernel as bk

    sr, t, off = 8000, 2048, 512
    room = jax_rooms.smoll_room()
    p = jax_trace.TraceParams.make(room.source, room.listener, 0.5, 343.0,
                                   1.0)
    key = jax.random.PRNGKey(9)
    n_rays, n_bounces = 1024, 4
    want = np.asarray(jax_bk.trace_frame_ir_whole(
        room.scene, p, key, n_rays=n_rays, max_bounces=n_bounces,
        sample_rate=sr, ir_length=t, tile_r=256, bin_offset=off))
    emit, u = jax_rng.bounce_uniforms(key, n_bounces, n_rays)
    scene = convert.scene_from_arrays(room.scene, device=CPU)
    params = convert.params_from_arrays(p, device=CPU)
    got = to_numpy(bk.trace_frames_ir_plain(
        scene, params, to_torch(emit)[None], to_torch(u)[None],
        sample_rate=sr, ir_length=off + t)[:, off:, :])
    oracle = np.asarray(jax_ir.scatter_hits(jax_trace.trace_hits_only(
        room.scene, p, key, n_rays=n_rays, max_bounces=n_bounces), sr,
        off + t))[:, off:, :]

    def l1(a, b):
        return np.abs(a - b).sum() / np.abs(b).sum()

    assert got.shape == want.shape == (1, t, 1)
    assert (want != 0).sum() > 100
    assert abs(got.sum() - want.sum()) / want.sum() < 1e-2
    assert l1(got, want) < 2e-2
    assert l1(got, want) <= l1(oracle, want) + 1e-3


# -- the parameter the audit found: ported ------------------------------------

def test_bounce_uniforms_take_n_listeners_as_jax():
    """``n_listeners`` changes no draw on either side: every listener hears
    the same rays."""
    from realisticaudioraytracing2d_tpu.ops import rng as jax_rng
    from realisticaudioraytracing2d_tpu_torch.ops import rng

    key = jax.random.PRNGKey(3)
    for a, b in zip(jax_rng.bounce_uniforms(key, 4, 64),
                    jax_rng.bounce_uniforms(key, 4, 64, n_listeners=3)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    one = rng.bounce_uniforms(torch.Generator().manual_seed(5), 2, 4, 64,
                              CPU)
    three = rng.bounce_uniforms(torch.Generator().manual_seed(5), 2, 4, 64,
                                CPU, n_listeners=3)
    assert all(torch.equal(x, y) for x, y in zip(one, three))
    assert tuple(three[0].shape) == (2, 64)
    assert tuple(three[1].shape) == (2, 4, 64, 3)
