"""PyTorch port: every public name of the JAX package has a counterpart.

Each module of ``realisticaudioraytracing2d_tpu`` (walked with
``pkgutil``; ``native.libartnative`` is a shared object and is skipped)
maps to the port's module of the same path, ``ops.pallas.*`` to
``ops.cuda.*``. Every name the JAX module defines at its top level
(functions, classes, constants; not ``_``-prefixed, not imported) must
exist in that port module, unless ``RENAMED`` names where the port keeps
it or ``TPU_ONLY`` says why it has none. The JAX ``__all__`` must be in
the port's ``__all__``.

The names added to close the last gaps are held against JAX's output on
the same inputs: ``scene_from_boxes`` (walls and attributes bit for
bit), ``sine_clip`` (samples bit for bit), ``load_builtin_clip`` (the
same rate and samples).
"""

import ast
import importlib
import pkgutil

import numpy as np
import pytest
from torch_parity import CPU, to_numpy

import realisticaudioraytracing2d_tpu as jart
import realisticaudioraytracing2d_tpu_torch as art

JAX_ROOT = jart.__name__
PORT_ROOT = art.__name__

# (JAX module, name) -> (port module, port name): kept under another name
# or in another module.
RENAMED = {
    ("ops.pallas.bounce_kernel", "trace_frame_ir_whole"):
        ("ops.cuda.bounce_kernel", "trace_frames_ir_whole"),
    ("ops.pallas.bounce_kernel", "trace_frames_ir_accel"):
        ("ops.cuda.accel_kernel", "trace_frames_ir_accel"),
    ("ops.pallas.bounce_kernel", "trace_frames_ir_accel_sorted"):
        ("ops.cuda.accel_kernel", "trace_frames_ir_accel_sorted"),
    ("ops.pallas.bounce_kernel", "cluster_scene_jnp"):
        ("ops.accel", "cluster_scene"),
    ("ops.pallas.bounce_kernel", "accel_cluster_size"):
        ("ops.accel", "accel_cluster_size"),
    ("ops.pallas.bounce_kernel", "accel_group"):
        ("ops.accel", "accel_group"),
    ("ops.pallas.trace_kernel", "nearest_hit_pallas"):
        ("ops.cuda.trace_kernel", "nearest_hit"),
    ("ops.pallas.trace_kernel", "occlusion_min_pallas"):
        ("ops.cuda.trace_kernel", "occlusion_min"),
}

_VMEM = "a VMEM-budget tile or window (ROADMAP, 'Not to port')"
_LAYOUT = ("a TPU operand layout (sublane-padded rows, the one-hot MXU "
           "gather's operand, a lane-padded listener table); the CUDA "
           "kernels pack their own tables (ops/cuda/bounce_kernel.py)")
# (JAX module, name or None for the whole module) -> why the port has none
TPU_ONLY = {
    ("ops.pallas.common", None):
        "Pallas lane and sublane constants and the interpret-mode switch",
    ("ops.pallas.bounce_kernel", "DEF_TILE_R"): _VMEM,
    ("ops.pallas.trace_kernel", "DEF_TILE_R"): _VMEM,
    ("ops.pallas.bounce_kernel", "auto_tile"): _VMEM,
    ("ops.pallas.bounce_kernel", "time_window"): _VMEM,
    ("ops.pallas.bounce_kernel", "accel_tile"): _VMEM,
    ("ops.pallas.bounce_kernel", "ACCEL_CLUSTER"):
        "the TPU cluster width; the port sizes its clusters for the H100 "
        "(ops/accel.py::accel_cluster_size)",
    ("ops.pallas.bounce_kernel", "pack_walls_rows"): _LAYOUT,
    ("ops.pallas.bounce_kernel", "pack_wall_attrs_t"): _LAYOUT,
    ("ops.pallas.bounce_kernel", "pack_listeners"): _LAYOUT,
    ("ops.rng", "frame_key"):
        "JAX's fold_in of a PRNG key; the port names a frame by a Philox "
        "counter word (ops/rng.py::philox_uniforms)",
}


def jax_modules():
    """The JAX package's modules, by path relative to the package."""
    out = []
    for m in pkgutil.walk_packages(jart.__path__, JAX_ROOT + "."):
        if m.name.endswith(".libartnative"):
            continue
        out.append(m.name[len(JAX_ROOT) + 1:])
    return out


def port_path(rel):
    return rel.replace("ops.pallas", "ops.cuda", 1) if \
        rel.startswith("ops.pallas") else rel


def top_level_names(module):
    """Public names a module's source defines at its top level."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def test_the_walk_sees_the_package():
    mods = jax_modules()
    assert {"engine", "streaming", "cli", "ops.pallas.bounce_kernel",
            "ops.trace", "parallel.sweep", "utils.audio_io"} <= set(mods)
    assert all("libartnative" not in m for m in mods)


@pytest.mark.parametrize("rel", jax_modules())
def test_every_public_name_has_a_counterpart(rel):
    if (rel, None) in TPU_ONLY:
        with pytest.raises(ImportError):
            importlib.import_module(f"{PORT_ROOT}.{port_path(rel)}")
        return
    jm = importlib.import_module(f"{JAX_ROOT}.{rel}")
    pm = importlib.import_module(f"{PORT_ROOT}.{port_path(rel)}")
    missing = []
    for name in top_level_names(jm):
        if (rel, name) in TPU_ONLY:
            continue
        where, as_ = RENAMED.get((rel, name), (port_path(rel), name))
        target = importlib.import_module(f"{PORT_ROOT}.{where}")
        if not hasattr(target, as_):
            missing.append(name)
    assert not missing, f"{rel}: no port counterpart for {missing}"


def test_exceptions_are_real_jax_names():
    """Each listed exception names something the JAX module defines, so
    the lists cannot go stale: a TPU-only name the port lacks, a renamed
    one the port keeps where ``RENAMED`` says."""
    for rel, name in TPU_ONLY:
        if name is not None:
            jm = importlib.import_module(f"{JAX_ROOT}.{rel}")
            pm = importlib.import_module(f"{PORT_ROOT}.{port_path(rel)}")
            assert name in top_level_names(jm), (rel, name)
            assert not hasattr(pm, name), (rel, name)
    for (rel, name), (where, as_) in RENAMED.items():
        jm = importlib.import_module(f"{JAX_ROOT}.{rel}")
        assert name in top_level_names(jm), (rel, name)
        assert hasattr(importlib.import_module(f"{PORT_ROOT}.{where}"),
                       as_), (where, as_)


def test_jax_all_is_in_the_port_all():
    assert set(jart.__all__) <= set(art.__all__)
    assert art.DebugPaths is art.trace.DebugPaths


def test_scene_from_boxes_matches_jax():
    from realisticaudioraytracing2d_tpu.models import materials as jmat
    from realisticaudioraytracing2d_tpu.models import scene as jscene
    from realisticaudioraytracing2d_tpu_torch.models import materials
    from realisticaudioraytracing2d_tpu_torch.models import scene

    spec = [((0.0, 10.0), 0.0, (100.0, 1.0)),
            ((-11.8, 7.18), 0.98, (100.0, 1.0)),
            ((3.0, -2.0), 2.2, (4.0, 0.5))]
    for n_bands, pad_to in ((1, None), (4, 32)):
        jb = [(jscene.Transform2D(p, a, s), jmat.MATERIAL_INTERIOR)
              for p, a, s in spec]
        pb = [(scene.Transform2D(p, a, s), materials.MATERIAL_INTERIOR)
              for p, a, s in spec]
        want = jscene.scene_from_boxes(jb, n_bands=n_bands, pad_to=pad_to)
        got = scene.scene_from_boxes(pb, n_bands=n_bands, pad_to=pad_to,
                                     device=CPU)
        assert got.device.type == "cpu" and got.n_bands == n_bands
        for field in want._fields:
            np.testing.assert_array_equal(to_numpy(getattr(got, field)),
                                          np.asarray(getattr(want, field)),
                                          err_msg=field)


def test_sine_and_builtin_clips_match_jax():
    from realisticaudioraytracing2d_tpu.utils import audio_io as jio
    from realisticaudioraytracing2d_tpu_torch.utils import audio_io as pio

    for args in ((440.0, 0.25, 48000), (1000.0, 0.1, 44100, 0.8)):
        got, want = pio.sine_clip(*args), jio.sine_clip(*args)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    (got, rate), (want, want_rate) = pio.load_builtin_clip(), \
        jio.load_builtin_clip()
    assert rate == want_rate == 48000
    np.testing.assert_array_equal(got, want)
