"""PyTorch port: the single-scene launch's arguments on the CPU.

``ops/cuda/bounce_kernel.py::k4_args`` packs the wall table, the scalars
and the fixed-point scale of a K3/K4/K6 launch in one launch of
``k4_args_kernel`` on the card; on a CPU scene it runs its plain twin,
``k4_args_plain``, which is the chain of ``pack_walls_banded``,
``pack_scalars`` and ``fixed_point_scale``. Here: the twin as one function
against the three, and the wrapper's argument checks that run before any
launch (``k4_args_inputs``). tests/test_torch_cuda_k4_args.py holds the
kernel against the twin bit for bit on the card."""

import numpy as np
import pytest
import torch

from realisticaudioraytracing2d_tpu_torch.models import rooms
from realisticaudioraytracing2d_tpu_torch.ops import directivity as dv
from realisticaudioraytracing2d_tpu_torch.ops.cuda import bounce_kernel as bk
from realisticaudioraytracing2d_tpu_torch.ops.trace import TraceParams

CPU = "cpu"


def _case(n_bands=1, n_listeners=1, directive=False, seed=0):
    room = rooms.smoll_room(n_bands=n_bands, device=CPU)
    g = np.random.default_rng(seed)
    src = np.asarray(room.source, np.float32)
    lis = (src + g.uniform(-6.0, 6.0, (n_listeners, 2))).astype(np.float32)
    return room.scene, TraceParams.make(
        src, lis, directivity=dv.cardioid(-0.9) if directive else None,
        mic_directivity=dv.figure_eight(0.3) if directive else None,
        device=CPU)


@pytest.mark.parametrize("n_bands,n_listeners,directive", [
    (1, 1, False), (2, 4, False), (8, 64, False), (1, 1, True),
    (8, 4, True)])
@pytest.mark.parametrize("shape", [(1, 15000, 5), (8, 131072, 8)])
def test_plain_twin_is_the_three_functions(n_bands, n_listeners, directive,
                                           shape):
    scene, params = _case(n_bands, n_listeners, directive)
    walls, scal, scale = bk.k4_args_plain(scene, params, *shape)
    assert torch.equal(walls, bk.pack_walls_banded(scene)[None])
    assert torch.equal(scal, bk.pack_scalars(params)[None])
    assert torch.equal(scale, bk.fixed_point_scale(params, *shape)[None])
    assert walls.shape == (1, 10 + n_bands, scene.n_walls)
    assert scal.shape == (1, 5) and scale.shape == (1,)
    assert (walls.dtype, scal.dtype, scale.dtype) == (
        torch.float32, torch.float32, torch.float64)
    # the pattern tables handed in give the same scale
    tables = bk.pattern_tables(params.directivity, params.mic_directivity,
                               1, n_listeners, CPU)
    given = bk.k4_args_plain(scene, params, *shape, tables=tables)
    assert all(torch.equal(a, b) for a, b in zip(given, (walls, scal,
                                                         scale)))
    # a CPU scene's k4_args is the twin
    cpu = bk.k4_args(scene, params, *shape)
    assert all(torch.equal(a, b) for a, b in zip(cpu, (walls, scal, scale)))


def test_inputs_of_float32_params_are_passed_as_they_are():
    """float32 inputs, contiguous already: nothing converted or copied
    (on the card, no launch beside the kernel's), the mask 0."""
    scene, params = _case(n_bands=8, n_listeners=4)
    fields, lis, scalars, mask = bk.k4_args_inputs(scene, params)
    assert mask == 0
    assert [f is getattr(scene, n) for f, (n, _) in
            zip(fields, bk._SCENE_FIELDS)] == [True] * 7
    assert lis is params.listeners
    assert scalars[0] is params.source and scalars[3] is params.input_gain


@pytest.mark.parametrize("field,dtype,bit", [
    ("source", torch.float64, 0), ("listener_radius", torch.float16, 1),
    ("speed_of_sound", torch.float64, 2), ("input_gain", torch.bfloat16, 3),
    ("input_gain", torch.int32, 3)])
def test_a_non_float32_scalar_is_converted_once(field, dtype, bit):
    """One float64 copy of the input (the input itself when float64), its
    bit in the mask; the others untouched."""
    scene, params = _case()
    x = getattr(params, field).to(dtype)
    _, _, scalars, mask = bk.k4_args_inputs(scene,
                                            params._replace(**{field: x}))
    assert mask == 1 << bit
    got = scalars[bit]
    assert got.dtype == torch.float64 and torch.equal(got, x.double())
    assert (got is x) == (dtype == torch.float64)
    assert all(s.dtype == torch.float32 for i, s in enumerate(scalars)
               if i != bit)


def _bands_wrong(scene):
    return scene._replace(absorption=scene.absorption[:-1])


@pytest.mark.parametrize("what,edit,match", [
    ("band rows: absorption of another wall count",
     lambda s, p: (_bands_wrong(s), p), "absorption must have shape"),
    ("band rows: no band", lambda s, p: (s._replace(
        absorption=s.absorption[:, :0]), p), "at least one band"),
    ("band rows: 1-D absorption", lambda s, p: (s._replace(
        absorption=s.absorption[:, 0]), p), "absorption must have shape"),
    ("a stacked scene", lambda s, p: (s._replace(a=s.a[None]), p),
     "one scene"),
    ("a float64 wall field", lambda s, p: (s._replace(ior=s.ior.double()),
                                           p), "ior must be"),
    ("listeners [L, 3]", lambda s, p: (s, p._replace(
        listeners=torch.zeros(2, 3))), r"listeners must have shape \(2, 2\)"),
    ("listeners [2]", lambda s, p: (s, p._replace(
        listeners=torch.zeros(2))), r"listeners must be \[L, 2\]"),
    ("no listener", lambda s, p: (s, p._replace(
        listeners=torch.zeros(0, 2))), "L >= 1"),
    ("float64 listeners", lambda s, p: (s, p._replace(
        listeners=p.listeners.double())), "listeners must be torch.float32"),
    ("a source of three", lambda s, p: (s, p._replace(
        source=torch.zeros(3))), "source must have shape"),
    ("a gain of two", lambda s, p: (s, p._replace(
        input_gain=torch.ones(2))), "input_gain must have shape"),
    ("a radius on another device", lambda s, p: (s, p._replace(
        listener_radius=torch.ones((), device="meta"))), "is on meta"),
])
def test_argument_checks_before_any_launch(what, edit, match):
    scene, params = edit(*_case(n_bands=2, n_listeners=2))
    with pytest.raises(ValueError, match=match):
        bk.k4_args_inputs(scene, params)


def test_a_one_element_scalar_passes():
    scene, params = _case()
    _, _, scalars, mask = bk.k4_args_inputs(
        scene, params._replace(input_gain=params.input_gain.reshape(1)))
    assert mask == 0 and scalars[3].shape == (1,)


def test_check_kernel_supported_returns_the_pattern_tables():
    scene, params = _case(n_listeners=3, directive=True)
    src, mic = bk.check_kernel_supported(scene, params)
    want = bk.pattern_tables(params.directivity, params.mic_directivity, 1,
                             3, CPU)
    assert torch.equal(src, want[0]) and torch.equal(mic, want[1])
    assert bk.check_kernel_supported(*_case()) == (None, None)
