"""Device meshes (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/parallel/mesh.py``. The JAX
package's communication layer is ``jax.sharding.Mesh`` with
``shard_map`` and XLA collectives (``psum`` over ICI). Here a
:class:`Mesh` is an array of ``torch.device``s with named axes, a sharded
function is a loop over the devices of one axis, and ``psum`` is
:func:`reduce_sum`: each shard's result moves to the mesh's first device
and the shards are summed there in shard order. That is one fixed order,
so one seed gives the same bits on every run. No ``torch.distributed``:
kernel launches on different cards are asynchronous, so on a host with
several cards the shards of the loop overlap without it.

Canonical axes (any name works; these are the JAX package's conventions):

* ``"rooms"``: data-parallel over scenes (:mod:`.sweep`) or over
  Monte-Carlo frames (:mod:`.frames`);
* ``"rays"``: over the ray batch of one scene (:mod:`.rays`), the sources
  of a mixdown (:mod:`.multisource`) or audio time (:mod:`.seq`).

A sharded function runs shard ``d`` of an axis on the device at index
``d`` of that axis and index 0 of every other axis. JAX runs every device
and takes ``pmean`` over the other axes, whose values are identical
copies; here each shard is computed once (:meth:`Mesh.axis_devices`).

A device may appear more than once: a **virtual mesh**, the counterpart
of the JAX tests' eight virtual CPU devices. The CPU tests shard over
``[cpu] * 8``, ``chip_smoke.py`` over ``[cuda:0] * 8``; the shards then
run one after the other on the one device and give the bits of a mesh of
distinct devices.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """An array of ``torch.device``s (``devices``, a numpy object array)
    with one name per axis. ``mesh.shape[axis]`` is the axis size, as for
    ``jax.sharding.Mesh``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} mesh dimensions but axis names "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))

    @property
    def first(self) -> torch.device:
        """The device the reductions gather on."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: where
        the shards of a function sharded over ``axis`` run."""
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r} in {self.axis_names}")
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if j == i else 0
                      for j in range(len(self.axis_names)))
        return list(self.devices[index])

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("rooms", "rays"),
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh over ``devices``, by default every CUDA device (torch
    without CUDA raises, as :func:`..device.resolve` does for ``None``).

    Default shape: all devices on the first axis, the others of size 1.
    A device may be listed more than once (a virtual mesh)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() defaults to the CUDA devices and there are none"
                "; pass devices=, e.g. [torch.device('cpu')] * 8")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != device count {n}")
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices
    return Mesh(dev_array.reshape(shape), axis_names)


def on_device(device: torch.device):
    """The context in which a shard runs: its card is the current CUDA
    device (the kernels launch on the current device's streams)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _tree_map(fn, x: Any) -> Any:
    """``fn`` on every tensor of a tensor, a (named) tuple or a list of
    them; other values (None, numbers) pass unchanged."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def replicated(mesh: Mesh, x: Any, axis: Optional[str] = None) -> list:
    """``x`` (a tensor, or a named tuple such as a ``Scene``) on every
    device of ``axis`` (:meth:`Mesh.axis_devices`; all of the mesh's
    devices, in order, when ``axis`` is None). The JAX function of this
    name returns a ``NamedSharding`` for ``jax.device_put``; XLA's
    sharding objects have no torch meaning, so the port returns the
    placed copies."""
    devs = list(mesh.devices.flat) if axis is None else \
        mesh.axis_devices(axis)
    return [_tree_map(lambda t, d=d: t.to(d), x) for d in devs]


def sharded_leading(mesh: Mesh, axis: str, x: Any) -> list:
    """``x``'s leading dimension split into ``mesh.shape[axis]`` equal
    parts, part ``d`` on device ``d`` of the axis (every tensor of a named
    tuple such as a stacked ``Scene`` the same way). The JAX function of
    this name returns the ``NamedSharding`` that splits the leading
    dimension over ``axis``; the port returns the placed parts. The
    leading dimension must divide evenly."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    out = []
    for d, dev in enumerate(devs):
        def part(t, d=d, dev=dev):
            if t.shape[0] % n != 0:
                raise ValueError(f"leading dimension {t.shape[0]} not "
                                 f"divisible by {axis}={n}")
            local = t.shape[0] // n
            return t[d * local:(d + 1) * local].to(dev)
        out.append(_tree_map(part, x))
    return out


def reduce_sum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``psum``: each shard's tensor moved to the mesh's first device and
    summed there in shard order, one fixed order of float additions."""
    first = mesh.first
    total = parts[0].to(first)
    for p in parts[1:]:
        total = total + p.to(first)
    return total


def gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' results concatenated along the leading dimension in
    shard order on the mesh's first device (a sharded output)."""
    first = mesh.first
    return torch.cat([p.to(first) for p in parts])
