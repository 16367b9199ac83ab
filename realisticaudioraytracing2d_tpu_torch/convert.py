"""Carry state from the JAX package into the port.

Each function takes the JAX object, or anything with the same attribute
names, reads every field with ``np.asarray`` (so this module imports no
JAX), and returns the port's object on ``device``. This is how the tests
hand a JAX scene, poses, IR and stream state to the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve
from .models.scene import Scene
from .ops.ir import IRState
from .ops.trace import TraceParams
from .streaming import RingBuffer, StreamState


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype, copy=True)).to(
        resolve(device))


def scene_from_arrays(scene, device=None) -> Scene:
    """A :class:`Scene` from the eight fields of a JAX ``Scene``; a
    stacked JAX batch (``Scene.stack``, ``random_rooms``) keeps its
    leading room axis."""
    return Scene(**{f: _t(getattr(scene, f), device,
                          bool if f == "mask" else np.float32)
                    for f in Scene._fields})


def params_from_arrays(params, device=None) -> TraceParams:
    """:class:`TraceParams` from a JAX ``TraceParams``."""
    return TraceParams(**{f: (None if getattr(params, f) is None
                              else _t(getattr(params, f), device, np.float32))
                          for f in TraceParams._fields})


def ir_state_from_arrays(state, device=None) -> IRState:
    """:class:`IRState` from a JAX ``IRState`` (``sum[L, T, K]``, ``frames``)."""
    return IRState(sum=_t(state.sum, device, np.float32),
                   frames=int(np.asarray(state.frames)))


def stream_state_from_arrays(state, device=None) -> StreamState:
    """:class:`StreamState` from a plain-mode JAX ``StreamState``."""
    ring = RingBuffer(_t(state.ring.data, device, np.float32),
                      int(np.asarray(state.ring.read_head)))
    return StreamState(prev_ir=_t(state.prev_ir, device, np.float32),
                       ring=ring,
                       chunk_index=int(np.asarray(state.chunk_index)))
