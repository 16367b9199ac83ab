"""Carry state from the JAX package into the port.

Each function takes the JAX object, or anything with the same attribute
names, reads every field with ``np.asarray`` (so this module imports no
JAX), and returns the port's object on ``device``. This is how the tests
hand a JAX scene, poses, hits, debug paths, IR, spatial IR, stream
state (plain, binaural or per-arrival Doppler) and material logits to
the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve
from .diff import MaterialParams
from .models.scene import Scene
from .ops.ir import IRState
from .ops.legacy import LegacyIRState
from .ops.trace import DebugPaths, Hits, TraceParams
from .spatial import SpatialIR
from .streaming import ArrivalCarry, RingBuffer, StreamState


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
    """:class:`TraceParams` from a JAX ``TraceParams``, with its source
    and microphone patterns (``directivity``, ``mic_directivity``) when
    it has them."""
    return TraceParams(**{f: (None if getattr(params, f) is None
                              else _t(getattr(params, f), device, np.float32))
                          for f in TraceParams._fields})


def material_params_from_arrays(mp, device=None) -> MaterialParams:
    """:class:`~.diff.MaterialParams` from a JAX ``MaterialParams`` (the
    logits ``absorption[G, K]``, ``scattering``, ``transmission``,
    ``ior``), so both packages fit from the same start."""
    return MaterialParams(**{f: _t(getattr(mp, f), device, np.float32)
                             for f in MaterialParams._fields})


def ir_state_from_arrays(state, device=None) -> IRState:
    """:class:`IRState` from a JAX ``IRState`` (``sum[L, T, K]``, ``frames``)."""
    return IRState(sum=_t(state.sum, device, np.float32),
                   frames=int(np.asarray(state.frames)))


def arrival_carry_from_arrays(carry, device=None) -> ArrivalCarry:
    """:class:`ArrivalCarry` from a JAX ``ArrivalCarry`` (the tap bins as
    int64; ``x3``/``y3`` of a binaural one)."""
    def opt(x):
        return None if x is None else _t(x, device, np.float32)

    return ArrivalCarry(res=_t(carry.res, device, np.float32),
                        idx=_t(carry.idx, device, np.int64),
                        g3=_t(carry.g3, device, np.float32),
                        val=_t(carry.val, device, bool),
                        x3=opt(carry.x3), y3=opt(carry.y3))


def stream_state_from_arrays(state, device=None) -> StreamState:
    """:class:`StreamState` from a JAX ``StreamState``: plain, binaural
    (``prev_facing``) or per-arrival Doppler (``arrival``)."""
    ring = RingBuffer(_t(state.ring.data, device, np.float32),
                      int(np.asarray(state.ring.read_head)))
    facing = getattr(state, "prev_facing", None)
    arrival = getattr(state, "arrival", None)
    return StreamState(prev_ir=_t(state.prev_ir, device, np.float32),
                       ring=ring,
                       chunk_index=int(np.asarray(state.chunk_index)),
                       prev_facing=(None if facing is None
                                    else _t(facing, device, np.float32)),
                       arrival=(None if arrival is None
                                else arrival_carry_from_arrays(arrival,
                                                               device)))


def spatial_ir_from_arrays(sp_ir, device=None) -> SpatialIR:
    """:class:`SpatialIR` from a JAX ``SpatialIR`` (``w``, ``x``, ``y``,
    and ``x2``, ``y2`` of an order-2 capture)."""
    return SpatialIR(*(None if getattr(sp_ir, f) is None
                       else _t(getattr(sp_ir, f), device, np.float32)
                       for f in SpatialIR._fields))


def hits_from_arrays(hits, device=None) -> Hits:
    """:class:`Hits` from a JAX ``Hits`` (``delay``, ``energy``, ``valid``)."""
    return Hits(delay=_t(hits.delay, device, np.float32),
                energy=_t(hits.energy, device, np.float32),
                valid=_t(hits.valid, device, bool))


def debug_paths_from_arrays(paths, device=None) -> DebugPaths:
    """:class:`DebugPaths` from a JAX ``DebugPaths``."""
    return DebugPaths(pos=_t(paths.pos, device, np.float32),
                      energy=_t(paths.energy, device, np.float32),
                      alive=_t(paths.alive, device, bool))


def legacy_state_from_arrays(state, device=None) -> LegacyIRState:
    """:class:`LegacyIRState` from a JAX ``LegacyIRState``."""
    return LegacyIRState(sum=_t(state.sum, device, np.float32),
                         frames=int(np.asarray(state.frames)))
