"""Checkpoint / resume of an IR accumulation (PyTorch).

Port of the ``IRState`` half of
``realisticaudioraytracing2d_tpu/utils/checkpoint.py``, in that package's
on-disk format, so a checkpoint written by either package resumes in the
other: an ``.npz`` with ``leaf_0`` (``sum[L, T, K]`` float32) and
``leaf_1`` (``frames``, a 0-d int32), plus a JSON sidecar ``<path>.json``
with ``format``, ``kind``, ``treedef``, ``n_leaves``, ``leaf_paths``,
``shapes``, ``dtypes`` and ``meta``. Loading validates the sidecar: a
checkpoint of another kind errors instead of misloading.

The sidecar's ``treedef`` is, in the JAX package, ``str()`` of the JAX tree
structure of an ``IRState``; its loader compares that string. The port
writes the same literal (:data:`IRSTATE_TREEDEF`) and does not compare it
on load: the string belongs to JAX, and ``kind``, ``n_leaves`` and
``shapes`` identify an ``IRState`` without it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve
from ..ops.ir import IRState

_FORMAT = 2  # sidecar schema version
# str(jax.tree_util.tree_structure(IRState(sum, frames))) of the JAX package
IRSTATE_TREEDEF = "PyTreeDef(CustomNode(namedtuple[IRState], [*, *]))"
_LEAF_PATHS = [".sum", ".frames"]


def _norm(path: str) -> str:
    """np.savez appends .npz when missing; normalize so save/load/sidecar
    always agree on the final filename."""
    return path if path.endswith(".npz") else path + ".npz"


def save_ir_state(path: str, state: IRState,
                  meta: Optional[Dict] = None) -> None:
    """Save an :class:`IRState` as npz + a validating sidecar (the tensor
    comes to the host once)."""
    path = _norm(path)
    leaves = [state.sum.detach().cpu().numpy().astype(np.float32),
              np.asarray(int(state.frames), np.int32)]
    np.savez_compressed(path, **{f"leaf_{i}": x
                                 for i, x in enumerate(leaves)})
    side = {
        "format": _FORMAT,
        "kind": "IRState",
        "treedef": IRSTATE_TREEDEF,
        "n_leaves": len(leaves),
        "leaf_paths": _LEAF_PATHS,
        "shapes": [list(x.shape) for x in leaves],
        "dtypes": [str(x.dtype) for x in leaves],
        "meta": meta or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(side, f)


def read_sidecar(path: str) -> Dict:
    path = _norm(path)
    side_path = path + ".json"
    if not os.path.exists(side_path):
        raise ValueError(
            f"checkpoint {path!r} has no sidecar {side_path!r}; refusing "
            f"to guess the leaf layout of a bare npz")
    with open(side_path) as f:
        return json.load(f)


def load_ir_state(path: str, device=None) -> IRState:
    """Load an IRState checkpoint of any shape onto ``device``: the kind
    and structure are validated against the sidecar, the shapes are taken
    from the sidecar itself (an IR resume doesn't know its length up
    front) and checked against the leaves."""
    side = read_sidecar(path)
    with np.load(_norm(path)) as z:
        files = set(z.files)
        leaves = [z[k] for k in ("leaf_0", "leaf_1") if k in files]
    if "kind" not in side:
        # format-1 sidecar: {treedef, n_leaves, meta} only. Old
        # accumulations stay resumable; validate what format 1 recorded
        # plus the actual leaf layout.
        if side.get("n_leaves") != 2 or files != {"leaf_0", "leaf_1"}:
            raise ValueError(
                f"{path!r} is a format-1 checkpoint but not an "
                f"IRState (n_leaves={side.get('n_leaves')})")
        if leaves[0].ndim != 3 or leaves[1].shape != ():
            raise ValueError(
                f"{path!r} format-1 leaves don't look like "
                f"(sum[L,T,K], frames): {leaves[0].shape}, {leaves[1].shape}")
    else:
        if side.get("kind") != "IRState" or side.get("n_leaves") != 2:
            raise ValueError(
                f"{path!r} is not an IRState checkpoint "
                f"(kind={side.get('kind')!r}, "
                f"n_leaves={side.get('n_leaves')})")
        shapes = side.get("shapes", [])
        if len(shapes) != 2 or len(shapes[0]) != 3 or shapes[1] != []:
            raise ValueError(
                f"{path!r} does not look like (sum[L,T,K], frames): "
                f"shapes={shapes}")
        if len(leaves) != 2:
            raise ValueError(f"{path!r} holds leaves {sorted(files)}, "
                             "expected leaf_0 and leaf_1")
        for i, (got, want) in enumerate(zip(leaves, shapes)):
            if list(got.shape) != want:
                raise ValueError(
                    f"checkpoint {path!r} leaf {i} ({_LEAF_PATHS[i]}) has "
                    f"shape {got.shape}, expected {tuple(want)}")
    return IRState(sum=torch.from_numpy(leaves[0].astype(np.float32)
                                        ).to(resolve(device)),
                   frames=int(leaves[1]))


def latest_checkpoint(directory: str, prefix: str = "ir_") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    cands = sorted(f for f in os.listdir(directory)
                   if f.startswith(prefix) and f.endswith(".npz"))
    return os.path.join(directory, cands[-1]) if cands else None
