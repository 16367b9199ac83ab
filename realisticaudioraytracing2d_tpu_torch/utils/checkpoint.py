"""Checkpoint / resume of IR accumulations and other tensor trees
(PyTorch).

Port of ``realisticaudioraytracing2d_tpu/utils/checkpoint.py``, in that
package's on-disk format, so a checkpoint written by either package loads
in the other: an ``.npz`` with one array per leaf (``leaf_0``,
``leaf_1``, ...) plus a JSON sidecar ``<path>.json`` with ``format``,
``kind``, ``treedef``, ``n_leaves``, ``leaf_paths``, ``shapes``,
``dtypes`` and ``meta``. Loading validates the sidecar: a checkpoint of
another kind or structure errors instead of misloading.

:func:`save_pytree` / :func:`load_pytree` take a tree of nested tuples,
NamedTuples, dicts and lists whose leaves are tensors, arrays or numbers
(None is an empty subtree, as in JAX). The leaves are numbered in JAX's
flattening order (dict keys sorted) and named by JAX's key paths
(``jax.tree_util.keystr``: ``.field``, ``[0]``, ``['key']``). The
sidecar's ``treedef`` is, in the JAX package, ``str()`` of the JAX tree
structure, which its loader compares: the port writes the same string
(:func:`treedef_str`), so the JAX package loads the port's files. The
port's loader does not compare that string, which belongs to JAX; it
compares ``kind``, ``n_leaves``, ``leaf_paths`` and the shapes, which
identify the structure without it. ``IRState`` keeps its own pair,
:func:`save_ir_state` / :func:`load_ir_state`, which writes ``frames`` as
JAX's 0-d int32 and loads an IR of any shape.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

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


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """The ``(key path, leaf)`` pairs of ``tree`` in JAX's order."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        return [kv for f, v in zip(tree._fields, tree)
                for kv in _flatten(v, f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, bool, int,
                         float)):
        return [(path, tree)]
    raise TypeError(f"checkpoint leaf {path or '<root>'} is a "
                    f"{type(tree).__name__}: tensors, arrays and numbers "
                    "in tuples, NamedTuples, dicts and lists only")


def _structure(tree: Any) -> str:
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(_structure(v) for v in tree) + "])")
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def treedef_str(tree: Any) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for the trees this module
    takes, e.g. ``PyTreeDef(CustomNode(namedtuple[IRState], [*, *]))``."""
    return f"PyTreeDef({_structure(tree)})"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree: Any, meta: Optional[Dict] = None,
                kind: Optional[str] = None) -> None:
    """Save a tree of tensors as npz + a validating sidecar (each tensor
    comes to the host once). ``kind`` labels what the checkpoint is
    (default: the root's type name, e.g. ``"IRState"``); loaders check it
    before touching the leaves."""
    path = _norm(path)
    pairs = _flatten(tree)
    arrays = [_host(x) for _, x in pairs]
    np.savez_compressed(path, **{f"leaf_{i}": x
                                 for i, x in enumerate(arrays)})
    side = {
        "format": _FORMAT,
        "kind": kind or type(tree).__name__,
        "treedef": treedef_str(tree),
        "n_leaves": len(pairs),
        "leaf_paths": [p for p, _ in pairs],
        "shapes": [list(x.shape) for x in arrays],
        "dtypes": [str(x.dtype) for x in arrays],
        "meta": meta or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(side, f)


def _unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure with its leaves taken in order from
    ``leaves`` (consumed)."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return leaves.pop(0)


def load_pytree(path: str, like: Any, kind: Optional[str] = None,
                device=None) -> Any:
    """Load a checkpoint into the structure of ``like`` (a prototype tree
    of tensors, arrays or numbers; a tensor on the ``meta`` device serves
    as a shape). The sidecar's kind, leaf count and leaf paths must match,
    and each leaf's shape the prototype's (so a 512-room sweep cannot
    resume a 1024-room run). A leaf whose prototype is a Python number
    loads as one of its type; every other leaf as a tensor on ``device``
    (:func:`..device.resolve`: the card by default)."""
    path = _norm(path)
    side = read_sidecar(path)
    want_kind = kind or type(like).__name__
    if side.get("kind") != want_kind:
        raise ValueError(f"checkpoint {path!r} is a {side.get('kind')!r}, "
                         f"not a {want_kind!r}")
    protos = _flatten(like)
    want_paths = [p for p, _ in protos]
    if side.get("n_leaves") != len(protos) or \
            side.get("leaf_paths") != want_paths:
        raise ValueError(
            f"checkpoint {path!r} tree structure {side.get('treedef')!r} "
            f"(leaves {side.get('leaf_paths')}) != expected "
            f"{treedef_str(like)!r} (leaves {want_paths})")
    with np.load(path) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(protos))]
    dev = resolve(device)
    leaves = []
    for i, (got, (leaf_path, proto)) in enumerate(zip(arrays, protos)):
        want_shape = tuple(np.shape(proto)) if not hasattr(proto, "shape") \
            else tuple(proto.shape)
        if tuple(got.shape) != want_shape:
            raise ValueError(
                f"checkpoint {path!r} leaf {i} ({leaf_path}) has shape "
                f"{got.shape}, expected {want_shape}")
        leaves.append(type(proto)(got.item())
                      if isinstance(proto, (bool, int, float))
                      else torch.from_numpy(np.array(got)).to(dev))
    return _unflatten(like, leaves)


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
