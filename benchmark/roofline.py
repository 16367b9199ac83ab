"""The yardstick of the per-layer readers: the card's peaks and the work
and bytes a trace kernel's inputs need.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3.
A card set below 700 W (``nvidia-smi``'s ``power.limit``, printed by every
run) runs slower under load; the shares are held against these peaks.

A wall test of the brute-force trace (does a ray cross a segment, and
where) is 13 float32 operations: the two numerators and the denominator
of the ray-segment solve (11 multiplies and adds) and the two range tests
it needs beyond them. A ray alive at the start of a bounce tests every
wall of its scene for the nearest hit; a shadow ray that is heard (its
next-event estimate passes the cutoff) tests every wall for an occluder.
The counts of both come from the reference's own trace of the compared
answers (``reference.physics.Work``): what these inputs need, not the
most they could (a dead ray needs no test). Bytes: each input read once
(the walls' nine floats and their K absorptions, the listeners, the
source) and each IR bin written once as a float32.
"""

from __future__ import annotations

from typing import Optional

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_WALL_TEST = 13


def least_seconds(shapes: dict, work) -> Optional[tuple]:
    """``(seconds, bound)`` a step's trace kernel needs at least on one
    card's peaks, summed over the step's entries: ``bound`` says which of
    ``"operations"`` and ``"bytes"`` sets it. None without the work."""
    if work is None:
        return None
    w, k = shapes["n_walls"], shapes["n_bands"]
    e, n_l = shapes["n_entries"], shapes["n_listeners"]
    ops = FLOP_PER_WALL_TEST * w * (work.alive + work.heard)
    nbytes = 4 * (e * (w * (9 + k) + 2 + 2 * n_l)
                  + e * n_l * shapes["ir_length"] * k)
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share(r, kernel: str) -> Optional[float]:
    """The kernel's share of its roofline in %: the least time of the
    window's steps over the kernel's device time in them. None where the
    window ran no such kernel or the work was not counted."""
    spent = r.kernel_seconds(lambda name: kernel in name)
    least = least_seconds(r.shapes, r.work)
    if spent <= 0 or least is None:
        return None
    return 100.0 * least[0] * r.steps / spent
