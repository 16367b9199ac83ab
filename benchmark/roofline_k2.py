"""The yardstick of the visibility kernel K2's share of its roofline: the
work and bytes that the diffraction of a chunk's inputs needs.

K2 (``wall_sweep_kernel<false, ...>``, the occlusion sweep) judges
diffraction's visibility segments: each segment's ray against every wall,
its minimum distance kept where it is below the segment's length. The
count comes from the reference's own diffraction of the compared
answers (``reference.addenda.Work.segments``): the direct segment, and
where the walls block it both legs of each edge and each ordered pair of
distinct edges, what these inputs need (a lit pose needs the direct
segment alone). Operations: 13 FLOP a wall test, as
``benchmark/roofline.py`` counts a trace's. Bytes: each segment's ends
and limit (five floats) and the walls' packed table (five floats a wall)
read once, one float written a segment. Peaks: ``roofline.py``'s.
"""

from __future__ import annotations

from typing import Optional

from benchmark import roofline

KERNEL = "wall_sweep_kernel<false"


def least_seconds(shapes: dict, work) -> Optional[float]:
    """Seconds a step's K2 launches need at least on one card's peaks;
    None without the reference's segment count."""
    segments = getattr(work, "segments", None)
    if segments is None:
        return None
    w = shapes["n_walls"]
    ops = roofline.FLOP_PER_WALL_TEST * w * segments
    nbytes = 4 * (6 * segments + 5 * w)
    return max(ops / roofline.FP32_FLOPS, nbytes / roofline.HBM_BYTES_PER_S)


def share(r) -> Optional[float]:
    """K2's share of its roofline in %: the least time of the window's
    steps over K2's device time in them. None where the window ran no K2
    or the work was not counted."""
    spent = r.kernel_seconds(lambda name: KERNEL in name)
    least = least_seconds(r.shapes, r.work)
    if spent <= 0 or least is None:
        return None
    return 100.0 * least * r.steps / spent
