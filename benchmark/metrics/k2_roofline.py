"""K2's share of its roofline in % (``wall_sweep_kernel<false, ...>``, the
visibility sweeps of a chunk's diffraction): the least time the chunk's
visibility segments need on the card's peaks
(``benchmark/roofline_k2.py``) over the kernel's device time."""

from benchmark import roofline_k2
from benchmark.capture import Reading


def read(r: Reading):
    return roofline_k2.share(r)
