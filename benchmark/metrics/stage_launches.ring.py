"""Kernel launch calls a stream chunk issues in the ring
(``art.stream.ring``): overlap-add, drain and the carried state's copies
(``benchmark/stages.py``)."""

from benchmark import stages


def read(r):
    return stages.launches(r, "ring")
