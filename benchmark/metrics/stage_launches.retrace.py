"""Kernel launch calls a stream chunk issues in the retrace
(``art.stream.retrace``): the trace parameters, the fresh IR's fill and
the trace route, K4 with its argument preparation
(``benchmark/stages.py``)."""

from benchmark import stages


def read(r):
    return stages.launches(r, "retrace")
