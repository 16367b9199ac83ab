"""Kernel launch calls a stream chunk issues in the addenda
(``art.stream.addenda``): the IR's normalization and the physics addenda
(``benchmark/stages.py``)."""

from benchmark import stages


def read(r):
    return stages.launches(r, "addenda")
