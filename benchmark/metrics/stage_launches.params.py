"""Kernel launch calls a stream chunk issues in ``Engine.params``
(``art.params``): the pose's trace parameters and their copies to the card
(``benchmark/stages.py``)."""

from benchmark import stages


def read(r):
    return stages.launches(r, "params")
