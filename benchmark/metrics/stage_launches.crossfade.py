"""Kernel launch calls a stream chunk issues in the crossfade
(``art.stream.crossfade``): the crossfaded FFT convolution
(``benchmark/stages.py``)."""

from benchmark import stages


def read(r):
    return stages.launches(r, "crossfade")
