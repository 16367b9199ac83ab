"""Host milliseconds a stream chunk spends in the crossfade
(``art.stream.crossfade``): the crossfaded FFT convolution
(``benchmark/stages.py``)."""

from benchmark import stages


def read(r):
    return stages.host_ms(r, "crossfade")
