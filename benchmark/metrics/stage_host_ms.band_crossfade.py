"""Host milliseconds a banded stream chunk spends in its crossfade
(``art.stream.crossfade``): the crossfaded FFT convolution in the stream's
band split, K transforms of each IR (``benchmark/span_stages.py``)."""

from benchmark import span_stages


def read(r):
    return span_stages.host_ms(r, "art.stream.crossfade")
