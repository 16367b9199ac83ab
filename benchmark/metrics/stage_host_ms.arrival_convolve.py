"""Host milliseconds a stream chunk spends in per-arrival Doppler's
crossfaded FFT convolution of the residual ears
(``art.arrival.convolve``; ``benchmark/span_stages.py``)."""

from benchmark import span_stages


def read(r):
    return span_stages.host_ms(r, "art.arrival.convolve")
