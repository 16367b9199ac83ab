"""Kernel launch calls a stream chunk issues in per-arrival Doppler's
binaural decode of the residual capture (``art.arrival.residual``;
``benchmark/span_stages.py``)."""

from benchmark import span_stages


def read(r):
    return span_stages.launches(r, "art.arrival.residual")
