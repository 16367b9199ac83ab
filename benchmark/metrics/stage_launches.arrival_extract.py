"""Kernel launch calls a stream chunk issues in per-arrival Doppler's tap
table of the capture's W channel, the taps' X/Y windows and their
removal from the capture (``art.arrival.extract``;
``benchmark/span_stages.py``)."""

from benchmark import span_stages


def read(r):
    return span_stages.launches(r, "art.arrival.extract")
