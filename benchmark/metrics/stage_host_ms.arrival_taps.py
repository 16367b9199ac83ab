"""Host milliseconds a stream chunk spends in per-arrival Doppler's dry
history window, matching, the four ear fields and the tap synthesis
(``art.arrival.taps``; ``benchmark/span_stages.py``)."""

from benchmark import span_stages


def read(r):
    return span_stages.host_ms(r, "art.arrival.taps")
