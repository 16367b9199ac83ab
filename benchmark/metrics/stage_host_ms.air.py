"""Host milliseconds a stream chunk spends in ISO 9613-1 air absorption: the
per-band curve and its product with the IR (``art.addenda.air``, inside
``art.stream.addenda``; ``benchmark/span_stages.py``)."""

from benchmark import span_stages


def read(r):
    return span_stages.host_ms(r, "art.addenda.air")
