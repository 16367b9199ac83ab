"""Host milliseconds a stream chunk spends in the binaural decode of the
chunk's full three-microphone capture to two ears
(``art.stream.decode``; ``benchmark/span_stages.py``)."""

from benchmark import span_stages


def read(r):
    return span_stages.host_ms(r, "art.stream.decode")
