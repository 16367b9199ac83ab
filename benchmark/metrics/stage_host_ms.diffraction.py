"""Host milliseconds a stream chunk spends in the diffraction IR of orders 1
and 2: the edge table, both visibility sweeps (K2) and both path binnings
(``art.addenda.diffraction``, inside ``art.stream.addenda``;
``benchmark/span_stages.py``)."""

from benchmark import span_stages


def read(r):
    return span_stages.host_ms(r, "art.addenda.diffraction")
