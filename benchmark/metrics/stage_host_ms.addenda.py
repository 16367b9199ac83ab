"""Host milliseconds a stream chunk spends in the addenda
(``art.stream.addenda``): the IR's normalization and the physics addenda
(``benchmark/stages.py``)."""

from benchmark import stages


def read(r):
    return stages.host_ms(r, "addenda")
