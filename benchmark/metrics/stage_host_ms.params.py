"""Host milliseconds a stream chunk spends in ``Engine.params``
(``art.params``): the pose's trace parameters and their copies to the card
(``benchmark/stages.py``)."""

from benchmark import stages


def read(r):
    return stages.host_ms(r, "params")
