"""Host milliseconds a stream chunk spends in K4's argument preparation
(``art.k4.prep``), inside the retrace: checks, scalars, fixed-point scale,
pattern tables, the packed wall table (``benchmark/stages.py``)."""

from benchmark import stages


def read(r):
    return stages.host_ms(r, "k4_prep")
