"""The host clock's milliseconds per stream chunk, over an untraced window
of the run's length before the traced one (a chunk is complete when its
output samples are in host memory): the stream's margin on real time,
which the host's Python and launch issue set. Its spread between
processes on a shared host (about 15% a set) is too wide for a bound."""


def read(r):
    w = r.host
    if w is None or w.units == 0:
        return None
    return 1e3 * w.seconds / w.units
