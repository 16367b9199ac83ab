"""The share of the traced window in which nothing ran on the card, in %:
1 - (union of kernel, copy and fill intervals) / window, the mean over
the cell's cards."""

from benchmark.capture import Reading


def read(r: Reading):
    if not r.devices or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s() / r.window_s)
