"""The cards' busy milliseconds per stream chunk over the window: the
union of the kernels, copies and fills that ran on them (the profiler's
device activity, read over every chunk of the window), over the chunks
completed in it. A title renders on the same card: this is the card time
the audio takes from it every 0.1 s."""


def read(w):
    if w.device_s is None or w.units == 0:
        return None
    return 1e3 * w.device_s / w.units
