"""Rooms whose IRs reached host memory over the window's seconds."""


def read(w):
    return w.units / w.seconds
