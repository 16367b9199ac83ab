"""Seconds from the process's start to the first timed step: imports,
the kernels' build on a checkout's first run, the scene and state, and
the warm-up of every shape the window uses."""


def read(w):
    return w.setup_s
