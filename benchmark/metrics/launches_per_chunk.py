"""Kernel launches the host issued per stream chunk: the host's launch
calls (``cudaLaunchKernel`` and kin) in the traced window over its
chunks. The stream driver's cost is mostly their issue."""

from benchmark.capture import Reading


def read(r: Reading):
    n = sum(1 for e in r.events if e.kind == "launch")
    return n / r.steps if n else None
