"""K4's share of its roofline in % (``frames_ir_kernel``, one launch a
stream chunk): the least time the chunk's trace needs on the card's peaks
(``benchmark/roofline.py``) over the kernel's device time."""

from benchmark import roofline
from benchmark.capture import Reading


def read(r: Reading):
    return roofline.share(r, "frames_ir_kernel")
