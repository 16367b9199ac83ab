"""K9's share of its roofline in % (``frames_ir_kernel``, one launch a
sweep call on each card): the least time the call's rooms need on one
card's peaks (``benchmark/roofline.py``) over the kernel's device time,
summed over the cards."""

from benchmark import roofline
from benchmark.capture import Reading


def read(r: Reading):
    return roofline.share(r, "frames_ir_kernel")
