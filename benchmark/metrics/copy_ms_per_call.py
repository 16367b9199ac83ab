"""Device milliseconds of copies (device to host, card to card, on the
card) per sweep call, summed over the cards: the gather of the shards
and the IRs' way to host memory."""

from benchmark.capture import Reading


def read(r: Reading):
    s = sum(e.seconds for e in r.events if e.kind == "memcpy")
    return 1e3 * s / r.steps if s > 0 else None
