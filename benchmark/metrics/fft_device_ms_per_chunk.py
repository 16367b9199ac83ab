"""Device milliseconds of the crossfaded convolution's cuFFT kernels (by
name) per stream chunk."""

from benchmark.capture import Reading


def read(r: Reading):
    s = r.kernel_seconds(lambda name: "fft" in name.lower())
    return 1e3 * s / r.steps if s > 0 else None
