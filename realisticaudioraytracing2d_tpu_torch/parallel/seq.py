"""Sequence parallelism: the convolution sharded along audio time.

Port of ``realisticaudioraytracing2d_tpu/parallel/seq.py``. The long axis
of this domain is audio time, the dry clip against an IR of ``sampleRate
* reverbDuration`` bins. With the clip cut into ``D`` chunks of ``C``
samples, the overlap-add identity

    conv(x, ir) = sum_d shift(conv(x_d, ir), d * C)

gives the full convolution: each shard FFT-convolves its chunk alone
(:func:`..ops.convolve.convolve_fft`, cuFFT on the card; no hand kernel,
as the JAX package has none), places the partial at its time offset in an
``[N + T]`` buffer, and the buffers are summed in shard order
(:func:`.mesh.reduce_sum`, the JAX package's ``psum``). Gating (the
reference's ``|x| <= eps`` input skip) is elementwise, so it commutes
with the chunking.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import convolve as cv
from .mesh import Mesh, on_device, reduce_sum, sharded_leading


def convolve_seq_sharded(dry: torch.Tensor, ir: torch.Tensor, mesh: Mesh,
                         accum_count=1, *, axis: str = "rays",
                         gate_eps: Optional[float] = cv.EPS) -> torch.Tensor:
    """Full convolution ``[N] x [T] -> [N + T]`` with the dry clip split
    along time over ``mesh[axis]``: :func:`..ops.convolve.convolve_fft`
    (same length, gating and ``accum_count`` normalization) up to the float
    summation order. ``N`` must divide evenly by the axis size; the IR goes
    to every shard whole. Returns the result on the mesh's first device."""
    n = dry.shape[-1]
    t = ir.shape[-1]
    n_dev = mesh.shape[axis]
    if n % n_dev != 0:
        raise ValueError(f"clip length {n} not divisible by {axis}={n_dev}")
    chunk = n // n_dev
    parts = []
    for d, (dev, x_d) in enumerate(zip(
            mesh.axis_devices(axis),
            sharded_leading(mesh, axis, dry.reshape(n_dev, chunk)))):
        with on_device(dev):
            local = cv.convolve_fft(x_d[0], ir.to(dev), accum_count,
                                    gate_eps=gate_eps)        # [chunk + T]
            out = local.new_zeros(n + t)
            out[d * chunk:d * chunk + chunk + t] = local
        parts.append(out)
    return reduce_sum(mesh, parts)
