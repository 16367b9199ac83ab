"""Source and microphone directivity patterns (angular power gains).

Port of ``realisticaudioraytracing2d_tpu/ops/directivity.py``. A pattern is
a power gain over angle, a truncated Fourier series

``g(theta) = c[0] + sum_n c[2n-1] cos(n theta) + c[2n] sin(n theta)``

clamped at zero, held as a plain ``[2M+1]`` float32 array (``[L, 2M+1]``:
one pattern per listener). Emission is weighted by the source pattern at
the emission angle, capture and next-event estimation by the microphone
pattern at the direction the sound arrives from. IR deposits are linear
in a ray's energy, so the weighting is exact.

:func:`evaluate` takes angles, as the JAX function does. The trace and the
hand kernels evaluate the series from a direction's cosine and sine by
the angle-addition recurrence instead (:func:`fourier_gain`, the JAX
package's ``ops/pallas/bounce_kernel.py::_fourier_gain``): no arctan2 and
no trig, and the kernels compute the same recurrence in the same
operation order (``csrc/trace_common.cuh::fourier_gain``), so the plain
trace and the kernels agree bit for bit. The two forms differ by a few
ulps.

The presets return exact coefficients with ``c[0] = 1`` (the mean power of
an omni source); :func:`from_function` projects any pattern onto
``n_harmonics`` harmonics by an FFT, as the JAX package does, in numpy.
An omni-coded pattern ``[1.]`` gives a gain of exactly 1.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def evaluate(coeffs, angle) -> torch.Tensor:
    """Power gain ``g(angle)`` (>= 0). ``coeffs`` is ``[2M+1]`` or
    ``[..., 2M+1]``; its batch dims broadcast against ``angle``'s shape (a
    ``[L, C]`` table against ``[R, L]`` angles gives ``[R, L]`` gains)."""
    angle = torch.as_tensor(angle, dtype=torch.float32)
    c = torch.as_tensor(coeffs, dtype=torch.float32, device=angle.device)
    g = torch.broadcast_to(c[..., 0], torch.broadcast_shapes(
        c[..., 0].shape, angle.shape)).clone()
    m = (c.shape[-1] - 1) // 2
    for n in range(1, m + 1):
        g = g + c[..., 2 * n - 1] * torch.cos(n * angle) \
              + c[..., 2 * n] * torch.sin(n * angle)
    return torch.clamp(g, min=0.0)


def fourier_gain(c1: torch.Tensor, s1: torch.Tensor,
                 coeffs: torch.Tensor) -> torch.Tensor:
    """:func:`evaluate` at the angle whose cosine and sine are ``c1`` and
    ``s1``, by the recurrence ``cos((n+1)a) = cos(na) c1 - sin(na) s1``,
    ``sin((n+1)a) = sin(na) c1 + cos(na) s1``. ``coeffs`` ``[C]`` or
    ``[..., C]`` broadcasts against ``c1`` as in :func:`evaluate`. The
    hand kernels compute the same operations in the same order."""
    g = torch.broadcast_to(coeffs[..., 0], torch.broadcast_shapes(
        coeffs[..., 0].shape, c1.shape))
    m = (coeffs.shape[-1] - 1) // 2
    cn, sn = c1, s1
    for n in range(1, m + 1):
        g = g + coeffs[..., 2 * n - 1] * cn + coeffs[..., 2 * n] * sn
        if n < m:
            cn, sn = cn * c1 - sn * s1, sn * c1 + cn * s1
    return torch.clamp(g, min=0.0)


def omni() -> np.ndarray:
    return np.array([1.0], np.float32)


def cardioid(aim: float = 0.0) -> np.ndarray:
    """Cardioid power pattern aimed at ``aim`` (radians):
    ``g = 1 + cos(theta - aim)``, mean 1."""
    return np.array([1.0, np.cos(aim), np.sin(aim)], np.float32)


def figure_eight(aim: float = 0.0) -> np.ndarray:
    """Figure-of-eight power pattern ``g = 2 cos^2(theta - aim)`` (nulls
    perpendicular to ``aim``), mean 1."""
    return np.array([1.0, 0.0, 0.0, np.cos(2 * aim), np.sin(2 * aim)],
                    np.float32)


def from_function(fn: Callable[[np.ndarray], np.ndarray],
                  n_harmonics: int = 8, normalize: bool = True,
                  resolution: int = 4096) -> np.ndarray:
    """Project a power pattern ``fn(theta) -> gain`` onto the first
    ``n_harmonics`` Fourier harmonics (an FFT on a fine grid).
    ``normalize`` rescales so that the mean power ``c[0]`` is 1."""
    theta = np.linspace(0.0, 2.0 * np.pi, resolution, endpoint=False)
    g = np.asarray(fn(theta), np.float64)
    if np.any(g < 0):
        raise ValueError("power pattern must be non-negative")
    spec = np.fft.rfft(g) / resolution
    c = np.empty(2 * n_harmonics + 1, np.float64)
    c[0] = spec[0].real
    for n in range(1, n_harmonics + 1):
        c[2 * n - 1] = 2.0 * spec[n].real
        c[2 * n] = -2.0 * spec[n].imag
    if normalize:
        if c[0] <= 0:
            raise ValueError("pattern has zero mean power")
        c = c / c[0]
    return c.astype(np.float32)


def max_gain(coeffs: torch.Tensor) -> torch.Tensor:
    """An upper bound of each pattern's gain over all angles, ``sum |c|``
    over the last axis (float64): the fixed-point scales of the kernels
    allow for it."""
    return coeffs.double().abs().sum(-1)
