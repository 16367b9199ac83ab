"""The port's default device.

Every builder of the package (rooms, scenes, trace parameters, IR and
stream state, random numbers, the converters and the sweep inputs) takes
``device=None`` and resolves it here, so a caller who names no device
gets the card. On a machine without CUDA, torch raises for it ("Torch not
compiled with CUDA enabled"): nothing quietly builds on the CPU. The CPU
tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """``device``, or :data:`DEFAULT_DEVICE` when it is ``None``."""
    return torch.device(DEFAULT_DEVICE if device is None else device)
