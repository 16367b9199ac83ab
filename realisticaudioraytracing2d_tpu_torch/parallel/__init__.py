"""Batched traces on one device: the room-dataset sweep and the
multi-source mixdown, both through the rooms-batched kernel (K9)."""

from . import multisource, sweep  # noqa: F401
