"""Batched and mesh-sharded traces: the room-dataset sweep and the
multi-source mixdown through the rooms-batched kernel (K9), and the
device-mesh paths (:mod:`.mesh`): rooms, sources, rays, frames and audio
time split over the axes of a mesh of ``torch.device``s."""

from . import frames, mesh, multisource, rays, seq, sweep  # noqa: F401
