"""Acoustic materials.

Mirrors the reference's ``AudioMaterial`` ScriptableObject
(``Assets/Script/AudioMaterial.cs:6-20``): four scalar parameters with the
same ranges and semantics —

* ``absorption`` in [0, 1]: energy fraction lost per bounce,
* ``scattering`` in [0, 1]: 0 = mirror, 1 = fully diffuse,
* ``transmission`` in [0, 1]: probability a ray passes through,
* ``ior`` in [0.01, 4]: inverse speed multiplier (medium speed = c / ior).

This rebuild additionally supports *frequency-banded absorption*
(generalizing the legacy time x frequency IR of
``Assets/Script/RaytraceOcclusion2D.compute:234-252``): a material can carry
one absorption value per band; scalar materials broadcast across bands.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


def _check01(name: str, v: float) -> None:
    if not (0.0 <= v <= 1.0):
        raise ValueError(f"{name}={v} outside [0, 1]")


@dataclass(frozen=True)
class AudioMaterial:
    absorption: float = 0.1
    scattering: float = 0.5
    transmission: float = 0.0
    ior: float = 1.0
    # Optional per-band absorption overriding the scalar (index 0 = lowest
    # band). Length must match the Scene's n_bands when used.
    band_absorption: Optional[Tuple[float, ...]] = None
    name: str = ""

    def __post_init__(self) -> None:
        _check01("absorption", self.absorption)
        _check01("scattering", self.scattering)
        _check01("transmission", self.transmission)
        if not (0.01 <= self.ior <= 4.0):  # AudioMaterial.cs:17-20 range
            raise ValueError(f"ior={self.ior} outside [0.01, 4]")
        if self.band_absorption is not None:
            for a in self.band_absorption:
                _check01("band_absorption[]", a)

    def absorption_bands(self, n_bands: int) -> np.ndarray:
        """Per-band absorption vector of length ``n_bands`` (float32)."""
        if self.band_absorption is not None:
            if len(self.band_absorption) != n_bands:
                raise ValueError(
                    f"material {self.name!r} has {len(self.band_absorption)} "
                    f"absorption bands; scene wants {n_bands}")
            return np.asarray(self.band_absorption, dtype=np.float32)
        return np.full((n_bands,), self.absorption, dtype=np.float32)

    def with_hf_rolloff(self, n_bands: int, strength: float = 1.0
                        ) -> "AudioMaterial":
        """Derive a banded material whose absorption rises with frequency:
        ``a_k = 1 - (1 - a) * exp(-strength * k / n_bands)``.

        This is the per-material generalization of the legacy kernel's
        global ``exp(-muffle * freq * MuffleScale / WindowSize)``
        high-frequency attenuation (``RaytraceOcclusion2D.compute:248``).
        """
        bands = tuple(
            float(1.0 - (1.0 - self.absorption) *
                  math.exp(-strength * k / max(1, n_bands)))
            for k in range(n_bands))
        return AudioMaterial(self.absorption, self.scattering,
                             self.transmission, self.ior, bands, self.name)


# The two shipped material assets, values verbatim from the reference
# (``Assets/Script/Material.asset:14-17`` and ``Assets/Script/Border.asset:14-17``).
MATERIAL_INTERIOR = AudioMaterial(absorption=0.148, scattering=1.0,
                                  transmission=1.0, ior=0.6,
                                  name="Material")
MATERIAL_BORDER = AudioMaterial(absorption=0.507, scattering=0.5,
                                transmission=0.271, ior=0.01,
                                name="Border")

# A fully absorbing, non-transmitting material used for padding walls; also
# handy as an anechoic boundary in tests.
MATERIAL_ANECHOIC = AudioMaterial(absorption=1.0, scattering=0.0,
                                  transmission=0.0, ior=1.0, name="Anechoic")


def material_table(materials: Sequence[AudioMaterial], n_bands: int
                   ) -> dict[str, np.ndarray]:
    """Pack a list of materials into struct-of-arrays form.

    Returns dict with ``absorption[M, n_bands]``, ``scattering[M]``,
    ``transmission[M]``, ``ior[M]`` (all float32) — the GPU-struct
    ``AudioMat`` (``Raytrace2D.compute:12-17``) as columnar arrays.
    """
    return {
        "absorption": np.stack([m.absorption_bands(n_bands)
                                for m in materials]).astype(np.float32),
        "scattering": np.asarray([m.scattering for m in materials],
                                 dtype=np.float32),
        "transmission": np.asarray([m.transmission for m in materials],
                                   dtype=np.float32),
        "ior": np.asarray([m.ior for m in materials], dtype=np.float32),
    }
