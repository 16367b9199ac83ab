"""Scene representation and builders (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/models/scene.py``. The data
contract is the same: each wall is a segment with start, end, outward
normal and an acoustic material, stored as a struct-of-arrays
:class:`Scene` of tensors with a padded wall count. The collider
flattening (``SceneHelper.cs:29-98`` of the reference) runs in numpy
exactly as in the JAX package, so the arrays match it bit for bit; only
the final upload builds torch tensors, on an explicit device.

Padding walls are degenerate (``a == b``) with ``absorption = 1`` and
``ior = 1``, so the intersection math returns INF for them and no
division by a zero speed can occur.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve
from .materials import AudioMaterial

CIRCLE_RESOLUTION = 32  # SceneHelper.cs:26


@dataclass(frozen=True)
class Transform2D:
    """Position + rotation + scale, the 2D restriction of a Unity transform:
    world = position + R(angle) @ (scale * p)."""

    position: Tuple[float, float] = (0.0, 0.0)
    angle: float = 0.0  # radians, counter-clockwise
    scale: Tuple[float, float] = (1.0, 1.0)

    def transform_point(self, p: np.ndarray) -> np.ndarray:
        c, s = math.cos(self.angle), math.sin(self.angle)
        x = p[..., 0] * self.scale[0]
        y = p[..., 1] * self.scale[1]
        return np.stack(
            [c * x - s * y + self.position[0],
             s * x + c * y + self.position[1]], axis=-1)

    @property
    def winding(self) -> float:
        """Normal-flip sign for mirrored scales (``SceneHelper.cs:80-81``)."""
        return math.copysign(1.0, self.scale[0] * self.scale[1])


class Scene(NamedTuple):
    """Struct-of-arrays edge soup. All fields are float32 tensors except
    ``mask`` (bool), all on one device. ``W`` is the (padded) wall count,
    ``K`` the band count."""

    a: torch.Tensor             # [W, 2] segment start
    b: torch.Tensor             # [W, 2] segment end
    normal: torch.Tensor        # [W, 2] outward normal (winding-signed)
    absorption: torch.Tensor    # [W, K]
    scattering: torch.Tensor    # [W]
    transmission: torch.Tensor  # [W]
    ior: torch.Tensor           # [W]
    mask: torch.Tensor          # [W] bool: True = real wall

    @property
    def n_walls(self) -> int:
        return self.a.shape[-2]

    @property
    def n_bands(self) -> int:
        return self.absorption.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.a.device

    @property
    def n_valid(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum(-1)

    def to(self, device) -> "Scene":
        """The same scene with every field on ``device``."""
        return Scene(*(x.to(device) for x in self))

    def pad_to(self, n: int) -> "Scene":
        """Pad the wall axis to ``n`` with inert degenerate segments."""
        w = self.n_walls
        if n < w:
            raise ValueError(f"pad_to({n}) smaller than wall count {w}")
        if n == w:
            return self
        pad = n - w

        def pad_rows(x, fill):
            tail = torch.full((pad,) + tuple(x.shape[1:]), fill,
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], dim=0)

        return Scene(
            a=pad_rows(self.a, 0.0), b=pad_rows(self.b, 0.0),
            normal=pad_rows(self.normal, 0.0),
            absorption=pad_rows(self.absorption, 1.0),
            scattering=pad_rows(self.scattering, 0.0),
            transmission=pad_rows(self.transmission, 0.0),
            ior=pad_rows(self.ior, 1.0),
            mask=pad_rows(self.mask, False))

    def concat(self, other: "Scene",
               pad_to: Optional[int] = None) -> "Scene":
        """Merge two edge soups (static room + moving geometry): valid walls
        are compacted to the front, then padded to ``pad_to`` (default: the
        sum of both padded sizes). Band counts must match."""
        if self.n_bands != other.n_bands:
            raise ValueError(
                f"band mismatch: {self.n_bands} vs {other.n_bands}")
        m1, m2 = self.mask, other.mask.to(self.device)
        merged = Scene(*(torch.cat([x1[m1], x2.to(self.device)[m2]], dim=0)
                         for x1, x2 in zip(self, other)))
        return merged.pad_to(pad_to if pad_to is not None
                             else self.n_walls + other.n_walls)

    @staticmethod
    def stack(scenes: Sequence["Scene"]) -> "Scene":
        """Batch scenes along a leading axis (they must share W and K):
        the room dataset of a sweep, ``[E, W, ...]`` per field."""
        return Scene(*(torch.stack(xs) for xs in zip(*scenes)))

    def row(self, i) -> "Scene":
        """Scene ``i`` of a stacked batch (the JAX sweep's
        ``_index_scene``); a slice keeps the batch axis."""
        return Scene(*(x[i] for x in self))


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def loop_segments(points: np.ndarray, transform: Transform2D):
    """Flatten one closed loop of local-space points under a transform
    into ``(starts, ends, normals)`` world-space arrays
    (``SceneHelper.cs:78-98`` semantics)."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2 or len(pts) < 2:
        raise ValueError("loop needs [N>=2, 2] points")
    winding = transform.winding
    world = transform.transform_point(pts)
    starts = world
    ends = np.roll(world, -1, axis=0)
    d = ends - starts
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    dirv = np.where(norm > 0, d / np.where(norm > 0, norm, 1.0), 0.0)
    normals = np.stack([dirv[:, 1], -dirv[:, 0]], axis=-1) * winding
    return starts, ends, normals


@dataclass(frozen=True)
class ColliderRecord:
    """One builder collider: its recipe (local loops + material + authored
    transform) and its wall span in the flattened scene, so it can be
    re-flattened under a new transform (:meth:`SceneBuilder.move_collider`)."""

    name: Optional[str]
    kind: str                    # box / circle / polygon / loop / segment
    material: AudioMaterial
    transform: Transform2D
    loops: Optional[Tuple[np.ndarray, ...]]  # local points; None = raw seg
    start: int                   # first wall row
    count: int                   # wall rows


class SceneBuilder:
    """Host-side accumulation of wall segments, then one device upload
    (``SceneToData2D.GetSegmentsFromColliders``, ``SceneHelper.cs:29-76``)."""

    def __init__(self, n_bands: int = 1):
        self.n_bands = int(n_bands)
        self._starts: List[np.ndarray] = []
        self._ends: List[np.ndarray] = []
        self._normals: List[np.ndarray] = []
        self._mats: List[AudioMaterial] = []
        self.colliders: List[ColliderRecord] = []

    def _flatten_loop(self, points: np.ndarray, material: AudioMaterial,
                      transform: Transform2D) -> None:
        starts, ends, normals = loop_segments(points, transform)
        for p1, p2, nrm in zip(starts, ends, normals):
            self._starts.append(p1)
            self._ends.append(p2)
            self._normals.append(nrm)
            self._mats.append(material)

    def _record(self, name, kind, material, transform, loops,
                start: int) -> None:
        self.colliders.append(ColliderRecord(
            name=name, kind=kind, material=material, transform=transform,
            loops=(tuple(np.asarray(p, np.float64) for p in loops)
                   if loops is not None else None),
            start=start, count=len(self._starts) - start))

    def add_loop(self, points: np.ndarray, material: AudioMaterial,
                 transform: Transform2D = Transform2D(),
                 name: Optional[str] = None) -> "SceneBuilder":
        pts = np.asarray(points, dtype=np.float64)
        start = len(self._starts)
        self._flatten_loop(pts, material, transform)
        self._record(name, "loop", material, transform, [pts], start)
        return self

    def add_box(self, material: AudioMaterial,
                transform: Transform2D = Transform2D(),
                size: Tuple[float, float] = (1.0, 1.0),
                offset: Tuple[float, float] = (0.0, 0.0),
                name: Optional[str] = None) -> "SceneBuilder":
        """BoxCollider2D flattening (``SceneHelper.cs:49-57``)."""
        hx, hy = size[0] * 0.5, size[1] * 0.5
        ox, oy = offset
        corners = np.array([[ox - hx, oy - hy], [ox + hx, oy - hy],
                            [ox + hx, oy + hy], [ox - hx, oy + hy]])
        start = len(self._starts)
        self._flatten_loop(corners, material, transform)
        self._record(name, "box", material, transform, [corners], start)
        return self

    def add_circle(self, material: AudioMaterial,
                   transform: Transform2D = Transform2D(),
                   radius: float = 0.5,
                   offset: Tuple[float, float] = (0.0, 0.0),
                   resolution: int = CIRCLE_RESOLUTION,
                   name: Optional[str] = None) -> "SceneBuilder":
        """CircleCollider2D flattening (``SceneHelper.cs:59-68``)."""
        ang = np.arange(resolution) / resolution * 2.0 * np.pi
        pts = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * radius
        pts = pts + np.asarray(offset)
        start = len(self._starts)
        self._flatten_loop(pts, material, transform)
        self._record(name, "circle", material, transform, [pts], start)
        return self

    def add_polygon(self, paths: Sequence[np.ndarray],
                    material: AudioMaterial,
                    transform: Transform2D = Transform2D(),
                    name: Optional[str] = None) -> "SceneBuilder":
        """PolygonCollider2D flattening: one loop per path
        (``SceneHelper.cs:41-47``)."""
        start = len(self._starts)
        paths = [np.asarray(p, np.float64) for p in paths]
        for path in paths:
            self._flatten_loop(path, material, transform)
        self._record(name, "polygon", material, transform, paths, start)
        return self

    def add_segment(self, start, end, normal, material: AudioMaterial,
                    name: Optional[str] = None) -> "SceneBuilder":
        """Raw segment (explicit normal, no winding logic, not steerable)."""
        row = len(self._starts)
        self._starts.append(np.asarray(start, dtype=np.float64))
        self._ends.append(np.asarray(end, dtype=np.float64))
        self._normals.append(np.asarray(normal, dtype=np.float64))
        self._mats.append(material)
        self._record(name, "segment", material, Transform2D(), None, row)
        return self

    def find_collider(self, obstacle) -> ColliderRecord:
        """Resolve a collider by name (str) or build-order index (int)."""
        if isinstance(obstacle, str):
            for c in self.colliders:
                if c.name == obstacle:
                    return c
            known = [c.name for c in self.colliders if c.name is not None]
            raise KeyError(f"unknown obstacle {obstacle!r}; "
                           f"named colliders: {known}")
        idx = int(obstacle)
        if not 0 <= idx < len(self.colliders):
            raise KeyError(f"obstacle index {idx} out of range "
                           f"(0..{len(self.colliders) - 1})")
        return self.colliders[idx]

    def move_collider(self, scene: Scene, obstacle,
                      position=None, angle=None) -> Scene:
        """Re-flatten ONE collider of a built scene under a new
        position/angle (scale and shape unchanged, so the padded wall
        count is unchanged). Unspecified fields fall back to the authored
        transform. Returns a new :class:`Scene` on the scene's device; the
        builder record is not mutated."""
        c = self.find_collider(obstacle)
        if c.loops is None:
            raise ValueError(
                f"collider {obstacle!r} is a raw segment (no transform); "
                "not steerable")
        tf = Transform2D(
            position=(tuple(float(v) for v in position)
                      if position is not None else c.transform.position),
            angle=(float(angle) if angle is not None
                   else c.transform.angle),
            scale=c.transform.scale)
        parts = [loop_segments(pts, tf) for pts in c.loops]
        rows = slice(c.start, c.start + c.count)

        def replaced(field, k):
            new = np.concatenate([p[k] for p in parts]).astype(np.float32)
            out = field.clone()
            out[rows] = torch.from_numpy(new).to(field.device)
            return out

        return scene._replace(a=replaced(scene.a, 0),
                              b=replaced(scene.b, 1),
                              normal=replaced(scene.normal, 2))

    def __len__(self) -> int:
        return len(self._starts)

    def build(self, pad_to: Optional[int] = None, pad_multiple: int = 8,
              device=None) -> Scene:
        """Produce the Scene on ``device`` (default: the package's
        :data:`..device.DEFAULT_DEVICE`). Walls are padded to ``pad_to`` if
        given, else to the next multiple of ``pad_multiple``."""
        n = len(self._starts)
        if n == 0:
            raise ValueError("empty scene")
        total = pad_to if pad_to is not None else round_up(n, pad_multiple)
        if total < n:
            raise ValueError(f"pad_to={pad_to} < wall count {n}")

        k = self.n_bands
        a = np.zeros((total, 2), np.float32)
        b = np.zeros((total, 2), np.float32)
        nrm = np.zeros((total, 2), np.float32)
        absb = np.ones((total, k), np.float32)
        scat = np.zeros((total,), np.float32)
        trans = np.zeros((total,), np.float32)
        ior = np.ones((total,), np.float32)
        mask = np.zeros((total,), bool)

        a[:n] = np.asarray(self._starts, np.float32)
        b[:n] = np.asarray(self._ends, np.float32)
        nrm[:n] = np.asarray(self._normals, np.float32)
        for i, m in enumerate(self._mats):
            absb[i] = m.absorption_bands(k)
            scat[i] = m.scattering
            trans[i] = m.transmission
            ior[i] = m.ior
        mask[:n] = True

        device = resolve(device)
        return Scene(*(torch.from_numpy(x).to(device)
                       for x in (a, b, nrm, absb, scat, trans, ior, mask)))



def scene_from_boxes(boxes: Sequence[Tuple[Transform2D, AudioMaterial]],
                     n_bands: int = 1, pad_to: Optional[int] = None,
                     device=None) -> Scene:
    """A scene made of unit boxes under per-box transforms, the way the
    reference rooms are authored (a unit BoxCollider2D scaled and rotated
    by its GameObject's transform, SmollRoom.unity), on ``device``."""
    builder = SceneBuilder(n_bands=n_bands)
    for tf, mat in boxes:
        builder.add_box(mat, tf)
    return builder.build(pad_to=pad_to, device=device)
