"""Scenes of the benchmark: the draws that make them, and the walls.

A scene is a list of boxes. A box is a rectangle of ``size`` centred on
its local origin, scaled, rotated by ``angle`` (radians, counter-clockwise)
and moved to ``position``: world = position + R(angle) (scale * p), as a
Unity BoxCollider2D under its GameObject's transform. Each box gives four
walls, one per edge, with the outward normal (flipped for a mirrored
scale). The harness draws the boxes here, from the seed, hands them to the
program through its public builders and, after the window, to the plain
reference (:func:`walls`), which flattens them itself.

``rooms`` draws the numbers of the sweep's room generator in its order
(a numpy ``default_rng`` per seed), so a seed names one batch of rooms.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np


class Material(NamedTuple):
    absorption: float
    scattering: float
    transmission: float
    ior: float


class Box(NamedTuple):
    position: Tuple[float, float]
    angle: float
    scale: Tuple[float, float]
    size: Tuple[float, float]
    material: Material


def material(spec: dict) -> Material:
    return Material(float(spec["absorption"]), float(spec["scattering"]),
                    float(spec["transmission"]), float(spec["ior"]))


def boxes_from_config(scene: dict) -> List[Box]:
    """The boxes a configuration file lists (``scene.boxes``), each naming
    one of its ``scene.materials``."""
    mats = {k: material(v) for k, v in scene["materials"].items()}
    return [Box(tuple(b["position"]), float(b["angle"]),
                tuple(b.get("scale", (1.0, 1.0))),
                tuple(b.get("size", (1.0, 1.0))), mats[b["material"]])
            for b in scene["boxes"]]


def rooms(n_rooms: int, seed: int, n_obstacles: int = 3
          ) -> Tuple[List[List[Box]], np.ndarray, np.ndarray]:
    """Shoebox rooms of random size and materials with ``n_obstacles``
    random boxes inside, and a source and a listener in each:
    ``(boxes of each room, sources [n, 2], listeners [n, 2])``."""
    rng = np.random.default_rng(seed)
    all_boxes, sources, listeners = [], [], []
    for _ in range(n_rooms):
        w = float(rng.uniform(15.0, 60.0))
        h = float(rng.uniform(10.0, 40.0))
        wall = Material(float(rng.uniform(0.05, 0.7)),
                        float(rng.uniform(0.0, 1.0)),
                        float(rng.uniform(0.0, 0.4)),
                        float(rng.uniform(0.01, 1.0)))
        t = 1.0
        hw, hh = w / 2, h / 2
        boxes = [Box((0, hh + t / 2), 0, (w + 2 * t, t), (1.0, 1.0), wall),
                 Box((0, -hh - t / 2), 0, (w + 2 * t, t), (1.0, 1.0), wall),
                 Box((-hw - t / 2, 0), 0, (t, h), (1.0, 1.0), wall),
                 Box((hw + t / 2, 0), 0, (t, h), (1.0, 1.0), wall)]
        for _ in range(n_obstacles):
            mat = Material(float(rng.uniform(0.05, 0.9)),
                           float(rng.uniform(0.0, 1.0)),
                           float(rng.uniform(0.0, 1.0)),
                           float(rng.uniform(0.1, 2.0)))
            position = (float(rng.uniform(-w / 3, w / 3)),
                        float(rng.uniform(-h / 3, h / 3)))
            angle = float(rng.uniform(0, np.pi))
            scale = (float(rng.uniform(1.0, w / 4)),
                     float(rng.uniform(0.5, 2.0)))
            boxes.append(Box(position, angle, scale, (1.0, 1.0), mat))
        all_boxes.append(boxes)
        sources.append([rng.uniform(-w / 2.5, w / 2.5),
                        rng.uniform(-h / 2.5, h / 2.5)])
        listeners.append([rng.uniform(-w / 2.5, w / 2.5),
                          rng.uniform(-h / 2.5, h / 2.5)])
    return (all_boxes, np.asarray(sources, np.float32),
            np.asarray(listeners, np.float32))


class Walls(NamedTuple):
    """Wall segments of one scene as float32 numpy arrays: start ``a``,
    end ``b``, outward normal ``[W, 2]``; absorption ``[W, K]``;
    scattering, transmission, ior ``[W]``."""

    a: np.ndarray
    b: np.ndarray
    normal: np.ndarray
    absorption: np.ndarray
    scattering: np.ndarray
    transmission: np.ndarray
    ior: np.ndarray


def walls(boxes: List[Box], n_bands: int = 1) -> Walls:
    """The four walls of every box, in box order and edge order (from the
    corner at -x, -y counter-clockwise in local space)."""
    corners = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]])
    size = np.array([b.size for b in boxes], np.float64)[:, None, :]
    local = corners[None] * size                               # [N, 4, 2]
    scale = np.array([b.scale for b in boxes], np.float64)
    pos = np.array([b.position for b in boxes], np.float64)
    cos = np.array([math.cos(b.angle) for b in boxes])[:, None]
    sin = np.array([math.sin(b.angle) for b in boxes])[:, None]
    x = local[..., 0] * scale[:, 0:1]
    y = local[..., 1] * scale[:, 1:2]
    world = np.stack([cos * x - sin * y + pos[:, 0:1],
                      sin * x + cos * y + pos[:, 1:2]], axis=-1)
    ends = np.roll(world, -1, axis=1)
    d = ends - world
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    unit = np.where(norm > 0, d / np.where(norm > 0, norm, 1.0), 0.0)
    winding = np.sign(scale[:, 0] * scale[:, 1])[:, None, None]
    normal = np.stack([unit[..., 1], -unit[..., 0]], axis=-1) * winding
    mats = [b.material for b in boxes]

    def per_wall(values):
        return np.repeat(np.asarray(values, np.float32), 4)

    absorption = np.repeat(per_wall([m.absorption for m in mats])[:, None],
                           n_bands, axis=1)
    return Walls(world.reshape(-1, 2).astype(np.float32),
                 ends.reshape(-1, 2).astype(np.float32),
                 normal.reshape(-1, 2).astype(np.float32), absorption,
                 per_wall([m.scattering for m in mats]),
                 per_wall([m.transmission for m in mats]),
                 per_wall([m.ior for m in mats]))
