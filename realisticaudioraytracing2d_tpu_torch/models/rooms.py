"""Reference room fixtures (PyTorch).

Port of ``realisticaudioraytracing2d_tpu/models/rooms.py``:
``smoll_room()`` / ``big_room()`` reproduce the two shipped Unity scenes
wall-for-wall (``Assets/Scenes/SmollRoom.unity``, ``Big Room.unity``),
``sample_scene()`` the repaired SampleScene and ``shoebox_room()`` a
rectangular room, ``random_rooms()`` the procedural room dataset of the
sweep and ``city_scene()`` the large scene of the cluster kernels K7/K8.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..device import resolve
from .materials import MATERIAL_BORDER, MATERIAL_INTERIOR, AudioMaterial
from .scene import Scene, SceneBuilder, Transform2D


class RoomSetup(NamedTuple):
    """A scene plus the source/listener poses it ships with."""

    scene: Scene
    source: np.ndarray       # [2]
    listener: np.ndarray     # [2]
    listener_radius: float
    directivity: np.ndarray | None = None
    mic_directivity: np.ndarray | None = None
    # the SceneBuilder that flattened the scene (collider records for
    # SceneBuilder.move_collider)
    builder: "SceneBuilder | None" = None


def _quat_z_angle(z: float, w: float) -> float:
    """Angle (radians, CCW) of a Unity quaternion rotating about +z."""
    return 2.0 * math.atan2(z, w)


def _bands(mat: AudioMaterial, n_bands: int) -> AudioMaterial:
    """Expand a scalar reference material to n_bands with a mild
    high-frequency rolloff (identity when n_bands == 1)."""
    if n_bands == 1:
        return mat
    return mat.with_hf_rolloff(n_bands, strength=1.0)


def smoll_room(n_bands: int = 1, pad_to: Optional[int] = None,
               device=None) -> RoomSetup:
    """SmollRoom.unity: 5 scaled unit boxes forming a room. Source
    (-18, 9), listener (0, -3.68), listenerRadius 0.5."""
    slant = _quat_z_angle(0.47792548, 0.8784004)
    b = SceneBuilder(n_bands=n_bands)
    border = _bands(MATERIAL_BORDER, n_bands)
    interior = _bands(MATERIAL_INTERIOR, n_bands)
    b.add_box(border, Transform2D((0.0, 10.0), 0.0, (100.0, 1.0)),
              name="Wall")
    b.add_box(border, Transform2D((0.01, -5.0), 0.0, (100.0, 1.0)),
              name="Wall (1)")
    b.add_box(border, Transform2D((-20.0, 0.0), math.pi / 2, (20.0, 1.0)),
              name="Wall (2)")
    b.add_box(border, Transform2D((20.0, 0.0), math.pi / 2, (20.0, 1.0)),
              name="Wall (3)")
    b.add_box(interior, Transform2D((-11.8, 7.18), slant, (100.0, 1.0)),
              name="Wall (4)")
    return RoomSetup(scene=b.build(pad_to=pad_to, device=device),
                     source=np.array([-18.0, 9.0], np.float32),
                     listener=np.array([0.0, -3.68], np.float32),
                     listener_radius=0.5, builder=b)


def big_room(n_bands: int = 1, pad_to: Optional[int] = None,
             device=None) -> RoomSetup:
    """Big Room.unity: same topology 10x scaled (plus a thicker slant
    wall). Source (-183.8, 87.1), listener (0, -3.68), radius 0.5; its
    config needs ``input_gain=100`` (``config.big_room_config``)."""
    slant = _quat_z_angle(0.47792548, 0.8784004)
    b = SceneBuilder(n_bands=n_bands)
    border = _bands(MATERIAL_BORDER, n_bands)
    interior = _bands(MATERIAL_INTERIOR, n_bands)
    b.add_box(border, Transform2D((0.0, 100.0), 0.0, (1000.0, 1.0)),
              name="Wall")
    b.add_box(border, Transform2D((0.01, -50.0), 0.0, (1000.0, 1.0)),
              name="Wall (1)")
    b.add_box(border, Transform2D((-200.0, 0.0), math.pi / 2,
                                  (200.0, 1.0)), name="Wall (2)")
    b.add_box(border, Transform2D((200.0, 0.0), math.pi / 2,
                                  (200.0, 1.0)), name="Wall (3)")
    b.add_box(interior, Transform2D((-118.8, 71.8), slant,
                                    (1000.0, 10.0)), name="Wall (4)")
    return RoomSetup(scene=b.build(pad_to=pad_to, device=device),
                     source=np.array([-183.8, 87.1], np.float32),
                     listener=np.array([0.0, -3.68], np.float32),
                     listener_radius=0.5, builder=b)


def sample_scene(n_bands: int = 1, pad_to: Optional[int] = None,
                 device=None) -> RoomSetup:
    """SampleScene.unity, repaired: the open 3-wall scene with every wall
    on the Border material (see the JAX package's docstring)."""
    slant = _quat_z_angle(0.6239737, 0.7814454)
    b = SceneBuilder(n_bands=n_bands)
    border = _bands(MATERIAL_BORDER, n_bands)
    b.add_box(border, Transform2D((-0.09, 14.12), 0.0, (27.576956, 1.0)),
              name="Wall")
    b.add_box(border, Transform2D((0.01, -11.72), 0.0, (38.184124, 1.0)),
              name="Wall (1)")
    b.add_box(border, Transform2D((-16.62, 1.34), slant,
                                  (27.576956, 1.0)), name="Wall (2)")
    return RoomSetup(scene=b.build(pad_to=pad_to, device=device),
                     source=np.array([0.07, 10.01], np.float32),
                     listener=np.array([0.0, -3.68], np.float32),
                     listener_radius=0.5, builder=b)


def shoebox_room(width: float, height: float,
                 wall_material: AudioMaterial = MATERIAL_BORDER,
                 n_bands: int = 1, pad_to: Optional[int] = None,
                 obstacles: Optional[list] = None, device=None) -> Scene:
    """A rectangular room centered at the origin; walls are four thin
    boxes just outside the interior. ``obstacles`` is a list of
    (Transform2D, material)."""
    t = 1.0  # wall thickness
    b = SceneBuilder(n_bands=n_bands)
    hw, hh = width / 2, height / 2
    b.add_box(wall_material, Transform2D((0, hh + t / 2), 0, (width + 2 * t, t)))
    b.add_box(wall_material, Transform2D((0, -hh - t / 2), 0, (width + 2 * t, t)))
    b.add_box(wall_material, Transform2D((-hw - t / 2, 0), 0, (t, height)))
    b.add_box(wall_material, Transform2D((hw + t / 2, 0), 0, (t, height)))
    for tf, mat in (obstacles or []):
        b.add_box(mat, tf)
    return b.build(pad_to=pad_to, device=device)


def random_rooms(n_rooms: int, seed: int = 0, n_obstacles: int = 3,
                 n_bands: int = 1, device=None
                 ) -> Tuple[Scene, np.ndarray, np.ndarray]:
    """A batch of shoebox rooms with random interior box obstacles,
    materials and source/listener placements (BASELINE.json config #5).

    Returns ``(scenes, sources[n_rooms, 2], listeners[n_rooms, 2])`` where
    ``scenes`` is a stacked :class:`Scene` (leading axis ``n_rooms``, every
    room padded to ``4 * (4 + n_obstacles)`` walls). The numpy draws are
    the JAX package's in the same order, so for one seed the arrays equal
    its ``random_rooms`` bit for bit. The rooms are built on the host and
    uploaded to ``device`` in one copy per field."""
    rng = np.random.default_rng(seed)
    wall_count = 4 * (4 + n_obstacles)
    scenes, sources, listeners = [], [], []
    for _ in range(n_rooms):
        w = float(rng.uniform(15.0, 60.0))
        h = float(rng.uniform(10.0, 40.0))
        wall_mat = AudioMaterial(
            absorption=float(rng.uniform(0.05, 0.7)),
            scattering=float(rng.uniform(0.0, 1.0)),
            transmission=float(rng.uniform(0.0, 0.4)),
            ior=float(rng.uniform(0.01, 1.0)), name="wall")
        obstacles = []
        for _ in range(n_obstacles):
            mat = AudioMaterial(
                absorption=float(rng.uniform(0.05, 0.9)),
                scattering=float(rng.uniform(0.0, 1.0)),
                transmission=float(rng.uniform(0.0, 1.0)),
                ior=float(rng.uniform(0.1, 2.0)), name="obstacle")
            tf = Transform2D(
                position=(float(rng.uniform(-w / 3, w / 3)),
                          float(rng.uniform(-h / 3, h / 3))),
                angle=float(rng.uniform(0, np.pi)),
                scale=(float(rng.uniform(1.0, w / 4)),
                       float(rng.uniform(0.5, 2.0))))
            obstacles.append((tf, mat))
        scenes.append(shoebox_room(w, h, wall_mat, n_bands=n_bands,
                                   pad_to=wall_count, obstacles=obstacles,
                                   device="cpu"))
        sources.append([rng.uniform(-w / 2.5, w / 2.5),
                        rng.uniform(-h / 2.5, h / 2.5)])
        listeners.append([rng.uniform(-w / 2.5, w / 2.5),
                          rng.uniform(-h / 2.5, h / 2.5)])
    return (Scene.stack(scenes).to(resolve(device)),
            np.asarray(sources, np.float32),
            np.asarray(listeners, np.float32))


def city_scene(n_boxes: int = 2500, seed: int = 0, extent: float = 500.0,
               n_bands: int = 1, device=None) -> RoomSetup:
    """Large-scene fixture: a bordered 'city' of randomly placed and
    rotated box obstacles, ``4 * n_boxes + 4`` walls (padded to a multiple
    of 8). It exercises the cluster-early-out path (``ops/accel.py``,
    ``ops/cuda/accel_kernel.py``) at wall counts far beyond the
    reference's scenes. The numpy draws are the JAX package's in the same
    order, so for one seed the arrays equal its ``city_scene`` bit for
    bit."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(n_bands=n_bands)
    border = _bands(MATERIAL_BORDER, n_bands)
    interior = _bands(MATERIAL_INTERIOR, n_bands)
    b.add_box(border, Transform2D(position=(0.0, 0.0), scale=(1.0, 1.0)),
              size=(2 * extent, 2 * extent))
    for _ in range(n_boxes):
        tf = Transform2D(
            position=(float(rng.uniform(-extent * 0.95, extent * 0.95)),
                      float(rng.uniform(-extent * 0.95, extent * 0.95))),
            angle=float(rng.uniform(0, np.pi)))
        b.add_box(interior, tf,
                  size=(float(rng.uniform(1.0, 8.0)),
                        float(rng.uniform(1.0, 8.0))))
    return RoomSetup(scene=b.build(device=device),
                     source=np.asarray([0.0, 0.0], np.float32),
                     listener=np.asarray([extent * 0.2, extent * 0.1],
                                         np.float32),
                     listener_radius=2.0, builder=b)
