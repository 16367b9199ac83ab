"""What every traffic driver shares: the run's environment, the sample of
answers kept for the comparison, the comparison's numbers, and the
port's modules.

A driver (``benchmark/drivers/<name>.py``, named by a traffic file's
``driver``) defines ``Driver(env)`` with

* ``unit``: what a step completes (``"chunks"``, ``"calls"``, ``"rooms"``);
* ``setup()``: build the cell's scene and state on the cards and warm
  every shape the window uses;
* ``step() -> int``: one closed-loop step, call to result in host memory;
  the units it completed. Inside the window it offers its answer to
  ``env.sample``;
* ``launches() -> dict``: for each kernel (a substring of its name) the
  launches a step makes, summed over the cards: a traced reading that
  holds another number is dropped and taken again;
* ``shapes() -> dict``: the step's sizes, for the per-layer readers;
* ``release()``: drop the program's state;
* ``reference(keys, dtype, acc_dtype) -> (answers, work)``: the plain
  reference's answers for the sampled keys, and the work they needed per
  step (``reference.physics.Work``);
* ``gaps(answers, reference) -> dict``: the numbers compared, by name.
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

PORT = "realisticaudioraytracing2d_tpu_torch"
M64 = (1 << 64) - 1


def port(root: Path):
    """The measured package, imported from the checkout at ``root``."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    return importlib.import_module(PORT)


def port_module(name: str):
    return importlib.import_module(f"{PORT}.{name}")


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


class Sample:
    """A seeded reservoir of ``k`` answers from a stream of unknown length
    (algorithm R): each answer offered in the window is kept with the same
    chance, and a seed names the same sample of a run of the same
    length."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed & M64, 0x5A3D])
        self.items: List[Any] = []
        self.seen = 0
        self.active = False

    def offer(self, item) -> bool:
        """Keep ``item`` or not; True when kept."""
        if not self.active:
            return False
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return True
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item
            return True
        return False


class Env:
    """One run: the checkout's root, the cell's configuration and traffic
    (parsed JSON), the seed, the devices (one per chip), whether they are
    cards, and the sample of answers."""

    def __init__(self, root: Path, cell: str, config: Dict, traffic: Dict,
                 seed: int, devices: list, card: bool):
        self.root = root
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.seed = int(seed) & M64
        self.devices = devices
        self.card = card
        self.sample = Sample(int(traffic.get("compare", 1)), self.seed)
        self.port = port(root)

    def rng(self, *tag: int) -> np.random.Generator:
        """A numpy generator for one purpose of this run."""
        return np.random.default_rng([self.seed, *tag])


def sync(devices) -> None:
    import torch
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def span(name: str):
    """A profiler span of the benchmark's own around a call into a layer
    (``bench.<name>``)."""
    import torch
    return torch.profiler.record_function(f"bench.{name}")


def engine_config(cfg: Dict):
    """The program's ``EngineConfig`` of a configuration file's ``sim`` and
    ``audio``."""
    c = port_module("config")
    sim, audio = cfg["sim"], cfg["audio"]
    return c.EngineConfig(
        sim=c.SimConfig(ray_count=sim["ray_count"],
                        max_bounces=sim["max_bounces"],
                        speed_of_sound=sim["speed_of_sound"],
                        listener_radius=sim["listener_radius"],
                        input_gain=sim["input_gain"],
                        n_bands=sim.get("n_bands", 1)),
        audio=c.AudioConfig(sample_rate=audio["sample_rate"],
                            reverb_duration=audio["reverb_duration"],
                            chunk_duration=audio["chunk_duration"]))


def build_scene(boxes, n_bands: int, device, pad_to: Optional[int] = None):
    """The program's scene of ``boxes`` (``reference.scenes.Box``), made
    through its public builder."""
    scene_mod = port_module("models.scene")
    mats = port_module("models.materials")
    b = scene_mod.SceneBuilder(n_bands=n_bands)
    for box in boxes:
        m = box.material
        b.add_box(mats.AudioMaterial(absorption=m.absorption,
                                     scattering=m.scattering,
                                     transmission=m.transmission, ior=m.ior),
                  scene_mod.Transform2D(tuple(box.position), box.angle,
                                        tuple(box.scale)),
                  size=tuple(box.size))
    return b.build(pad_to=pad_to, device=device)
