"""A live stream: one chunk after another through ``Streamer.process``.

Closed loop on one card. Each step builds the chunk's trace parameters
(``Engine.params``) from the listener's pose, streams one chunk of dry
audio (retrace, crossfaded convolution, ring), and copies the output
chunk to host memory. The listener walks a circle in the configuration's
``walk`` area at the traffic's speed, its start and direction drawn from
the seed; the source stands still; the dry audio is a seeded noise clip
in host memory, looped, each chunk copied to the card as a game's or a
live feed's chunk is. Answers compared: output chunks (the traffic's ``compare`` of
them, drawn from the seed among the window's chunks), each against the
plain reference's IRs of every chunk whose tail reaches it, convolved,
crossfaded and overlap-added in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import audio, philox, physics, scenes


class Driver:
    unit = "chunks"

    def __init__(self, env: harness.Env):
        self.env = env
        cfg, tr = env.config, env.traffic
        self.dev = env.devices[0]
        self.sim, self.aud = cfg["sim"], cfg["audio"]
        self.n = int(round(self.aud["sample_rate"]
                           * self.aud["chunk_duration"]))
        self.t = int(self.aud["sample_rate"] * self.aud["reverb_duration"])
        self.source = np.asarray(cfg["scene"]["source"], np.float32)
        walk = cfg["scene"]["walk"]
        rng = env.rng(1)
        self.center = np.asarray(walk["center"], np.float64)
        self.radius = float(walk["radius"])
        self.phase = float(rng.uniform(0.0, 2 * math.pi))
        turn = 1.0 if rng.integers(2) else -1.0
        self.dtheta = turn * tr["speed_m_per_s"] \
            * self.aud["chunk_duration"] / self.radius
        self.clip_chunks = int(tr["dry_chunks"])
        self.warm = int(tr["warm_chunks"])
        self.boxes = scenes.boxes_from_config(cfg["scene"])
        self.next = 0

    def pose(self, i: int) -> np.ndarray:
        a = self.phase + self.dtheta * i
        return (self.center + self.radius * np.array(
            [math.cos(a), math.sin(a)])).astype(np.float32)

    def dry_chunk(self, i: int) -> torch.Tensor:
        k = i % self.clip_chunks
        return self.dry[k * self.n:(k + 1) * self.n]

    def setup(self) -> None:
        p = self.env.port
        cfg = harness.engine_config(self.env.config)
        self.scene = harness.build_scene(self.boxes, 1, self.dev)
        self.engine = p.Engine(self.scene, cfg)
        self.streamer = p.Streamer(self.scene, cfg, seed=self.env.seed)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.env.seed)
        self.dry = (torch.rand(self.clip_chunks * self.n, generator=gen,
                               device=self.dev) - 0.5).cpu()
        for _ in range(self.warm):
            self.step()

    def step(self) -> int:
        i = self.next
        with harness.span("pose"):
            params = self.engine.params(self.source, self.pose(i))
        with harness.span("feed"):
            dry = self.dry_chunk(i).to(self.dev)
        with harness.span("step"):
            out = self.streamer.process(dry, params)
        with harness.span("readback"):
            host = out.cpu()
        self.env.sample.offer((i, host))
        self.next += 1
        return 1

    def launches(self) -> dict:
        return {"frames_ir_kernel": 1}

    def shapes(self) -> dict:
        return dict(n_rays=self.sim["ray_count"],
                    n_bounces=self.sim["max_bounces"], n_frames=1,
                    n_entries=1, n_listeners=1, n_bands=1,
                    n_walls=4 * len(self.boxes), ir_length=self.t)

    def release(self) -> None:
        del self.streamer, self.engine, self.scene

    def reference(self, keys, dtype, acc_dtype):
        """Output chunks ``keys`` of the reference (float64 ``[1, N]``)."""
        dev = self.dev
        tab = physics.tables([scenes.walls(self.boxes)], dtype, dev)
        irs, works = {}, []

        def ir_of(k):
            if k not in irs:
                pose = physics.Pose(
                    torch.as_tensor(self.source)[None],
                    torch.as_tensor(self.pose(k))[None, None],
                    self.sim["listener_radius"], self.sim["speed_of_sound"],
                    self.sim["input_gain"])
                ir, work = physics.trace_ir(
                    tab, pose, philox.mix_seed(self.env.seed, k),
                    n_rays=self.sim["ray_count"],
                    n_bounces=self.sim["max_bounces"], n_frames=1,
                    sample_rate=self.aud["sample_rate"], ir_length=self.t,
                    dtype=dtype, acc_dtype=acc_dtype)
                irs[k] = ir[0, :, :, 0]                      # [L, T]
                works.append(work)
            return irs[k]

        def dry_of(k):
            return self.dry_chunk(k).to(device=dev, dtype=torch.float64)

        out = {j: audio.output_chunk(j, self.n, self.t, dry_of, ir_of, dtype)
               for j in keys}
        work = physics.Work(sum(w.alive for w in works) / len(works),
                            sum(w.heard for w in works) / len(works))
        return out, work

    def answers(self):
        return {i: host for i, host in self.env.sample.items}

    def gaps(self, answers, reference) -> dict:
        """``out_gap`` of each compared output chunk: its largest gap from
        the reference, as a share of the reference chunk's peak."""
        out = []
        for j, ref in reference.items():
            got = torch.as_tensor(answers[j]).to(device=ref.device,
                                                 dtype=torch.float64)
            peak = float(ref.abs().max())
            out.append(float((got - ref).abs().max()) / peak if peak > 0
                       else float("inf"))
        return {"out_gap": out}
