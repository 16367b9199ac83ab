"""A headphone stream with per-arrival Doppler: one chunk after another
through ``Streamer.process`` of a binaural streamer, given the head's
facing and the dry history window every chunk (the "composed" stream).

Closed loop on one card. Each step builds the chunk's trace parameters
(``Engine.params``) from the head's pose and streams one chunk: the
three-microphone capture, the decode to two ears, the per-arrival taps
with their glides, the residual's crossfaded convolution and the ring;
then the two ears' output chunk is copied to host memory. The head walks
a circle in the configuration's ``walk`` area at the traffic's speed (its
start and direction drawn from the seed, as ``stream.py``'s listener),
facing where it walks plus a look-around of ``turn_rad`` times ``sin(2 pi
t / turn_period_s)`` at the chunk's audio time ``t``; the source stands
still. The dry audio is a seeded noise clip on the card (per-arrival
Doppler reads its history there), looped. Answers compared: output
chunks (the traffic's ``compare`` of them, drawn from the seed among the
window's chunks), each against the plain reference
(``reference/binaural.py``, ``reference/arrivals.py``): the captures of
every chunk whose tail reaches it, their taps and residuals, in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers import stream
from benchmark.reference import arrivals, binaural, philox, physics, scenes


class Driver(stream.Driver):
    unit = "chunks"

    def __init__(self, env: harness.Env):
        super().__init__(env)
        cfg, tr = env.config, env.traffic
        self.head = cfg["binaural"]
        self.arrival = cfg["arrival"]
        self.turn_rad = float(tr["turn_rad"])
        self.turn_period_s = float(tr["turn_period_s"])
        sr = self.aud["sample_rate"]
        early = min(self.t, int(round(self.arrival["window_s"] * sr)))
        self.wd = self.n + early + 2        # the dry history a chunk reads

    def facing(self, i: int) -> float:
        """Radians: the walking direction (the circle's tangent) plus the
        look-around at chunk ``i``'s audio time."""
        walk = self.phase + self.dtheta * i + math.copysign(math.pi / 2,
                                                            self.dtheta)
        t = i * self.aud["chunk_duration"]
        return walk + self.turn_rad * math.sin(2 * math.pi * t
                                               / self.turn_period_s)

    def setup(self) -> None:
        p = self.env.port
        cfg = harness.engine_config(self.env.config)
        self.window_scalars = harness.port_module("streaming").window_scalars
        self.scene = harness.build_scene(self.boxes, 1, self.dev)
        self.engine = p.Engine(self.scene, cfg)
        self.streamer = p.Streamer(
            self.scene, cfg, seed=self.env.seed, binaural=True,
            head_radius=self.head["head_radius"],
            shadow=self.head["shadow"],
            decorrelate=self.head["decorrelate"],
            arrival_taps=self.arrival["taps"],
            arrival_window_s=self.arrival["window_s"],
            arrival_match_bins=self.arrival["match_bins"])
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.env.seed)
        self.dry = torch.rand(self.clip_chunks * self.n, generator=gen,
                              device=self.dev) - 0.5
        for _ in range(self.warm):
            self.step()

    def step(self) -> int:
        i = self.next
        total = self.dry.shape[-1]
        with harness.span("pose"):
            params = self.engine.params(self.source, self.pose(i))
            window = (self.dry, *self.window_scalars(
                i, self.n, self.wd, total, True, None), True)
        with harness.span("step"):
            out = self.streamer.process(self.dry_chunk(i), params,
                                        facing=self.facing(i),
                                        window=window)
        with harness.span("readback"):
            host = out.cpu()
        self.env.sample.offer((i, host))
        self.next += 1
        return 1

    def shapes(self) -> dict:
        return {**super().shapes(), "n_listeners": len(binaural.PATTERNS)}

    def reference(self, keys, dtype, acc_dtype):
        """Output chunks ``keys`` of the reference (``[2, N]``, float64 for
        the comparison)."""
        dev = self.dev
        tab = physics.tables([scenes.walls(self.boxes)], dtype, dev)
        sim, aud = self.sim, self.aud
        head = dict(sample_rate=aud["sample_rate"],
                    head_radius=self.head["head_radius"],
                    shadow=self.head["shadow"],
                    speed=sim["speed_of_sound"],
                    decorrelate=self.head["decorrelate"])
        early = arrivals.early_bins(self.wd, self.n, aud["sample_rate"],
                                    self.head["head_radius"])
        chunks, works = {}, []

        def chunk_of(k):
            if k not in chunks:
                cap, work = binaural.capture(
                    tab, self.source, self.pose(k),
                    philox.mix_seed(self.env.seed, k),
                    n_rays=sim["ray_count"], n_bounces=sim["max_bounces"],
                    sample_rate=aud["sample_rate"], ir_length=self.t,
                    radius=sim["listener_radius"],
                    speed=sim["speed_of_sound"], gain=sim["input_gain"],
                    dtype=dtype, acc_dtype=acc_dtype)
                chunks[k] = arrivals.chunk(cap, self.facing(k), early,
                                           self.arrival["taps"], **head)
                works.append(work)
            return chunks[k]

        clip = self.dry.to(torch.float64)

        def dry_of(k):
            return self.dry_chunk(k).to(device=dev, dtype=torch.float64)

        def dry_at(pos):
            return torch.where(pos >= 0, clip[pos % clip.shape[-1]],
                               clip.new_zeros(()))

        out = {j: arrivals.output_chunk(
            j, self.n, self.t, self.wd, dry_of, dry_at, chunk_of,
            float(self.arrival["match_bins"]), acc_dtype, **head)
            .to(torch.float64) for j in keys}
        work = physics.Work(
            float(np.mean([w.alive for w in works])),
            float(np.mean([w.heard for w in works])))
        return out, work
