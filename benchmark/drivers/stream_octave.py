"""A banded stream with both physics addenda: one chunk after another
through ``Streamer.process`` of a streamer with banded materials, the
octave band split, order-2 edge diffraction and ISO 9613-1 air absorption.

Closed loop on one card, as ``stream.py``'s (its walk, pose and dry feed).
Each step builds the chunk's trace parameters (``Engine.params``) from
the listener's pose and streams one chunk: the retrace at K bands (one
K4 launch), the diffraction IR of orders 1 and 2 (two visibility sweeps,
K2), the air curve, the crossfaded convolution in the configuration's
band split, and the ring; then the output chunk is copied to host memory.
The walls take the band absorptions their configuration lists.

Answers compared: the traffic's ``compare`` output chunks, each with the
IR the chunk left in the stream (the augmented ``state.prev_ir``), drawn
from the seed in two strata: chunks whose direct segment the walls block
(shadowed: the diffraction is the sound heard directly) and the others
(lit), at least one of each where the window holds both (:class:`Strata`).
Each against the plain reference (``reference/addenda.py``): the banded
traces, diffraction and air of every chunk whose tail reaches it,
convolved in the octave bands, crossfaded and overlap-added in float64.
Numbers compared: ``out_gap`` (as ``stream.py``'s) and ``band_ir_gap``, the
largest over the compared IRs and their bands of a band's L1 gap over
that band's L1.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers import stream
from benchmark.reference import addenda, philox

# the visibility kernel K2 (K1 is the same template with an index)
K2 = "wall_sweep_kernel<false"


class Strata:
    """:class:`harness.Sample`'s reservoir in two strata of the window's
    chunks, shadowed and lit: ``1 + rng.integers(k - 1)`` of the ``k``
    answers (drawn from the seed) come from the shadowed chunks, the rest
    from the lit ones. Items are ``(key, value)`` as the harness reads
    them; a stratum the window never offers keeps none."""

    def __init__(self, k: int, seed: int):
        rng = np.random.default_rng([seed & harness.M64, 0x0C7A])
        n_shadow = 1 + int(rng.integers(max(1, k - 1))) if k > 1 else k
        self.strata = {}
        for tag, size in ((True, n_shadow), (False, k - n_shadow)):
            s = harness.Sample(size, seed)
            s.rng = np.random.default_rng([seed & harness.M64, 0x0C7A,
                                           int(tag)])
            self.strata[tag] = s
        self.k = k
        self.windows = 0           # windows opened so far
        self._active = False

    @property
    def active(self) -> bool:
        return self._active

    @active.setter
    def active(self, on: bool) -> None:
        self.windows += on and not self._active
        self._active = on
        for s in self.strata.values():
            s.active = on

    @property
    def items(self):
        return [x for s in self.strata.values() for x in s.items]

    def offer(self, item, shadowed: bool) -> bool:
        return self.strata[bool(shadowed)].offer(item)


class Driver(stream.Driver):
    unit = "chunks"

    def __init__(self, env: harness.Env):
        super().__init__(env)
        cfg = env.config
        self.k = int(self.sim["n_bands"])
        self.split = cfg["band_split"]
        self.order = int(cfg["diffraction"]["order"])
        self.air = cfg["air"]
        self.centres = cfg["band_centres_hz"]
        self.walls = addenda.band_walls(cfg)
        env.sample = Strata(int(env.traffic.get("compare", 1)), env.seed)
        # host-side shadow test of each pose (float64, the stratum only)
        self.judge = addenda.Addenda(
            self.walls, self.centres, speed=self.sim["speed_of_sound"],
            gain=self.sim["input_gain"], sample_rate=self.aud["sample_rate"],
            ir_length=self.t, dtype=torch.float64, acc_dtype=torch.float64,
            device=torch.device("cpu"))
        self.window = []     # (window, chunk, shadowed) of windows' steps

    def _scene(self):
        """The program's scene, its materials banded as configured."""
        scene_mod = harness.port_module("models.scene")
        mats = harness.port_module("models.materials")
        sc = self.env.config["scene"]
        b = scene_mod.SceneBuilder(n_bands=self.k)
        for box in sc["boxes"]:
            m = sc["materials"][box["material"]]
            b.add_box(mats.AudioMaterial(
                absorption=m["absorption"], scattering=m["scattering"],
                transmission=m["transmission"], ior=m["ior"],
                band_absorption=tuple(m["band_absorption"])),
                scene_mod.Transform2D(tuple(box["position"]), box["angle"],
                                      tuple(box["scale"])),
                size=tuple(box.get("size", (1.0, 1.0))))
        return b.build(device=self.dev)

    def setup(self) -> None:
        p = self.env.port
        air = harness.port_module("ops.air")
        cfg = harness.engine_config(self.env.config)
        self.scene = self._scene()
        self.engine = p.Engine(self.scene, cfg)
        alpha = air.iso9613_alpha(air.band_frequencies(self.k),
                                  self.air["temperature_c"],
                                  self.air["rel_humidity"],
                                  self.air["pressure_kpa"])
        self.streamer = p.Streamer(
            self.scene, cfg, seed=self.env.seed, diffraction=self.order,
            air_alpha=torch.as_tensor(np.asarray(alpha, np.float32),
                                      device=self.dev),
            band_split=self.split)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.env.seed)
        self.dry = (torch.rand(self.clip_chunks * self.n, generator=gen,
                               device=self.dev) - 0.5).cpu()
        for _ in range(self.warm):
            self.step()

    def step(self) -> int:
        i = self.next
        pose = self.pose(i)
        with harness.span("pose"):
            params = self.engine.params(self.source, pose)
        with harness.span("feed"):
            dry = self.dry_chunk(i).to(self.dev)
        with harness.span("step"):
            out = self.streamer.process(dry, params)
        with harness.span("readback"):
            host = out.cpu()
        sample = self.env.sample
        if sample.active:
            shadowed = self.judge.blocked(self.source, pose)
            self.window.append((sample.windows, i, shadowed))
            kept = {"out": host, "ir": None}
            if sample.offer((i, kept), shadowed):
                kept["ir"] = self.streamer.state.prev_ir.clone()
        self.next += 1
        return 1

    def launches(self) -> dict:
        return {"frames_ir_kernel": 1, K2: self.order}   # a sweep an order

    def shapes(self) -> dict:
        return {**super().shapes(), "n_bands": self.k}

    def answers(self):
        return {i: (v["out"], v["ir"][0].cpu())
                for i, v in self.env.sample.items}

    def reference(self, keys, dtype, acc_dtype):
        """Output chunks ``keys`` of the reference (``[1, N]``) and their
        IRs (``[T, K]``), float64 for the comparison."""
        dev, sim, aud = self.dev, self.sim, self.aud
        sr = aud["sample_rate"]
        tab = addenda.physics.tables([self.walls], dtype, dev)
        add = addenda.Addenda(
            self.walls, self.centres, speed=sim["speed_of_sound"],
            gain=sim["input_gain"], sample_rate=sr, ir_length=self.t,
            dtype=dtype, acc_dtype=acc_dtype, device=dev)
        alpha = addenda.air_alpha(self.centres, self.air["temperature_c"],
                                  self.air["rel_humidity"],
                                  self.air["pressure_kpa"])
        curve = addenda.air_curve(self.t, sr, alpha, sim["speed_of_sound"],
                                  acc_dtype, dev)
        irs, works, masks = {}, [], {}

        def ir_of(k):
            if k not in irs:
                irs[k], work = addenda.chunk_ir(
                    tab, add, self.source, self.pose(k),
                    philox.mix_seed(self.env.seed, k),
                    n_rays=sim["ray_count"], n_bounces=sim["max_bounces"],
                    radius=sim["listener_radius"], alpha=alpha,
                    dtype=dtype, acc_dtype=acc_dtype, curve=curve)
                works.append(work)
            return irs[k]

        def masks_of(n_fft):
            if n_fft not in masks:
                masks[n_fft] = addenda.band_masks(self.centres, n_fft, sr,
                                                  torch.float64, dev)
            return masks[n_fft]

        def dry_of(k):
            return self.dry_chunk(k).to(device=dev, dtype=torch.float64)

        out = {j: (addenda.output_chunk(j, self.n, self.t, dry_of, ir_of,
                                        masks_of, acc_dtype),
                   ir_of(j).to(torch.float64)) for j in keys}
        work = addenda.Work(*(float(np.mean([getattr(w, f) for w in works]))
                              for f in addenda.Work._fields))
        if dtype == torch.float32:
            self._report(add)
        return out, work

    def _report(self, add) -> None:
        """Each window's shadowed share and the share of its chunks with a
        diffraction path, on standard error (a traced run's last window
        is the traced one)."""
        for w in sorted({w for w, _, _ in self.window}):
            steps = [(i, s) for ww, i, s in self.window if ww == w]
            shadow = sum(1 for _, s in steps if s)
            paths = sum(1 for i, s in steps if s and add.paths(
                self.source, self.pose(i))[0].numel())
            n = len(steps)
            print(f"window {w}: {n} chunks, {shadow} shadowed "
                  f"({100.0 * shadow / n:.1f}%), {paths} with a diffraction "
                  f"path ({100.0 * paths / n:.1f}%)", file=sys.stderr)

    def gaps(self, answers, reference) -> dict:
        """``out_gap`` of each compared output chunk (its largest gap from
        the reference over the reference chunk's peak) and
        ``band_ir_gap`` of each compared IR (the largest over its bands of
        the band's L1 gap over the reference band's L1)."""
        out, band = [], []
        for j, (ref_out, ref_ir) in reference.items():
            got_out, got_ir = (torch.as_tensor(x).to(
                device=ref_out.device, dtype=torch.float64)
                for x in answers[j])
            peak = float(ref_out.abs().max())
            out.append(float((got_out - ref_out).abs().max()) / peak
                       if peak > 0 else float("inf"))
            l1 = ref_ir.abs().sum(0)
            gap = (got_ir - ref_ir).abs().sum(0)
            band.append(float((gap / l1).max()) if bool((l1 > 0).all())
                        else float("inf"))
        return {"out_gap": out, "band_ir_gap": band}
