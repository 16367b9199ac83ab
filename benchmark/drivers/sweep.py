"""Room sweeps: a closed loop of ``sweep_rooms`` calls on one card, or of
``sweep_rooms_sharded`` over a mesh of every card of the cell.

Set-up draws a pool of the traffic's ``pool`` batches of ``rooms``
procedural rooms each (the configuration's ``room_batch``: shoebox rooms
with random obstacles, materials and poses) from the seed, builds each
room through the program's public builder and stacks them on the first
card. Each step sweeps the next batch of the pool under a fresh ray seed
into frame-normalized IRs ``[rooms, 1, T, 1]``, gathered on the first
card when sharded (as the program does), and copies them to host memory
as the program's ``cli sweep`` does (``irs.cpu()``, pageable). Answers compared: one call drawn from the seed among the
window's calls; of its rooms, the traffic's ``compare_rooms`` drawn from
the seed (all of them when it is absent), each against the plain
reference's IR of that room.
"""

from __future__ import annotations

import torch

from benchmark import harness
from benchmark.reference import philox, physics, scenes


class Driver:
    unit = "rooms"

    def __init__(self, env: harness.Env):
        self.env = env
        cfg, tr = env.config, env.traffic
        self.sim, self.aud = cfg["sim"], cfg["audio"]
        self.batch = cfg["room_batch"]
        self.t = int(self.aud["sample_rate"] * self.aud["reverb_duration"])
        self.rooms = int(tr["rooms"])
        self.pool = int(tr["pool"])
        self.frames = int(self.batch["frames_per_room"])
        self.walls = 4 * (4 + self.batch["n_obstacles"])
        self.sharded = len(env.devices) > 1
        self.warm = int(tr["warm_calls"])
        self.compare_rooms = int(tr.get("compare_rooms", self.rooms))
        self.next = 0

    def draw(self, p: int):
        return scenes.rooms(self.rooms, philox.mix_seed(self.env.seed, p),
                            self.batch["n_obstacles"])

    def setup(self) -> None:
        dev = self.env.devices[0]
        scene_mod = harness.port_module("models.scene")
        self.sweep = harness.port_module("parallel.sweep")
        self.batches = []
        for p in range(self.pool):
            boxes, src, lis = self.draw(p)
            stacked = scene_mod.Scene.stack(
                [harness.build_scene(b, 1, "cpu", pad_to=self.walls)
                 for b in boxes]).to(dev)
            self.batches.append((stacked, torch.as_tensor(src, device=dev),
                                 torch.as_tensor(lis, device=dev)))
        if self.sharded:
            mesh_mod = harness.port_module("parallel.mesh")
            self.mesh = mesh_mod.make_mesh(devices=self.env.devices)
        for _ in range(self.warm):
            self.step()

    def ray_seed(self, i: int) -> int:
        return philox.mix_seed(self.env.seed, 1 << 32, i)

    def step(self) -> int:
        i = self.next
        scenes_, src, lis = self.batches[i % self.pool]
        kw = dict(n_rays=self.sim["ray_count"],
                  max_bounces=self.sim["max_bounces"],
                  sample_rate=self.aud["sample_rate"], ir_length=self.t,
                  n_frames=self.frames,
                  listener_radius=self.sim["listener_radius"],
                  speed_of_sound=self.sim["speed_of_sound"],
                  input_gain=self.sim["input_gain"])
        with harness.span("step"):
            if self.sharded:
                irs = self.sweep.sweep_rooms_sharded(
                    scenes_, src, lis, self.ray_seed(i), self.mesh, **kw)
            else:
                irs = self.sweep.sweep_rooms(scenes_, src, lis,
                                             self.ray_seed(i), **kw)
        with harness.span("readback"):
            host = irs.cpu()
        self.env.sample.offer((i, host))
        self.next += 1
        return self.rooms

    def launches(self) -> dict:
        return {"frames_ir_kernel": len(self.env.devices)}

    def shapes(self) -> dict:
        return dict(n_rays=self.sim["ray_count"],
                    n_bounces=self.sim["max_bounces"], n_frames=self.frames,
                    n_entries=self.rooms, n_listeners=1, n_bands=1,
                    n_walls=self.walls, ir_length=self.t)

    def release(self) -> None:
        del self.batches
        self.mesh = None

    def compared(self) -> list:
        """The rooms of the sampled call that are compared."""
        if self.compare_rooms >= self.rooms:
            return list(range(self.rooms))
        pick = self.env.rng(3).choice(self.rooms, self.compare_rooms,
                                      replace=False)
        return sorted(int(r) for r in pick)

    def reference(self, keys, dtype, acc_dtype):
        """For each sampled call ``i``: ``(rooms, IRs [rooms, T])`` of its
        compared rooms (frame-normalized, in ``acc_dtype``)."""
        dev = self.env.devices[0]
        rooms = self.compared()
        out, alive, heard = {}, 0, 0
        for i in keys:
            boxes, src, lis = self.draw(i % self.pool)
            tab = physics.tables([scenes.walls(boxes[r]) for r in rooms],
                                 dtype, dev)
            pose = physics.Pose(torch.as_tensor(src[rooms]),
                                torch.as_tensor(lis[rooms])[:, None],
                                self.sim["listener_radius"],
                                self.sim["speed_of_sound"],
                                self.sim["input_gain"])
            ir, work = physics.trace_ir(
                tab, pose, self.ray_seed(i), n_rays=self.sim["ray_count"],
                n_bounces=self.sim["max_bounces"], n_frames=self.frames,
                sample_rate=self.aud["sample_rate"], ir_length=self.t,
                entry_ids=rooms, dtype=dtype, acc_dtype=acc_dtype)
            out[i] = (rooms, ir[:, 0, :, 0] / self.frames)
            alive += work.alive
            heard += work.heard
        per_step = self.rooms / len(rooms) / len(keys)
        return out, physics.Work(alive * per_step, heard * per_step)

    def answers(self):
        return {i: buf for i, buf in self.env.sample.items}

    def gaps(self, answers, reference) -> dict:
        """``ir_gap`` of each compared room: the L1 distance of its IR from
        the reference's, over the larger of that room's reference L1 and
        the median room's (a room no ray reaches has an IR of zeros)."""
        out = []
        for i, (rooms, ref) in reference.items():
            ref = ref.to(torch.float64)
            got = answers[i]
            got = got[1] if isinstance(got, tuple) else \
                torch.as_tensor(got)[rooms, 0, :, 0]
            got = got.to(device=ref.device, dtype=torch.float64)
            l1 = ref.abs().sum(dim=-1)
            den = torch.clamp(l1, min=float(l1.median()))
            out += ((got - ref).abs().sum(dim=-1) / den).tolist()
        return {"ir_gap": out}
