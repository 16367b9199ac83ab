"""PyTorch port: the binaural stream with per-arrival Doppler (the
"composed" stream, ``Streamer(binaural=True)`` fed ``window=`` and
``facing=``) against the benchmark's plain reference
(``benchmark/reference/binaural.py``, ``arrivals.py``), which is written
from the published semantics and imports nothing of the port.

Eight chunks of SmollRoom (the configuration's scene) at a small size:
512 rays x 4 bounces, 8 kHz, 0.05 s chunks, a 0.25 s IR, a head walking
0.3 m a chunk while it turns. Compared, chunk by chunk: the W/X/Y capture,
the decoded ear IRs (the full capture's and the residual's), the tap
tables and the output chunks of both ears. The spans of the per-arrival
branch change no output bit.

Tolerances, each relative to the reference's peak:

* capture, 1e-6: the port's CPU trace sums each bin's deposits in
  float32, the reference in float64; the rays are the same float32 rays;
* ears, 2 T 2^-23 (4.8e-4 at T = 2000): the decode splats each bin at
  the float32 position ``b -+ shift sin(phi)``, rounded to within half an
  ulp of T, which moves up to that share of the bin's energy to its
  neighbour; the reference's positions are float64;
* tap gains, 1e-6: the 3-bin windows are the capture's bins (above);
  bins and validity are compared exactly;
* output chunks, 2 T 2^-23 as well: the decode's positions, and the taps'
  float32 read positions in the dry history (under T here) with the same
  bound, reach the output through the convolution.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_parity import CPU

import realisticaudioraytracing2d_tpu_torch as art
from realisticaudioraytracing2d_tpu_torch import streaming

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402
from benchmark.reference import (arrivals, binaural, philox,  # noqa: E402
                                 physics, scenes)

CONFIG = json.loads((REPO / "benchmark" / "configs"
                     / "smollroom_binaural.json").read_text())
N_CHUNKS = 8
SEED = 2 ** 31 + 23
RAYS, BOUNCES = 512, 4
CAPTURE_TOL = 1e-6


def _config():
    cfg = json.loads(json.dumps(CONFIG))
    cfg["sim"].update(ray_count=RAYS, max_bounces=BOUNCES)
    cfg["audio"].update(sample_rate=8000, reverb_duration=0.25,
                        chunk_duration=0.05)
    return cfg


def pose(i):
    a = 0.4 + 0.075 * i                  # 0.3 m a chunk on the 4 m circle
    return (np.array(CONFIG["scene"]["walk"]["center"])
            + 4.0 * np.array([math.cos(a), math.sin(a)])).astype(np.float32)


def facing(i):
    return 0.4 + 0.075 * i + math.pi / 2 + 0.5 * math.sin(0.9 * i)


@dataclasses.dataclass
class Run:
    cfg: dict
    n: int
    t: int
    wd: int
    dry: torch.Tensor
    outs: list
    steps: list        # per chunk: the branch's inputs and products
    full_ears: list    # per chunk: the decode of the whole capture


def stream(record_spans=False):
    """The port's composed stream of ``N_CHUNKS`` chunks, with each
    chunk's capture, table, residual and taps taken from the per-arrival
    branch (and, with ``record_spans``, under a CPU profiler)."""
    cfg = _config()
    boxes = scenes.boxes_from_config(cfg["scene"])
    ecfg = harness.engine_config(cfg)
    scene = harness.build_scene(boxes, 1, CPU)
    head, arr = cfg["binaural"], cfg["arrival"]
    st = art.Streamer(scene, ecfg, seed=SEED, binaural=True,
                      head_radius=head["head_radius"], shadow=head["shadow"],
                      decorrelate=head["decorrelate"],
                      arrival_taps=arr["taps"],
                      arrival_window_s=arr["window_s"],
                      arrival_match_bins=arr["match_bins"])
    eng = art.Engine(scene, ecfg)
    n, t = ecfg.audio.chunk_samples, ecfg.audio.ir_length
    wd = n + st.arrival_early + 2
    gen = torch.Generator().manual_seed(SEED)
    dry = torch.rand(5 * n, generator=gen) - 0.5
    steps, outs, full = [], [], []
    orig = streaming._per_arrival_binaural

    def spy(piece, window, carry, cur_sp, *a, **k):
        wet, taps, new = orig(piece, window, carry, cur_sp, *a, **k)
        steps.append(dict(cap=cur_sp[..., 0].clone(), taps=taps.clone(),
                          idx=new.idx[0].clone(), val=new.val[0].clone(),
                          g3=new.g3[0, :, :, 0].clone(),
                          res=new.res[..., 0].clone()))
        return wet, taps, new

    streaming._per_arrival_binaural = spy
    try:
        for i in range(N_CHUNKS):
            w = (dry, *streaming.window_scalars(i, n, wd, dry.shape[-1],
                                                True, None), True)
            outs.append(st.process(
                streaming.dry_chunk(dry, i, n, True),
                eng.params(CONFIG["scene"]["source"], pose(i)),
                facing=facing(i), window=w).clone())
            full.append(st.state.prev_ir[..., 0].clone())
    finally:
        streaming._per_arrival_binaural = orig
    return Run(cfg, n, t, wd, dry, outs, steps, full)


class Reference:
    """The plain reference of the same stream, chunk by chunk, from its
    own captures (or from the port's, ``captures=``)."""

    def __init__(self, run: Run, captures=None):
        cfg, self.run = run.cfg, run
        sim, aud = cfg["sim"], cfg["audio"]
        self.head = dict(sample_rate=aud["sample_rate"],
                         head_radius=cfg["binaural"]["head_radius"],
                         shadow=cfg["binaural"]["shadow"],
                         speed=sim["speed_of_sound"],
                         decorrelate=cfg["binaural"]["decorrelate"])
        self.early = arrivals.early_bins(run.wd, run.n, aud["sample_rate"],
                                         cfg["binaural"]["head_radius"])
        self.walls = physics.tables(
            [scenes.walls(scenes.boxes_from_config(cfg["scene"]))],
            torch.float32, CPU)
        self.captures = captures
        self.cache = {}

    def capture(self, k):
        if self.captures is not None:
            return self.captures[k]
        sim = self.run.cfg["sim"]
        return binaural.capture(
            self.walls, CONFIG["scene"]["source"], pose(k),
            philox.mix_seed(SEED, k), n_rays=sim["ray_count"],
            n_bounces=sim["max_bounces"],
            sample_rate=self.head["sample_rate"], ir_length=self.run.t,
            radius=sim["listener_radius"], speed=sim["speed_of_sound"],
            gain=sim["input_gain"])[0]

    def chunk(self, k):
        if k not in self.cache:
            self.cache[k] = arrivals.chunk(self.capture(k), facing(k),
                                           self.early,
                                           self.run.cfg["arrival"]["taps"],
                                           **self.head)
        return self.cache[k]

    def output(self, j):
        clip = self.run.dry.double()
        n = self.run.n
        return arrivals.output_chunk(
            j, n, self.run.t, self.run.wd,
            lambda k: streaming.dry_chunk(clip, k, n, True),
            lambda pos: torch.where(pos >= 0, clip[pos % clip.shape[-1]],
                                    0.0),
            self.chunk, float(self.run.cfg["arrival"]["match_bins"]),
            **self.head)


@pytest.fixture(scope="module")
def run():
    return stream()


@pytest.fixture(scope="module")
def ref(run):
    return Reference(run)


@pytest.fixture(scope="module")
def ref_of_port(run):
    """The reference's steps on the port's own captures: the decode and
    taps compared without the trace's rounding in front of them."""
    return Reference(run, [s["cap"].double() for s in run.steps])


def _gap(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def _ulp_share(run):
    return 2 * run.t * 2.0 ** -23


def test_the_stream_is_heard(run):
    assert len(run.steps) == N_CHUNKS
    assert all(s["val"].any() for s in run.steps)
    moved = [int((a["idx"] - b["idx"]).abs().min())
             for a, b in zip(run.steps, run.steps[1:])]
    assert max(moved) > 0                  # the taps glide
    assert all(float(o.abs().max()) > 0 for o in run.outs[2:])


@pytest.mark.parametrize("k", range(N_CHUNKS))
def test_capture_matches_the_reference(run, ref, k):
    cap = ref.capture(k)
    got = run.steps[k]["cap"].double()
    w = cap[0]
    for name, a, b in (("W", got[0], w), ("X", got[1] - got[0], cap[1] - w),
                       ("Y", got[2] - got[0], cap[2] - w)):
        gap = float((a - b).abs().max() / w.abs().max())
        assert gap <= CAPTURE_TOL, (name, k, gap)


@pytest.mark.parametrize("which", ["full", "residual"])
@pytest.mark.parametrize("k", [1, 4, 7])
def test_decoded_ears_match_the_reference(run, ref_of_port, which, k):
    cap = ref_of_port.capture(k)
    if which == "full":
        want = binaural.decode(cap[0], cap[1] - cap[0], cap[2] - cap[0],
                               facing(k), **ref_of_port.head)
        got = run.full_ears[k]
    else:
        want, got = ref_of_port.chunk(k).residual, run.steps[k]["res"]
    assert tuple(got.shape) == (2, run.t)
    assert _gap(got, want) <= _ulp_share(run), (which, k)


@pytest.mark.parametrize("k", range(N_CHUNKS))
def test_tap_tables_match_the_reference(run, ref, k):
    tab, got = ref.chunk(k).table, run.steps[k]
    assert torch.equal(got["idx"], tab.idx), k
    assert torch.equal(got["val"], tab.valid), k
    assert _gap(got["g3"], tab.w3) <= CAPTURE_TOL


@pytest.mark.parametrize("j", [2, 5, 7])
def test_output_chunks_match_the_reference(run, ref, j):
    want = ref.output(j)
    assert tuple(run.outs[j].shape) == (2, run.n)
    assert _gap(run.outs[j], want) <= _ulp_share(run), j
    # both ears carry sound, and not the same sound
    assert float((want[0] - want[1]).abs().max()) > 0.1 * float(
        want.abs().max())


def test_taps_match_the_reference_on_the_ports_captures(run, ref_of_port):
    clip = run.dry.double()
    for j in range(N_CHUNKS):
        cur = ref_of_port.chunk(j)
        prev = ref_of_port.chunk(j - 1) if j else cur
        window = arrivals.history(
            lambda pos: torch.where(pos >= 0, clip[pos % clip.shape[-1]],
                                    0.0), j, run.n, run.wd, CPU)
        want = arrivals.chunk_taps(window, run.n, cur.table, prev.table,
                                   cur.facing, prev.facing, run.t,
                                   float(run.cfg["arrival"]["match_bins"]),
                                   **ref_of_port.head)
        if float(want.abs().max()) > 0:
            assert _gap(run.steps[j]["taps"], want) <= _ulp_share(run), j


def test_spans_change_no_bit_of_the_composed_stream(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = stream()
    names = [e.name for e in prof.events() if e.name.startswith("art.")]
    for name in ("art.arrival.extract", "art.arrival.residual",
                 "art.arrival.taps", "art.arrival.convolve"):
        assert name in names, name
    for a, b in zip(run.outs, traced.outs):
        assert torch.equal(a, b)
