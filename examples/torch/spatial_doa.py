"""Direction-of-arrival analysis from ONE spatial impulse response, on the
PyTorch port.

A scalar IR says WHEN sound arrives; the spatial IR (``spatial.py``) also
says FROM WHERE: per-bin 2D intensity channels (W, X, Y) extracted
exactly through three coincident virtual microphones (the directive
bounce kernel on the card). This example traces a shoebox room,
peak-picks the strongest arrivals, and checks each measured bearing
against the image-source geometry: the direct sound plus the four
first-order wall reflections, identified from one receiver position
without any array processing.

It also demonstrates post-hoc steering: a stereo cardioid pair is
derived from the SAME trace by linear combination (``SpatialIR.stereo``),
matching what ``--stereo-aim`` would have retraced.

Run:  python examples/torch/spatial_doa.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from realisticaudioraytracing2d_tpu_torch import spatial as spm  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.materials import \
    AudioMaterial  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.models.scene import \
    SceneBuilder  # noqa: E402
from realisticaudioraytracing2d_tpu_torch.ops.trace import \
    TraceParams  # noqa: E402

SR = 16000
C = 343.0
RADIUS = 0.3
SRC = np.float32([-2.5, 1.0])
MIC = np.float32([2.0, -1.5])


def setup(dev):
    """The specular shoebox [-6, 6] x [-4, 4] of four raw segments and
    the trace parameters of the source and the microphone."""
    m = AudioMaterial(absorption=0.3, scattering=0.0, transmission=0.0,
                      ior=1.0)
    b = SceneBuilder(n_bands=1)
    b.add_segment((-6.0, -4.0), (6.0, -4.0), (0.0, 1.0), m)
    b.add_segment((6.0, -4.0), (6.0, 4.0), (-1.0, 0.0), m)
    b.add_segment((6.0, 4.0), (-6.0, 4.0), (0.0, -1.0), m)
    b.add_segment((-6.0, 4.0), (-6.0, -4.0), (1.0, 0.0), m)
    return b.build(device=dev), TraceParams.make(SRC, MIC,
                                                 listener_radius=RADIUS,
                                                 device=dev)


def expected_arrivals():
    """(name, time s, bearing rad) of the direct sound and the four
    first-order image sources, by time."""
    src, mic = SRC, MIC
    images = {
        "direct": src,
        "floor (y=-4)": np.float32([src[0], -8.0 - src[1]]),
        "right (x=+6)": np.float32([12.0 - src[0], src[1]]),
        "ceiling (y=+4)": np.float32([src[0], 8.0 - src[1]]),
        "left (x=-6)": np.float32([-12.0 - src[0], src[1]]),
    }
    expected = []
    for name, pos in images.items():
        d = pos - mic
        expected.append((name, np.hypot(*d) / C, np.arctan2(d[1], d[0])))
    expected.sort(key=lambda e: e[1])
    return expected


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (plain versions)")
    parser.add_argument("--rays", type=int, default=32768)
    parser.add_argument("--frames", type=int, default=4)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)

    scene, p = setup(dev)
    ir, _ = spm.trace_spatial(scene, p, 0, n_rays=args.rays, max_bounces=4,
                              sample_rate=SR, ir_length=SR // 2,
                              n_frames=args.frames)
    expected = expected_arrivals()

    print("strongest arrivals (greedy peak-pick; late ones may be "
          "second-order mixtures):")
    for a in spm.dominant_arrivals(ir, SR, n=4, window_bins=16):
        print(f"  {a['time_s'] * 1e3:7.2f} ms  from "
              f"{np.degrees(a['bearing_rad']):7.1f} deg  "
              f"diffuseness {a['diffuseness']:.3f}")

    # Validate each image-source bearing at its energy ONSET (capture on
    # the 0.3 m disc rim starts r/c before the center-distance time), with
    # the pre-arrival NEE continuum subtracted: `spatial.onset_bearing`. A
    # SHORT onset window isolates the specular (stationary-phase) wall
    # point: the tracer's NEE connects from EVERY wall point, so a wall
    # "echo" is really the onset of a continuum whose later energy arrives
    # from the wall ends, biased toward the end nearer the mic. A few
    # degrees of residual bias on distant oblique walls is that physics,
    # not estimator error.
    print(f"\n{'image':>14} {'expected':>12} {'measured bearing':>17}")
    worst = 0.0
    for name, t_exp, b_exp in expected:
        t_onset = t_exp - RADIUS / C
        b_meas = spm.onset_bearing(ir, t_onset, SR, onset_bins=4)
        d_ang = np.degrees(abs(np.angle(np.exp(1j * (b_meas - b_exp)))))
        worst = max(worst, d_ang)
        print(f"{name:>14} {np.degrees(b_exp):6.1f}d @ {t_exp * 1e3:5.2f} ms"
              f" {np.degrees(b_meas):10.1f}d  (err {d_ang:.1f}d)")
    assert worst < 8.0, f"bearing error {worst:.1f} deg"

    # -- post-hoc steering: re-aim without retracing -------------------------
    # Point a cardioid AT the measured direct-sound bearing and one away
    # from it: the facing mic must capture more energy, all from one
    # trace, by linear combination of (W, X, Y) (`SpatialIR.steer`).
    b_direct = expected[0][2]
    fwd = float(ir.steer(b_direct).sum())
    bwd = float(ir.steer(b_direct + np.pi).sum())
    print(f"\npost-hoc cardioids: facing source {fwd:.1f}, "
          f"facing away {bwd:.1f}")
    assert fwd > bwd
    # and the XY stereo pair around that bearing is just two such steers
    left, right = ir.stereo(aim=b_direct)
    np.testing.assert_allclose(left.cpu().numpy(),
                               ir.steer(b_direct + np.pi / 4).cpu().numpy(),
                               rtol=1e-6)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
