"""Visualization: IR waveform/spectrogram rasters, scene + ray-path plots.

Port of ``realisticaudioraytracing2d_tpu/utils/viz.py``: file-based
replacements for the reference's visual fixtures, the ``DrawIR`` overlay
texture (``Raytrace2D.compute:174-189``), the legacy spectrogram view
(``RaytraceOcclusion2D.compute:269-290``), and the gizmo rendering of
walls/normals/source/listener/ray paths (``RayTraceManager.cs:261-279``).
All renderers are NumPy producing [H, W, 3] float images; tensors come to
the host once (:func:`_host`); :func:`~.png.write_png` dumps them.
:func:`diffraction_polylines` gives the valid diffraction paths for
:func:`render_scene`'s ``extra_paths``; :func:`decay_curve_image` plots
the Schroeder decay of :func:`..analysis.edc_db`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.scene import Scene
from ..ops.ir import rasterize_ir
from ..ops.trace import DebugPaths
from .png import write_png

GREEN = np.array([0.0, 1.0, 0.0])
RED = np.array([1.0, 0.2, 0.2])
CYAN = np.array([0.2, 0.9, 1.0])
ORANGE = np.array([1.0, 0.6, 0.1])
YELLOW = np.array([1.0, 1.0, 0.2])


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ir_waveform_image(ir_accum, frames, gain: float = 1000.0,
                      width: int = 1024, height: int = 256) -> np.ndarray:
    """Green-on-black waveform bars, the DrawIR texture as an array."""
    mask = _host(rasterize_ir(ir_accum, frames, gain, width, height))
    img = np.zeros((height, width, 3), np.float32)
    img[mask > 0] = GREEN
    return img[::-1]  # texture y-up -> image row 0 on top


def ir_spectrogram_image(ir_banded, frames, gain: float | None = None,
                         width: int = 1024,
                         height: int = 256) -> np.ndarray:
    """Banded IR [T, K] as a time x frequency intensity map (legacy DrawIR
    spectrogram semantics: pixel = amp * green). ``gain=None`` auto-scales
    on a cube-root curve so the reverb tail stays visible next to the
    direct-path peak."""
    ir = _host(ir_banded) / max(1, int(frames))
    t, k = ir.shape
    xs = np.minimum((np.arange(width) * t) // width, t - 1)
    ys = np.minimum((np.arange(height) * k) // height, k - 1)
    amp = ir[np.ix_(xs, ys)].T                               # [H, W]
    if gain is None:
        peak = float(amp.max())
        amp = np.cbrt(amp / peak) if peak > 0 else amp
    else:
        amp = amp * gain
    amp = np.clip(amp, 0.0, 1.0)
    return amp[::-1, :, None] * GREEN


def decay_curve_image(ir, db_floor: float = -60.0,
                      width: int = 1024, height: int = 256) -> np.ndarray:
    """Schroeder decay curve(s) as a plot: dB EDC against time, one cyan
    polyline per band, orange gridlines every 10 dB. ``ir`` is ``[T]`` or
    ``[T, K]``, accumulated or normalized (the EDC is scale-invariant);
    the curve is computed on the host, as the image is."""
    from ..analysis import edc_db

    a = _host(ir).astype(np.float32)
    if a.ndim == 1:
        a = a[:, None]
    db = _host(edc_db(torch.from_numpy(np.ascontiguousarray(a.T))))  # [K, T]
    k, t = db.shape
    img = np.zeros((height, width, 3), np.float32)
    for level in range(-10, int(db_floor), -10):
        y = int(round((level / db_floor) * (height - 1)))
        img[y, :] = ORANGE * 0.25
    xs = np.minimum((np.arange(width) * t) // width, t - 1)
    for band in range(k):
        ys = np.clip(db[band, xs] / db_floor, 0.0, 1.0) * (height - 1)
        ys = ys.astype(np.int64)
        shade = 1.0 if k == 1 else 0.4 + 0.6 * band / (k - 1)
        img[ys, np.arange(width)] = CYAN * shade
        # connect vertical jumps so steep decays stay a line
        for x in range(1, width):
            lo, hi = sorted((ys[x - 1], ys[x]))
            img[lo:hi + 1, x] = CYAN * shade
    return img


class SceneCanvas:
    """Rasterize world-space geometry into an image - the gizmo view."""

    def __init__(self, width: int = 800, height: int = 600,
                 bounds: Optional[tuple] = None):
        self.img = np.zeros((height, width, 3), np.float32)
        self.width, self.height = width, height
        self.bounds = bounds  # (xmin, ymin, xmax, ymax)

    def _fit_bounds(self, pts: np.ndarray, margin: float = 0.05):
        xmin, ymin = pts.min(axis=0)
        xmax, ymax = pts.max(axis=0)
        dx, dy = max(xmax - xmin, 1e-6), max(ymax - ymin, 1e-6)
        self.bounds = (xmin - margin * dx, ymin - margin * dy,
                       xmax + margin * dx, ymax + margin * dy)

    def _to_px(self, p: np.ndarray) -> np.ndarray:
        xmin, ymin, xmax, ymax = self.bounds
        x = (p[..., 0] - xmin) / (xmax - xmin) * (self.width - 1)
        y = (1 - (p[..., 1] - ymin) / (ymax - ymin)) * (self.height - 1)
        return np.stack([x, y], axis=-1)

    def line(self, a, b, color, alpha: float = 1.0):
        pa, pb = self._to_px(np.asarray(a)), self._to_px(np.asarray(b))
        n = int(np.ceil(np.linalg.norm(pb - pa))) + 1
        t = np.linspace(0, 1, n)[:, None]
        pts = (pa[None] * (1 - t) + pb[None] * t).astype(int)
        ok = ((pts[:, 0] >= 0) & (pts[:, 0] < self.width) &
              (pts[:, 1] >= 0) & (pts[:, 1] < self.height))
        pts = pts[ok]
        self.img[pts[:, 1], pts[:, 0]] = (
            self.img[pts[:, 1], pts[:, 0]] * (1 - alpha) + color * alpha)

    def circle(self, center, radius, color, segments: int = 64):
        ang = np.linspace(0, 2 * np.pi, segments + 1)
        pts = np.asarray(center) + radius * np.stack(
            [np.cos(ang), np.sin(ang)], -1)
        for i in range(segments):
            self.line(pts[i], pts[i + 1], color)


def render_scene(scene: Scene, source=None, listener=None,
                 listener_radius: float = 0.5,
                 debug_paths: Optional[DebugPaths] = None,
                 width: int = 800, height: int = 600,
                 draw_normals: bool = False,
                 extra_paths=None) -> np.ndarray:
    """Scene overview image: red walls, green source, cyan listener and
    energy-tinted ray paths - mirroring ``OnDrawGizmos``
    (RayTraceManager.cs:261-279). ``extra_paths``: optional list of
    world-space polylines ``[P, 2]`` drawn yellow (e.g. the valid
    diffraction bent paths)."""
    a = _host(scene.a)
    b = _host(scene.b)
    m = _host(scene.mask)
    pts = np.concatenate([a[m], b[m]] +
                         ([_host(source)[None]] if source is not None
                          else []) +
                         ([_host(listener)[None]] if listener is not None
                          else []))
    canvas = SceneCanvas(width, height)
    canvas._fit_bounds(pts)
    if debug_paths is not None:
        pos = _host(debug_paths.pos)               # [B+1, D, 2]
        en = _host(debug_paths.energy)
        alv = _host(debug_paths.alive)
        n_b, n_d = en.shape
        for d in range(n_d):
            for i in range(n_b - 1):
                if i > 0 and not alv[i, d]:
                    break
                tint = float(np.clip(en[i, d], 0, 1))
                col = ORANGE * (1 - tint) + YELLOW * tint
                canvas.line(pos[i, d], pos[i + 1, d], col, alpha=0.5)
    for i in np.nonzero(m)[0]:
        canvas.line(a[i], b[i], RED)
        if draw_normals:
            mid = (a[i] + b[i]) / 2
            nrm = _host(scene.normal)[i]
            canvas.line(mid, mid + nrm, CYAN, alpha=0.7)
    for poly in (extra_paths or []):
        poly = np.asarray(poly, np.float64)
        for i in range(len(poly) - 1):
            canvas.line(poly[i], poly[i + 1], YELLOW, alpha=0.9)
    if source is not None:
        canvas.circle(_host(source), 0.2, GREEN)
    if listener is not None:
        canvas.circle(_host(listener), listener_radius, CYAN)
    return canvas.img


def diffraction_polylines(scene: Scene, params, band_freqs=None,
                          order: int = 1):
    """World-space polylines of the valid diffraction paths of listener
    0: ``[S, E, L]`` triples (and ``[S, E1, E2, L]`` for order 2), for
    :func:`render_scene`'s ``extra_paths``."""
    from ..ops import diffraction as dfr
    if band_freqs is None:
        from ..ops.air import band_frequencies
        band_freqs = band_frequencies(scene.n_bands)
    pts, _ = dfr.edge_table(scene)
    pts = _host(pts)
    src = _host(params.source)
    lis = _host(params.listeners).reshape(-1, 2)[0]
    polys = []
    _, _, valid = dfr.diffraction_paths(scene, params, band_freqs)
    for e in np.flatnonzero(_host(valid)[0]):
        polys.append(np.stack([src, pts[e], lis]))
    if order >= 2:
        _, _, valid2 = dfr.diffraction_paths2(scene, params, band_freqs)
        for e1, e2 in zip(*np.nonzero(_host(valid2)[0])):
            polys.append(np.stack([src, pts[e1], pts[e2], lis]))
    return polys


def render_trajectory(scene: Scene, true_path, est_path, listener=None,
                      listener_radius: float = 0.5,
                      width: int = 800, height: int = 600) -> np.ndarray:
    """Scene overview with two polylines: the TRUE source trajectory
    (green, start marked) and an ESTIMATED one (yellow, estimates marked)
    - the visual record of `examples/track_source.py`'s acoustic
    tracking. Cross-marks sit at each estimate so per-chunk error is
    visible, not just the path shape."""
    a, b = _host(scene.a), _host(scene.b)
    m = _host(scene.mask)
    true_path = _host(true_path).astype(np.float64)
    est_path = _host(est_path).astype(np.float64)
    pts = np.concatenate(
        [a[m], b[m], true_path, est_path] +
        ([_host(listener)[None]] if listener is not None else []))
    canvas = SceneCanvas(width, height)
    canvas._fit_bounds(pts)
    for i in np.nonzero(m)[0]:
        canvas.line(a[i], b[i], RED)
    if listener is not None:
        canvas.circle(_host(listener), listener_radius, CYAN)
    for i in range(len(true_path) - 1):
        canvas.line(true_path[i], true_path[i + 1], GREEN)
    canvas.circle(true_path[0], 0.08, GREEN)
    for i in range(len(est_path) - 1):
        canvas.line(est_path[i], est_path[i + 1], YELLOW, alpha=0.8)
    # world-sized cross at each estimate
    xmin, ymin, xmax, ymax = canvas.bounds
    r = 0.01 * max(xmax - xmin, ymax - ymin)
    for p in est_path:
        canvas.line(p - (r, 0), p + (r, 0), YELLOW)
        canvas.line(p - (0, r), p + (0, r), YELLOW)
    return canvas.img


def save_image(path: str, image: np.ndarray) -> None:
    write_png(path, image)
