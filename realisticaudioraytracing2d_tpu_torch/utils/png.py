"""Minimal dependency-free PNG writer (stdlib zlib/struct), copied from
``realisticaudioraytracing2d_tpu/utils/png.py`` (numpy only).

Used by the viz module to dump debug rasters, the file-based equivalent of
the reference's on-screen ``RenderTexture`` overlay."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data +
            struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an image as RGB(A) PNG.

    ``image``: uint8 array [H, W] (grayscale), [H, W, 3] or [H, W, 4];
    floats in [0, 1] are converted.
    """
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w, c = img.shape
    if c == 3:
        color_type = 2
    elif c == 4:
        color_type = 6
    else:
        raise ValueError(f"unsupported channel count {c}")
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                       0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(raw, 6))
    out += _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)
