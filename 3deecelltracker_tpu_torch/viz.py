"""The tracked labels over the raw volume, as PNG files (counterpart of
``3deecelltracker_tpu/viz.py``: ``random_label_cmap`` :32 and
``save_merged_labels`` :186), without PIL or matplotlib, which the card's
machine lacks.

The pixels are the JAX package's: the same random label colours, the raw
volume's max projection scaled to 8 bits, and PIL's 50% blend, which is
``(a + b) >> 1`` per byte.  The files are plain RGB PNGs (no row filter,
zlib level 1), so their bytes differ from PIL's while the decoded images
agree.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .io.imageio import load_2d_slices_at_time


def random_label_colors(n: int = 2 ** 16, seed: int = 42) -> np.ndarray:
    """(n, 3) float RGB in [0, 1]: random hues, saturation in [0.4, 1],
    value in [0.6, 1], colour 0 black (matplotlib's ``hsv_to_rgb`` of the
    JAX package's draws)."""
    rng = np.random.RandomState(seed)
    h = rng.uniform(0, 1, n)
    s = rng.uniform(0.4, 1.0, n)
    v = rng.uniform(0.6, 1.0, n)
    i = (h * 6.0).astype(int)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    sector = i % 6
    rgb = np.empty((n, 3))
    for k, (r, g, b) in enumerate(((v, t, p), (q, v, p), (p, v, t),
                                   (p, q, v), (t, p, v), (v, p, q))):
        sel = sector == k
        rgb[sel] = np.stack([r[sel], g[sel], b[sel]], axis=1)
    rgb[0] = 0
    return rgb


LABEL_COLORS = random_label_colors()


def write_png(path, rgb: np.ndarray) -> None:
    """An (h, w, 3) uint8 image as an 8-bit RGB PNG."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)],
                          axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                 + chunk(b"IEND", b""))


def _label_rgb(lab2d: np.ndarray) -> np.ndarray:
    colors = LABEL_COLORS[lab2d % len(LABEL_COLORS)]
    return (colors * 255).astype(np.uint8)


def _gray_rgb(img: np.ndarray) -> np.ndarray:
    gray = (img * 255 / img.max()).astype(np.uint8)
    return np.repeat(gray[..., None], 3, axis=2)


def _blend(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return ((a.astype(np.uint16) + b) >> 1).astype(np.uint8)


def save_merged_labels(root, labels_xyz: np.ndarray, images_path,
                       t: int, interpolation_factor: int) -> None:
    """The labels of volume ``t`` over its raw volume, as x-y and x-z max
    projections (z stretched by ``interpolation_factor``), into
    ``track_results/merged_labels{,_xz}/merged_labels{,_xz}_t%06d.png``."""
    lab = np.asarray(labels_xyz).astype(np.int64)
    raw = load_2d_slices_at_time(images_path, t=t)
    merged = _blend(_label_rgb(lab.max(axis=2)), _gray_rgb(raw.max(axis=0)))
    lab_xz = np.repeat(_label_rgb(lab.max(axis=0)).transpose(1, 0, 2),
                       interpolation_factor, axis=0)
    raw_xz = np.repeat(raw.max(axis=1), interpolation_factor, axis=0)
    merged_xz = _blend(lab_xz, _gray_rgb(raw_xz))
    d1 = Path(root) / "track_results" / "merged_labels"
    d2 = Path(root) / "track_results" / "merged_labels_xz"
    d1.mkdir(parents=True, exist_ok=True)
    d2.mkdir(parents=True, exist_ok=True)
    write_png(d1 / ("merged_labels_t%06d.png" % t), merged)
    write_png(d2 / ("merged_labels_xz_t%06d.png" % t), merged_xz)
