"""The bench's synthetic worm recording, in numpy and in memory.

The recipe of ``bench.py::make_recording`` / ``make_drifting_centers``
(rejection-sampled centres drifting smoothly, gaussian cells on uniform
noise, uint16) without writing TIFF files, so the port's smoke run and
tests can drive the main path on arrays.  With the bench's defaults the
first volumes equal the bench's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BENCH_SHAPE = (24, 401, 168)      # (z, y, x)
BENCH_CELLS = 150


def drifting_centers(rng: np.random.RandomState, n_vols: int, n_cells: int,
                     shape: Tuple[int, int, int]
                     ) -> Dict[int, np.ndarray]:
    """{t: (n_cells, 3) zyx float32 centres}, t = 1..n_vols."""
    z, y, x = shape
    centers: List[np.ndarray] = []
    while len(centers) < n_cells:
        c = np.array([rng.uniform(4, z - 4), rng.uniform(12, y - 12),
                      rng.uniform(12, x - 12)])
        if all((abs(c[0] - o[0]) > 2.5) or (np.hypot(c[1] - o[1],
                                                     c[2] - o[2]) > 9)
               for o in centers):
            centers.append(c)
    c0 = np.asarray(centers, np.float32)
    out = {}
    for t in range(1, n_vols + 1):
        ph = 0.35 * (t - 1)
        c = c0.copy()
        c[:, 1] += 2.5 * np.sin(c0[:, 2] / 30.0 + ph)
        c[:, 2] += 2.5 * np.cos(c0[:, 1] / 35.0 + ph)
        c[:, 0] += 0.3 * np.sin(c0[:, 1] / 50.0 + ph)
        out[t] = c
    return out


def make_recording(n_vols: int, n_cells: int = BENCH_CELLS,
                   shape: Tuple[int, int, int] = BENCH_SHAPE, seed: int = 0
                   ) -> Tuple[List[np.ndarray], Dict[int, np.ndarray],
                              np.ndarray]:
    """Returns (uint16 (z, y, x) volumes for t = 1..n_vols, {t: centres
    zyx}, vol-1 ground-truth labels (z, y, x) int32).  The proofed vol-1
    labels in the pipeline's (x, y, z) frame are ``labels.transpose(1, 2,
    0)``."""
    z_, y_, x_ = shape
    rng = np.random.RandomState(seed)
    centers_by_t = drifting_centers(rng, n_vols, n_cells, shape)
    zz = np.arange(z_, dtype=np.float32)
    sig = np.array([1.1, 3.0, 3.0], np.float32)
    lab1 = np.zeros(shape, np.int32)
    vols = []
    for t in range(1, n_vols + 1):
        img = rng.rand(z_, y_, x_).astype(np.float32) * 0.06
        for i, (cz, cy, cx) in enumerate(centers_by_t[t]):
            z0, z1 = max(0, int(cz) - 4), min(z_, int(cz) + 5)
            y0, y1 = max(0, int(cy) - 10), min(y_, int(cy) + 11)
            x0, x1 = max(0, int(cx) - 10), min(x_, int(cx) + 11)
            lz = (zz[z0:z1] - cz) / sig[0]
            ly = (np.arange(y0, y1) - cy) / sig[1]
            lx = (np.arange(x0, x1) - cx) / sig[2]
            d2 = (lz[:, None, None] ** 2 + ly[None, :, None] ** 2
                  + lx[None, None, :] ** 2)
            img[z0:z1, y0:y1, x0:x1] += np.exp(-0.5 * d2)
            if t == 1:
                lab1[z0:z1, y0:y1, x0:x1] = np.where(
                    d2 < 1.2 ** 2, i + 1, lab1[z0:z1, y0:y1, x0:x1])
        vols.append((img / img.max() * 50000).astype(np.uint16))
    return vols, centers_by_t, lab1


def serpentine(shape: Tuple[int, int, int]) -> np.ndarray:
    """Bool mask with one serpentine component per slice of the last axis:
    full rows of axis 1 at even x, joined at alternating ends.  Hook-only
    min-propagation (the Pallas ``cc_propagate``'s design) crosses it one
    voxel per round."""
    m = np.zeros(shape, bool)
    for x in range(0, shape[0], 2):
        m[x] = True
        if x + 1 < shape[0]:
            m[x + 1, -1 if (x // 2) % 2 == 0 else 0] = True
    return m
