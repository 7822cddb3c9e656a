"""The results tree (counterpart of ``3deecelltracker_tpu/io/artifacts.py``,
``ResultsTree`` :38): the same file names, dtypes and frames as the JAX
package writes, so a tree from either package resumes in the other, and
the same CSV exports, byte for byte.

    seg/coords%06d.npy, seg/prob%06d.npy
    auto_vol1/
    manual_vol1/                      (user-provided)
    track_results/coords_real/coords%06d.npy
    track_results/labels/track_results_t%06i_z%04i.tif
    track_results/figure/
    track_results/merged_labels/, merged_labels_xz/   (viz.save_merged_labels)
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Union

import numpy as np

from .imageio import save_label_slices

SEG = "seg"
TRACK_RESULTS = "track_results"
COORDS_REAL = "coords_real"
LABELS = "labels"
FIGURE = "figure"
MERGED_LABELS = "merged_labels"
MERGED_LABELS_XZ = "merged_labels_xz"


class ResultsTree:
    """Typed accessor for the results directory contract."""

    def __init__(self, results_dir: Union[str, Path]):
        self.root = Path(results_dir)

    @property
    def seg_dir(self) -> Path:
        return self.root / SEG

    @property
    def coords_real_dir(self) -> Path:
        return self.root / TRACK_RESULTS / COORDS_REAL

    @property
    def labels_dir(self) -> Path:
        return self.root / TRACK_RESULTS / LABELS

    @property
    def figure_dir(self) -> Path:
        return self.root / TRACK_RESULTS / FIGURE

    def make_dirs(self) -> None:
        for d in (self.seg_dir, self.coords_real_dir, self.labels_dir,
                  self.figure_dir):
            d.mkdir(parents=True, exist_ok=True)

    def save_seg_coords(self, t: int, coords: np.ndarray) -> None:
        self.seg_dir.mkdir(parents=True, exist_ok=True)
        np.save(str(self.seg_dir / f"coords{t:06d}.npy"), np.asarray(coords))

    def load_seg_coords(self, t: int) -> np.ndarray:
        return np.load(str(self.seg_dir / f"coords{t:06d}.npy"))

    def save_seg_prob(self, t: int, prob: np.ndarray) -> None:
        self.seg_dir.mkdir(parents=True, exist_ok=True)
        np.save(str(self.seg_dir / f"prob{t:06d}.npy"), np.asarray(prob))

    def load_seg_prob(self, t: int, fmt: str = "prob%06d.npy") -> np.ndarray:
        return np.load(str(self.seg_dir / (fmt % t)))

    def save_coords_real(self, t: int, coords_real: np.ndarray) -> None:
        self.coords_real_dir.mkdir(parents=True, exist_ok=True)
        np.save(str(self.coords_real_dir / ("coords%06d.npy" % t)),
                np.asarray(coords_real))

    def load_coords_real(self, t: int) -> np.ndarray:
        return np.load(str(self.coords_real_dir / ("coords%06d.npy" % t)))

    def save_tracked_labels(self, labels_xyz: np.ndarray, t: int,
                            use_8_bit: bool) -> None:
        save_label_slices(labels_xyz, self.labels_dir,
                          "track_results_t%06i_z%04i.tif", t, use_8_bit)

    def export_coordinates_csv(self, coords_by_t: dict,
                               filename: str = "tracked_coordinates.csv"
                               ) -> Path:
        """A (t, cell, x, y, z) row per cell and volume
        (``tracker.py:1538-1551``); ``coords_by_t``: ``{t: (n, 3) array}``,
        as ``track_timelapse`` returns it."""
        path = self.root / filename
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["t", "cell", "x", "y", "z"])
            for t in sorted(coords_by_t):
                for i, row in enumerate(np.asarray(coords_by_t[t])):
                    w.writerow([t, i + 1, *row.tolist()])
        return path

    def export_activities_csv(self, activities: np.ndarray,
                              filename: str = "activities.csv") -> Path:
        """A row per volume (t from 1) of the (volumes, cells)
        activities."""
        path = self.root / filename
        arr = np.asarray(activities)
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["t"] + [f"cell_{i + 1}" for i in
                                range(arr.shape[1])])
            for t, row in enumerate(arr, start=1):
                w.writerow([t] + row.tolist())
        return path
