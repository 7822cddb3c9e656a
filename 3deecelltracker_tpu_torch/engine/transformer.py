"""Vol-1 labels -> subregion atlas and cell coordinates (counterpart of
``3deecelltracker_tpu/engine/transformer.py``: ``upsample_prob_pipeline``,
``load_segmentation_array``, ``interpolate`` without its disk writes)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..coordinates import Coordinates
from ..ops.connected import label_components_values
from ..ops.segment_reduce import center_of_mass, find_objects_bounds
from ..ops.subregions import (SubregionAtlas, build_subregion_atlas,
                              move_cells_sampled)
from ..ops.watershed import recalculate_cell_boundaries
from ..utils.device import select_device

BOUNDARY_XY = 6  # reference tracker.py:47


def upsample_prob_pipeline(prob_grid_xyz: torch.Tensor,
                           grid: Tuple[int, int, int],
                           out_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Grid-resolution (x, y, z) prob map -> full resolution: repeat axis
    0 by grid[1], axis 1 by grid[2], axis 2 by grid[0], then crop."""
    out = prob_grid_xyz
    for axis, g in enumerate((grid[1], grid[2], grid[0])):
        if g > 1:
            out = torch.repeat_interleave(out, int(g), dim=axis)
    return out[:out_shape[0], :out_shape[1], :out_shape[2]]


def _relabel_sequential_np(labels: np.ndarray) -> np.ndarray:
    uniq = np.unique(labels)
    uniq = uniq[uniq != 0]
    remap = np.zeros(int(labels.max()) + 1, labels.dtype)
    remap[uniq] = np.arange(1, len(uniq) + 1)
    return remap[labels]


def _box_shape(labels: torch.Tensor, n_cells: int) -> Tuple[int, int, int]:
    """Largest per-cell bbox extent per axis (at least 1)."""
    mins, maxs = find_objects_bounds(labels, n_cells)
    ext = np.maximum((maxs - mins + 1).cpu().numpy(), 1)
    bx, by, bz = ext.max(axis=0)
    return int(bx), int(by), int(bz)


class CoordsToImageTransformer:
    """Array-in, array-out twin of the JAX transformer for the main path."""

    def __init__(self, voxel_size, device=None):
        self.voxel_size = tuple(float(v) for v in np.asarray(voxel_size))
        self.device = select_device(device)
        self.proofed_segmentation: Optional[np.ndarray] = None
        self.atlas: Optional[SubregionAtlas] = None
        self.auto_corrected_segmentation: Optional[np.ndarray] = None
        self.coord_vol1: Optional[Coordinates] = None
        self.interpolation_factor: int = 1

    def load_segmentation_array(self, seg_xyz: np.ndarray) -> None:
        """Proofed vol-1 labels in the (x, y, z) frame."""
        self.proofed_segmentation = _relabel_sequential_np(
            np.asarray(seg_xyz).astype(np.int32))

    def _extract_regions(self, seg: torch.Tensor, smooth_sigma: float,
                         n_cells: int, box_shape: Tuple[int, int, int]):
        atlas = build_subregion_atlas(
            seg, n_cells=n_cells, box_shape=box_shape,
            interpolation_factor=self.interpolation_factor,
            smooth_sigma=smooth_sigma)
        labels, overlap = move_cells_sampled(atlas)
        return atlas, recalculate_cell_boundaries(
            labels, overlap, sampling_xy=self.voxel_size[:2])

    def interpolate(self, interpolation_factor: int,
                    smooth_sigma: float = 2.5) -> None:
        """Smooth the proofed labels through the z-interpolated atlas, fix
        labelling errors (value-equal connected components), rebuild the
        atlas, and set the vol-1 labels and centre coordinates."""
        if interpolation_factor <= 0:
            raise ValueError("Interpolation factor must be greater than zero.")
        if self.proofed_segmentation is None:
            raise RuntimeError("call load_segmentation_array first")
        self.interpolation_factor = int(interpolation_factor)
        seg = torch.from_numpy(self.proofed_segmentation).to(self.device)
        n_cells0 = int(self.proofed_segmentation.max())
        _, smoothed = self._extract_regions(
            seg, smooth_sigma, n_cells0, _box_shape(seg, n_cells0))

        present = torch.bincount(smoothed.reshape(-1).long(),
                                 minlength=n_cells0 + 1)[1:] > 0
        corrected = label_components_values(smoothed, connectivity=3)
        n_before = int(present.sum())
        n_after = int(corrected.max())
        if n_after != n_before:
            print(f"WARNING: cell count changed {n_before} -> {n_after}; "
                  "segmentation corrected.")
        self.atlas, auto = self._extract_regions(
            corrected, smooth_sigma, n_after, _box_shape(corrected, n_after))
        com = center_of_mass((auto > 0).to(torch.float32), auto, n_after)
        self.auto_corrected_segmentation = auto.cpu().numpy().astype(
            np.int32)
        self.coord_vol1 = Coordinates(com.to(torch.float32),
                                      self.interpolation_factor,
                                      self.voxel_size)
