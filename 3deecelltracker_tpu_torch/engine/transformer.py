"""Vol-1 labels -> subregion atlas and cell coordinates, and the accurate
correction against a probability map (counterpart of
``3deecelltracker_tpu/engine/transformer.py``: ``upsample_prob_pipeline``,
``load_segmentation`` :73, ``load_segmentation_array``, ``interpolate``
:135-200, ``move_cells`` and ``move_cells_in_3d_image`` :201-216,
``get_cells_on_boundary`` :227, ``load_prob_map`` :235,
``accurate_correction`` :244-281 and ``save_tracking_results``).

The array half builds the atlas from labels in memory.  Given a results
folder, the disk half reads the proofed ``manual_vol1`` TIFFs and writes
what the JAX transformer writes: the vol-1 labels and centres at
``t_start``, then each tracked volume's labels and coordinates."""

from __future__ import annotations

from glob import glob
from pathlib import Path
from typing import Optional, Set, Tuple, Union

import numpy as np
import torch

from ..coordinates import Coordinates
from ..io.artifacts import ResultsTree
from ..io.imageio import PathPattern, imread_stack
from ..models.stardist3d import upsample_prob_map
from ..ops.connected import label_components_values
from ..ops.segment_reduce import center_of_mass, find_objects_bounds
from ..ops.subregions import (SubregionAtlas, build_subregion_atlas,
                              move_cells_full, move_cells_sampled)
from ..ops.watershed import recalculate_cell_boundaries
from ..utils.device import select_device
from ..viz import save_matching_figure, save_merged_labels
from .correction import correct_prediction, get_cells_on_boundary

BOUNDARY_XY = 6  # reference tracker.py:47


def upsample_prob_pipeline(prob_grid_xyz, grid: Tuple[int, int, int],
                           out_shape: Tuple[int, int, int], xp=None):
    """Grid-resolution (x, y, z) prob map -> full resolution: repeat axis
    0 by grid[1], axis 1 by grid[2], axis 2 by grid[0], then crop.
    ``xp``: ``numpy`` or ``torch``, the kind of array computed on and
    returned (default: the input's kind; JAX's ``xp=np`` on the host)."""
    if xp is None:
        xp = torch if isinstance(prob_grid_xyz, torch.Tensor) else np
    out = upsample_prob_map(torch.as_tensor(prob_grid_xyz),
                            (grid[1], grid[2], grid[0]), out_shape)
    return out.cpu().numpy() if xp is np else out


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
    """Twin of the JAX transformer, with its argument order.
    ``results_folder``: the results tree that :meth:`interpolate` and
    :meth:`save_tracking_results` write (None: arrays only).  ``device``:
    the card by default."""

    def __init__(self, results_folder: Union[str, Path, None], voxel_size,
                 *, device=None):
        self.voxel_size = tuple(float(v) for v in np.asarray(voxel_size))
        self.device = select_device(device)
        self.tree = (ResultsTree(results_folder)
                     if results_folder is not None else None)
        self.use_8_bit = True
        self.proofed_segmentation: Optional[np.ndarray] = None
        self.atlas: Optional[SubregionAtlas] = None
        self.auto_corrected_segmentation: Optional[np.ndarray] = None
        self.coord_vol1: Optional[Coordinates] = None
        self.interpolation_factor: int = 1

    def load_segmentation(self, manual_vol_start_path: str) -> None:
        """The proofed vol-1 labels from the z-slice TIFFs that the glob
        ``manual_vol_start_path`` finds, in sorted order."""
        slice_paths = sorted(glob(manual_vol_start_path))
        if not slice_paths:
            raise FileNotFoundError(
                f"No image in {manual_vol_start_path} was found")
        self.load_segmentation_array(imread_stack(slice_paths)
                                     .transpose(1, 2, 0))
        n = int(np.count_nonzero(np.unique(self.proofed_segmentation)))
        print(f"Loaded the proofed segmentations at vol 1 with {n} cells")

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
                    smooth_sigma: float = 2.5, t_start: int = 1) -> None:
        """Smooth the proofed labels through the z-interpolated atlas, fix
        labelling errors (value-equal connected components), rebuild the
        atlas, and set the vol-1 labels and centre coordinates; with a
        results tree, write both as volume ``t_start``."""
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
        self.use_8_bit = int(self.auto_corrected_segmentation.max()) <= 255
        if self.tree is not None:
            self.save_tracking_results(
                self.coord_vol1.real.cpu().numpy(),
                self.auto_corrected_segmentation, t_start)

    # ---- label synthesis (coord_image_transformer.py:269-369) --------------
    def move_cells(self, movements_nx3: Optional[np.ndarray] = None,
                   cells_missed: Optional[Set[int]] = None,
                   full_resolution: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The vol-1 cells of the atlas moved by ``movements_nx3`` (interp
        frame, None: not moved), without the 1-based labels in
        ``cells_missed``: ``(labels, overlap count)`` on the device, on
        the original z slices or, with ``full_resolution``, on the whole
        interpolated canvas (``ops.subregions.move_cells_full``)."""
        include = self._include_mask(cells_missed)
        fn = move_cells_full if full_resolution else move_cells_sampled
        mv = None if movements_nx3 is None else torch.as_tensor(
            np.asarray(movements_nx3), dtype=torch.int32).to(self.device)
        return fn(self.atlas, mv, include)

    def move_cells_in_3d_image(self,
                               movements_nx3: Optional[np.ndarray] = None,
                               cells_missed: Optional[Set[int]] = None
                               ) -> np.ndarray:
        """:meth:`move_cells` on the original z slices, with the cell
        boundaries recalculated where cells overlap: (x, y, z) labels."""
        labels, overlap = self.move_cells(movements_nx3, cells_missed)
        return recalculate_cell_boundaries(
            labels, overlap, sampling_xy=self.voxel_size[:2]).cpu().numpy()

    def _include_mask(self, cells_missed) -> torch.Tensor:
        include = np.ones(self.atlas.n_cells, bool)
        for label in cells_missed or ():
            if 1 <= label <= self.atlas.n_cells:
                include[label - 1] = False
        return torch.from_numpy(include).to(self.device)

    def get_cells_on_boundary(self, coordinates_real_nx3, ensemble: bool,
                              boundary_xy: int = BOUNDARY_XY) -> np.ndarray:
        """1-based labels of the cells at the image boundary
        (``coord_image_transformer.py:371-385``)."""
        mask = get_cells_on_boundary(
            torch.as_tensor(coordinates_real_nx3, dtype=torch.float32),
            self.proofed_segmentation.shape, self.voxel_size,
            ensemble=ensemble, boundary_xy=boundary_xy)
        return np.where(mask.cpu().numpy())[0] + 1

    def load_prob_map(self, t: int, grid: Tuple[int, int, int],
                      fmt: str = "prob%06d.npy") -> np.ndarray:
        """``seg/prob*.npy`` upsampled by the StarDist grid and cropped to
        the vol-1 shape (``coord_image_transformer.py:431-435``), f32."""
        prob = torch.from_numpy(self.tree.load_seg_prob(t, fmt))
        return upsample_prob_pipeline(
            prob, grid, self.proofed_segmentation.shape).to(
                torch.float32).numpy()

    def accurate_correction(self, t: int, grid: Tuple[int, int, int],
                            coords: Coordinates, ensemble: bool,
                            max_repetition: int = 20,
                            format: str = "prob%06d.npy",
                            prob_map: Optional[np.ndarray] = None,
                            prob_map_grid=None,
                            return_device: bool = False):
        """Refine the predicted centres against volume ``t``'s probability
        map and render the corrected labels
        (``coord_image_transformer.py:406-447``).  Returns (corrected
        Coordinates, corrected (x, y, z) labels), the labels a tensor on
        the device with ``return_device=True`` and a numpy array
        otherwise.  The map: ``prob_map_grid`` (the grid-resolution map,
        array or tensor of any float dtype, upsampled on the device), else
        ``prob_map`` (full resolution), else ``seg/`` read through
        :meth:`load_prob_map`.  Ensemble mode flags no cell at the x/y
        boundary (``boundary_xy`` 0, ``engine/correction.py:37``)."""
        dev = self.device
        if prob_map_grid is not None:
            prob = upsample_prob_pipeline(
                torch.as_tensor(prob_map_grid).to(dev), grid,
                self.proofed_segmentation.shape)
        else:
            if prob_map is None:
                prob_map = self.load_prob_map(t, grid, format)
            prob = torch.as_tensor(prob_map).to(dev)
        corrected_raw, labels, _ = correct_prediction(
            self.atlas, self.coord_vol1.raw_f32, coords.raw_f32.to(dev),
            coords.real.to(dev), prob.to(torch.float32),
            self.proofed_segmentation.shape, self.voxel_size,
            ensemble=ensemble, max_repetition=max_repetition,
            boundary_xy=BOUNDARY_XY)
        corrected = Coordinates(corrected_raw, self.interpolation_factor,
                                self.voxel_size)
        if not return_device:
            labels = labels.cpu().numpy()
        return corrected, labels

    def save_tracking_results(self, coords,
                              corrected_labels_image: np.ndarray, t2: int,
                              images_path: Optional[PathPattern] = None,
                              tracker=None, t1: Optional[int] = None) -> None:
        """Volume ``t2``'s tracked coordinates (``coords_real/``, real
        units; ``coords`` a :class:`Coordinates` or an (n, 3) real array)
        and labels (``labels/``, uint8 when vol 1 has at most 255 cells,
        else uint16, LZW); given the recording, also the labels over the
        raw volume (``viz.save_merged_labels``), which, as in the JAX
        package, never stops tracking when it fails.  Given both
        ``tracker`` (a ``TrackerLite`` over this tree) and ``t1``, also the
        matching figure ``track_results/figure/matching_<t2>.png``
        (``viz.save_matching_figure``: the confirmed cells of ``t1`` as
        written in ``coords_real/``, the segmented cells of ``t2``, and
        ``coords``), which, as in JAX, prints "matching figure skipped"
        where it fails."""
        if isinstance(coords, Coordinates):
            coords = coords.real.cpu().numpy()
        self.tree.save_coords_real(t2, np.asarray(coords))
        self.tree.save_tracked_labels(corrected_labels_image, t2,
                                      self.use_8_bit)
        if images_path is not None:
            try:
                save_merged_labels(self.tree, corrected_labels_image,
                                   images_path, t2,
                                   self.interpolation_factor)
            except Exception as e:      # a figure, not a result
                print(f"merged-label figure skipped: {e!r}")
        if tracker is not None and t1 is not None:
            # the reference's matching figure
            # (coord_image_transformer.py:516-522)
            try:
                seg_t2 = tracker._get_segmented_pos(t2)
                save_matching_figure(self.tree, self.tree.load_coords_real(
                    t1), seg_t2.real.cpu().numpy(), np.asarray(coords),
                    t1, t2)
            except Exception as e:
                print(f"matching figure skipped: {e}")
