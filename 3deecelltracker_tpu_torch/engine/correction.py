"""Boundary-cell flagging and the accurate-correction loop (counterpart of
``3deecelltracker_tpu/engine/correction.py``), and the correction half of a
tracking step that every driver shares (:func:`correct_prediction`).

The JAX ``while_loop`` becomes a Python loop whose state freezes under a
device-side ``done`` flag once the loop condition fails; the host reads the
flag only every ``CHECK_EVERY`` iterations, so the loop ends at the same
iteration as JAX's without a sync per iteration.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.segment_reduce import center_of_mass
from ..ops.subregions import SubregionAtlas, move_cells_sampled
from ..ops.watershed import recalculate_cell_boundaries

CHECK_EVERY = 4


def get_cells_on_boundary(coordinates_real: torch.Tensor,
                          image_shape: Tuple[int, int, int],
                          voxel_size: Tuple[float, float, float],
                          ensemble: bool = False,
                          boundary_xy: int = 6) -> torch.Tensor:
    """Per-cell boundary mask, the reference formula with its units
    asymmetry (lower bound in real units, upper bound scaled)."""
    b = 0.0 if ensemble else boundary_xy * 1.0
    x_siz, y_siz, z_siz = image_shape
    vx, vy, vz = voxel_size
    c = coordinates_real
    return ((c[:, 0] < b) | (c[:, 1] < b)
            | (c[:, 0] > (x_siz - b) * vx)
            | (c[:, 1] > (y_siz - b) * vy)
            | (c[:, 2] < 0) | (c[:, 2] > z_siz * vz))


def accurate_correction_loop(atlas: SubregionAtlas,
                             coord_vol1_raw: torch.Tensor,
                             coords_raw: torch.Tensor,
                             prob_img: torch.Tensor,
                             boundary_mask: torch.Tensor,
                             max_repetition: int = 20):
    """Refine raw cell centres against the probability map until the max
    signed interp delta is < 0.5 or ``max_repetition`` rounds.  Returns
    (corrected_raw (n, 3) f32, labels (x, y, z) int32, overlap count,
    iterations as a 0-d int32 tensor)."""
    dev = coords_raw.device
    f = float(atlas.interpolation_factor)
    interp_scale = torch.tensor((1.0, 1.0, f), dtype=torch.float32,
                                device=dev)
    include = ~boundary_mask & atlas.valid
    n = atlas.n_cells

    def displacement(coords):
        return torch.round((coords - coord_vol1_raw) * interp_scale
                           ).to(torch.int32)

    def one_round(coords):
        labels, overlap = move_cells_sampled(atlas, displacement(coords),
                                             include)
        markers = torch.where(overlap > 1, 0, labels)
        centers = center_of_mass(prob_img, markers, n)
        lost = torch.isnan(centers[:, 0])
        return torch.where(lost[:, None], torch.round(coords), centers)

    coords = coords_raw.to(torch.float32)
    delta_max = torch.tensor(torch.inf, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = False
    while not done:
        for _ in range(CHECK_EVERY):
            active = (it < max_repetition) & ~(delta_max < 0.5)
            new = one_round(coords)
            delta = torch.round((new - coords) * interp_scale)
            new_max = torch.max(torch.where(atlas.valid[:, None], delta,
                                            -torch.inf))
            coords = torch.where(active, new, coords)
            delta_max = torch.where(active, new_max, delta_max)
            it = it + active.to(torch.int32)
        done = not bool((it < max_repetition) & ~(delta_max < 0.5))
    labels, overlap = move_cells_sampled(atlas, displacement(coords),
                                         include)
    return coords, labels, overlap, it


def correct_prediction(atlas: SubregionAtlas, coord_vol1_raw: torch.Tensor,
                       pred_raw: torch.Tensor, pred_real: torch.Tensor,
                       prob_img: torch.Tensor,
                       image_shape: Tuple[int, int, int],
                       voxel_size: Tuple[float, float, float],
                       ensemble: bool = False, max_repetition: int = 20,
                       boundary_xy: int = 6):
    """A tracking step's correction half (the JAX ``_track_correct_body``
    after ``track_step``, and ``CoordsToImageTransformer.
    accurate_correction``): flag the boundary cells of the prediction
    (none at x/y in ensemble mode), refine its centres against the
    full-resolution f32 ``prob_img`` and redraw the cell boundaries.
    Returns (corrected raw (n, 3), labels (x, y, z) int32, correction
    iterations)."""
    boundary = get_cells_on_boundary(pred_real, image_shape, voxel_size,
                                     ensemble=ensemble,
                                     boundary_xy=boundary_xy)
    corrected_raw, labels, overlap, n_corr = accurate_correction_loop(
        atlas, coord_vol1_raw, pred_raw, prob_img, boundary,
        max_repetition=max_repetition)
    return corrected_raw, recalculate_cell_boundaries(
        labels, overlap, sampling_xy=tuple(voxel_size[:2])), n_corr
