"""Marker watershed by minimax flooding (counterpart of
``3deecelltracker_tpu/ops/watershed.py:38-90``, ``:200-220``).

``recalculate_cell_boundaries`` reassigns overlap regions to the nearest
cell with one 2-D flood per z-slice; the per-slice flood is the hand-written
CUDA kernel (``ops.hopper_flood.flood_slices``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .edt import distance_transform_edt
from .hopper_flood import flood_plain, flood_slices
from .neighborhood import neighbor_offsets


def watershed_flood(elevation: torch.Tensor, markers: torch.Tensor,
                    mask: torch.Tensor, connectivity: int = 1,
                    max_iters: int = 512) -> torch.Tensor:
    """Flood ``markers`` over ``elevation`` within ``mask`` (any ndim),
    skimage ``watershed(image, markers, mask=mask)`` semantics with the
    minimax (cost, hops) formulation."""
    offsets = neighbor_offsets(elevation.dim(), connectivity)
    return flood_plain(elevation, markers, mask, offsets, max_iters)[0]


def recalculate_cell_boundaries(segmentation_xyz: torch.Tensor,
                                cell_overlaps_mask: torch.Tensor,
                                sampling_xy: Tuple[float, float] = (1.0,
                                                                    1.0),
                                max_iters: int = 512) -> torch.Tensor:
    """Reassign overlap regions (mask > 1) to the nearest cell by a 2-D
    watershed in every z-slice of an (x, y, z) volume."""
    over = cell_overlaps_mask > 1
    mask_image = (segmentation_xyz > 0) | over
    markers = torch.where(over, 0, segmentation_xyz).to(torch.int32)
    # per-slice EDT with z as the batch axis
    distance_map = distance_transform_edt(
        over.permute(2, 0, 1), sampling_xy, batch_ndim=1).permute(1, 2, 0)
    labels, _ = flood_slices(distance_map.contiguous(), markers, mask_image,
                             max_iters=max_iters)
    return labels
