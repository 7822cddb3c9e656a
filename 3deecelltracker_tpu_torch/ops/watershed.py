"""Marker watershed by minimax flooding and the legacy instance splitting
(counterpart of ``3deecelltracker_tpu/ops/watershed.py``).

``recalculate_cell_boundaries`` reassigns overlap regions to the nearest
cell with one 2-D flood per z-slice, and ``watershed_2d`` splits touching
cells slice by slice the same way; that per-slice flood is the hand-written
CUDA kernel (``ops.hopper_flood.flood_slices``), and ``watershed_2d``'s
per-slice peak labelling is the CUDA connected-components kernel
(``ops.hopper_cc.cc_label``), as is ``watershed_3d``'s 3-D one.  The 3-D
6-neighbour flood of ``watershed_3d`` has no Pallas counterpart in the JAX
package and stays the plain ``flood_plain``.  The JAX package vmaps its 2-D
steps over z; here z is a batch axis of (z, x, y) tensors.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .connected import label_components_raw, relabel_sequential
from .edt import distance_transform_edt
from .filters import gaussian_filter
from .hopper_flood import flood_plain, flood_slices
from .neighborhood import neighbor_offsets, shift
from .peaks import peak_local_max_mask


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


def find_boundaries_outer(labels: torch.Tensor, connectivity: int,
                          batch_ndim: int = 0) -> torch.Tensor:
    """skimage ``find_boundaries(mode='outer')``: background voxels next to
    an object, and object voxels next to a different nonzero label.  The
    first ``batch_ndim`` axes are independent images."""
    spatial = labels.dim() - batch_ndim
    bg = labels == 0
    any_fg = torch.zeros_like(bg)
    diff = torch.zeros_like(bg)
    for off in neighbor_offsets(spatial, connectivity):
        n = shift(labels, (0,) * batch_ndim + off, 0)
        any_fg |= n > 0
        diff |= (n > 0) & (n != labels)
    return (bg & any_fg) | (~bg & diff)


def bincount_capped(labels: torch.Tensor, length: int) -> torch.Tensor:
    """``jnp.bincount(labels.ravel(), length=length)``: ids at or above
    ``length`` are dropped (``torch.bincount`` would grow instead); a
    scatter-add, with no host sync."""
    flat = labels.reshape(-1).long()
    counts = torch.zeros((length + 1,), dtype=torch.int64,
                         device=labels.device)
    counts.index_add_(0, torch.clamp(flat, 0, length),
                      torch.ones_like(flat))
    return counts[:length]


def remove_small_objects(labels: torch.Tensor,
                         min_size: Union[int, torch.Tensor],
                         max_labels: int = 4096) -> torch.Tensor:
    """Zero the labels whose voxel count is below ``min_size`` (skimage
    ``remove_small_objects`` on a labeled image), with the JAX twin's
    ``max_labels`` cap: ids above it are not counted, and ``keep[labels]``
    clamps them to the entry of ``max_labels`` itself."""
    keep = bincount_capped(labels, max_labels + 1) >= min_size
    keep[0] = False
    return torch.where(keep[torch.clamp(labels.long(), 0, max_labels)],
                       labels, 0)


def watershed_2d(image_pred: torch.Tensor, min_distance: int = 7,
                 max_iters: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-z 2-D watershed splitting (reference ``watershed.py:16-52``) of
    an (x, y, z) probability map: per slice, EDT of ``pred > 0.5``, blur
    (sigma 2), peaks (window 2 min_distance + 1, border excluded), 8-conn
    peak components as markers, 4-neighbour flood on the negated blur, outer
    boundaries (8-conn).  Returns (cells with boundaries carved out,
    boundary mask), bool (x, y, z)."""
    pred = image_pred.permute(2, 0, 1)                       # (z, x, y)
    bn = pred > 0.5
    dist = distance_transform_edt(bn, (1.0, 1.0), batch_ndim=1)
    dist_smooth = gaussian_filter(dist, 2.0, batch_ndim=1)
    peaks = peak_local_max_mask(dist_smooth, min_distance=min_distance,
                                batch_ndim=1)
    markers = label_components_raw(peaks.permute(1, 2, 0).contiguous(),
                                   per_slice=True)
    ws, _ = flood_slices((-dist_smooth).permute(1, 2, 0).contiguous(),
                         markers, bn.permute(1, 2, 0).contiguous(),
                         max_iters=max_iters)
    boundary = find_boundaries_outer(ws.permute(2, 0, 1), connectivity=2,
                                     batch_ndim=1).permute(1, 2, 0)
    return (image_pred > 0.5) & ~boundary, boundary


def watershed_3d(image_watershed2d: torch.Tensor,
                 samplingrate: Tuple[float, float, float],
                 method: str = "min_size", min_size: int = 100,
                 cell_num: int = 0, min_distance: int = 3,
                 max_labels: int = 1024, max_iters: int = 512):
    """3-D anisotropic watershed + size filtering (reference
    ``watershed.py:55-108``): EDT with ``samplingrate``, blur (2, 2, 0.3),
    peaks (no border exclusion), 26-conn peak components relabeled 1..K as
    markers, 6-neighbour flood, then ``remove_small_objects`` by
    ``min_size`` (method "min_size") or by the size of the
    (``cell_num`` + 1)-th largest label (method "cell_num").  Returns
    (labels without boundaries, labels with them, min_size, cell_num); the
    last two are 0-d tensors, as data-dependent as the reference's."""
    if method not in ("min_size", "cell_num"):
        raise ValueError("method must be 'min_size' or 'cell_num'")
    mask = image_watershed2d != 0
    dist = distance_transform_edt(mask, tuple(float(s) for s in samplingrate))
    dist_smooth = gaussian_filter(dist, (2.0, 2.0, 0.3))
    peaks = peak_local_max_mask(dist_smooth, min_distance=min_distance,
                                exclude_border=0)
    markers = relabel_sequential(label_components_raw(peaks))
    labels_ws = watershed_flood(-dist_smooth, markers, mask, connectivity=1,
                                max_iters=max_iters)
    sorted_counts = torch.sort(bincount_capped(labels_ws,
                                               max_labels + 1)).values
    if method == "min_size":
        min_size_val = torch.tensor(int(min_size), device=mask.device)
        cell_num_val = torch.sum(sorted_counts >= min_size_val) - 1
    else:
        min_size_val = sorted_counts[-int(cell_num) - 1]
        cell_num_val = torch.tensor(int(cell_num), device=mask.device)
    labels_clear = remove_small_objects(labels_ws, min_size_val, max_labels)
    boundary = find_boundaries_outer(labels_clear, connectivity=3)
    labels_wo_bd = remove_small_objects(
        torch.where(boundary, 0, labels_clear), min_size_val, max_labels)
    return labels_wo_bd, labels_clear, min_size_val, cell_num_val
