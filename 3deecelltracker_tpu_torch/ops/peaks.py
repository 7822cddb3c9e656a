"""Local maxima (counterpart of ``3deecelltracker_tpu/ops/peaks.py::
peak_local_max_mask``, skimage ``peak_local_max`` with ``indices=False``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _window_max(img: torch.Tensor, k: int, axes) -> torch.Tensor:
    """Max over a centred ``k``-wide window along each of ``axes``, -inf
    outside the array (the JAX ``reduce_window`` max with SAME padding;
    a box max is separable, and exact)."""
    out = img
    for axis in axes:
        moved = out.movedim(axis, -1)
        shape = moved.shape
        pooled = F.max_pool1d(moved.reshape(-1, 1, shape[-1]), k, stride=1,
                              padding=k // 2)
        out = pooled.reshape(shape).movedim(-1, axis)
    return out


def peak_local_max_mask(image: torch.Tensor, min_distance: int = 1,
                        exclude_border: Optional[int] = None,
                        batch_ndim: int = 0) -> torch.Tensor:
    """Bool mask of voxels equal to the max of their (2 min_distance + 1)
    window and above the image minimum; plateaus are all marked.
    ``exclude_border`` (default ``min_distance``) clears peaks that close
    to the edge.  The first ``batch_ndim`` axes are independent
    images (the JAX package vmaps instead), each with its own minimum."""
    if exclude_border is None:
        exclude_border = min_distance
    k = 2 * int(min_distance) + 1
    img = image.to(torch.float32)
    spatial = range(batch_ndim, img.dim())
    maxf = _window_max(img, k, spatial)
    thresh = torch.amin(img, dim=tuple(spatial), keepdim=True)
    mask = (img == maxf) & (img > thresh)
    if exclude_border:
        b = int(exclude_border)
        interior = torch.zeros_like(mask)
        idx = (slice(None),) * batch_ndim + tuple(
            slice(b, img.shape[a] - b) for a in spatial)
        interior[idx] = True
        mask = mask & interior
    return mask
