"""Tile-and-stitch sliding-window inference (counterpart of
``3deecelltracker_tpu/ops/tiling.py``: ``plan_tiles``, ``pad_for_tiles``,
``extract_tiles``, ``stitch_tiles``).

Reflect-pad the volume by ``shrink``, cut overlapping tiles whose centres
(``tile - 2 * shrink``) partition the padded interior, run the network on
the whole tile batch at once, keep each tile's centre and stitch them back
with a reshape.  The plan is pure numpy, so both packages share its
arithmetic.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


class TilePlan(NamedTuple):
    """Static tiling geometry for one volume shape."""
    vol_shape: Tuple[int, int, int]
    tile_shape: Tuple[int, int, int]       # network input size per axis
    center_shape: Tuple[int, int, int]     # tile - 2 * shrink
    shrink: Tuple[int, int, int]
    num_tiles: Tuple[int, int, int]        # tiles per axis
    padded_shape: Tuple[int, int, int]     # including shrink borders
    origins: np.ndarray                    # (n_total, 3) int32 tile origins


def plan_tiles(vol_shape: Sequence[int], tile_shape: Sequence[int],
               shrink: Sequence[int]) -> TilePlan:
    """The static tile layout (reference ``unet3d.py:259-279``)."""
    vol_shape = tuple(int(s) for s in vol_shape)
    tile_shape = tuple(int(s) for s in tile_shape)
    shrink = tuple(int(s) for s in shrink)
    center = tuple(t - 2 * s for t, s in zip(tile_shape, shrink))
    if any(c <= 0 for c in center):
        raise ValueError(f"shrink {shrink} too large for tile {tile_shape}")
    nums = tuple(int(math.ceil(v / c)) for v, c in zip(vol_shape, center))
    padded = tuple(n * c + 2 * s for n, c, s in zip(nums, center, shrink))
    grids = np.meshgrid(*[np.arange(n) * c for n, c in zip(nums, center)],
                        indexing="ij")
    origins = np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)
    return TilePlan(vol_shape, tile_shape, center, shrink, nums, padded,
                    origins)


def _reflect_index(n: int, before: int, total: int) -> np.ndarray:
    """Source index of each padded position for ``np.pad(mode='reflect')``
    (mirror without repeating the edge), for pads of any length."""
    j = np.arange(total) - before
    if n == 1:
        return np.zeros(total, np.int64)
    period = 2 * (n - 1)
    m = np.mod(j, period)
    return np.where(m >= n, period - m, m)


def pad_for_tiles(img: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Reflect-pad like ``np.pad(..., 'reflect')`` (``unet3d.py:235``)."""
    out = img
    for ax in range(3):
        idx = _reflect_index(plan.vol_shape[ax], plan.shrink[ax],
                             plan.padded_shape[ax])
        out = torch.index_select(out, ax, torch.from_numpy(idx).to(
            img.device))
    return out


def extract_tiles(padded: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """All (overlapping) tiles as one (n_tiles, *tile_shape) batch."""
    tx, ty, tz = plan.tile_shape
    return torch.stack([padded[x:x + tx, y:y + ty, z:z + tz]
                        for x, y, z in plan.origins.tolist()])


def stitch_tiles(tile_outputs: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """Stitch the centre regions of (n_tiles, *tile_shape) outputs back into
    the volume: the centres partition the padded interior, so this is a
    reshape and a transpose."""
    sx, sy, sz = plan.shrink
    cx, cy, cz = plan.center_shape
    centers = tile_outputs[:, sx:sx + cx, sy:sy + cy, sz:sz + cz]
    nx, ny, nz = plan.num_tiles
    grid = centers.reshape(nx, ny, nz, cx, cy, cz)
    full = grid.permute(0, 3, 1, 4, 2, 5).reshape(nx * cx, ny * cy, nz * cz)
    vx, vy, vz = plan.vol_shape
    return full[:vx, :vy, :vz]
