"""The tiled prediction of a volume too large for one pass, in plain
PyTorch: the reference for the port's ``predict_instances_tiled_device``
maps.

The semantics of stardist's tiled prediction with a margin: each tiled
axis is cut into centres of ``tile - 2 * shrink`` voxels (``shrink``
rounded up, and the tile down, to the network's ``div_by``), the volume is
padded by reflection (numpy's ``"reflect"``, the edge not repeated) by
``shrink`` before and as far as the last tile needs after, each tile of
``tile`` voxels runs through the network alone, and each tile's centre, at
grid resolution, is its part of the volume's maps.  An axis whose tile is
None, or covers it, is one tile of the volume padded to ``div_by`` with no
margin.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from . import stardist_net


def plan(vol: Sequence[int], tile: Sequence, shrink: Sequence[int],
         div: Sequence[int]):
    """(tile sizes, margins, centres, origins) per axis; origins in the
    padded volume, one list per axis."""
    tiles, margins, centres, origins = [], [], [], []
    for v, t, s, d in zip(vol, tile, shrink, div):
        s = -(-int(s) // d) * d
        if t is None or int(t) - 2 * s >= v:
            t, s = -(-v // d) * d, 0
        else:
            t = int(t) // d * d
        c = t - 2 * s
        tiles.append(t)
        margins.append(s)
        centres.append(c)
        origins.append([i * c for i in range(math.ceil(v / c))])
    return tiles, margins, centres, origins


def reflect_index(n: int, before: int, total: int) -> np.ndarray:
    j = np.arange(total) - before
    if n == 1:
        return np.zeros(total, np.int64)
    period = 2 * (n - 1)
    m = np.mod(j, period)
    return np.where(m >= n, period - m, m)


def tiled_maps(cfg: dict, weights, x: torch.Tensor, tile, shrink
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prob (gz, gy, gx), dist (gz, gy, gx, n_rays)) of a normalized
    (z, y, x) volume at grid resolution, tile by tile."""
    grid = cfg["grid"]
    tiles, margins, centres, origins = plan(
        x.shape, tile, shrink, stardist_net.div_by(cfg))
    padded = x
    for ax in range(3):
        total = (len(origins[ax]) * centres[ax] + 2 * margins[ax])
        idx = reflect_index(x.shape[ax], margins[ax], total)
        padded = torch.index_select(padded, ax, torch.from_numpy(idx).to(
            x.device))
    gshape = [-(-v // g) for v, g in zip(x.shape, grid)]
    prob = torch.zeros(gshape, device=x.device)
    dist = torch.zeros(gshape + [cfg["n_rays"]], device=x.device)
    sg = [s // g for s, g in zip(margins, grid)]
    cg = [c // g for c, g in zip(centres, grid)]
    for o0 in origins[0]:
        for o1 in origins[1]:
            for o2 in origins[2]:
                t = padded[o0:o0 + tiles[0], o1:o1 + tiles[1],
                           o2:o2 + tiles[2]]
                p, d = stardist_net.forward(cfg, weights, t[None])
                og = [o // g for o, g in zip((o0, o1, o2), grid)]
                ext = [min(c, gs - v) for c, gs, v in zip(cg, gshape, og)]
                src = tuple(slice(s, s + e) for s, e in zip(sg, ext))
                dst = tuple(slice(v, v + e) for v, e in zip(og, ext))
                prob[dst] = p[0][src]
                dist[dst] = d[0][src]
    return prob, dist
