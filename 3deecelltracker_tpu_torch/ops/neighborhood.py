"""Shift-based neighbourhoods (counterpart of
``3deecelltracker_tpu/ops/neighborhood.py``)."""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import torch


def neighbor_offsets(ndim: int, connectivity: int) -> List[Tuple[int, ...]]:
    """scipy/skimage-style neighbour offsets: 1 <= sum(|d|) <= connectivity,
    |d_i| <= 1, in ``itertools.product`` order."""
    offs = []
    for d in itertools.product((-1, 0, 1), repeat=ndim):
        s = sum(abs(v) for v in d)
        if 1 <= s <= connectivity:
            offs.append(d)
    return offs


def shift(x: torch.Tensor, offset: Sequence[int], fill) -> torch.Tensor:
    """Shifted copy: y[v] = x[v + offset], ``fill`` outside the array."""
    out = torch.full_like(x, fill)
    src = [slice(None)] * x.dim()
    dst = [slice(None)] * x.dim()
    for axis, d in enumerate(offset):
        n = x.shape[axis]
        if abs(d) >= n:
            return out
        if d > 0:
            src[axis], dst[axis] = slice(d, n), slice(0, n - d)
        elif d < 0:
            src[axis], dst[axis] = slice(0, n + d), slice(-d, n)
    out[tuple(dst)] = x[tuple(src)]
    return out
