"""Shift-based neighbourhoods (counterpart of
``3deecelltracker_tpu/ops/neighborhood.py``)."""

from __future__ import annotations

import itertools
from typing import Callable, List, Sequence, Tuple

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


def neighbor_reduce(x: torch.Tensor, offsets, fill,
                    reduce_fn: Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor],
                    include_self: bool = False) -> torch.Tensor:
    """Reduce over shifted copies: out[v] = reduce over d of x[v + d],
    ``fill`` outside the array, in ``offsets`` order after ``x`` itself
    when ``include_self``."""
    acc = x if include_self else None
    for off in offsets:
        shifted = shift(x, off, fill)
        acc = shifted if acc is None else reduce_fn(acc, shifted)
    return acc


def neighbor_max(x, connectivity=None, offsets=None, fill=-torch.inf,
                 include_self=False):
    """The neighbourhood maximum (``connectivity``'s offsets unless
    ``offsets`` are given)."""
    if offsets is None:
        offsets = neighbor_offsets(x.dim(), connectivity)
    return neighbor_reduce(x, offsets, fill, torch.maximum, include_self)


def neighbor_min(x, connectivity=None, offsets=None, fill=torch.inf,
                 include_self=False):
    """The neighbourhood minimum (``connectivity``'s offsets unless
    ``offsets`` are given)."""
    if offsets is None:
        offsets = neighbor_offsets(x.dim(), connectivity)
    return neighbor_reduce(x, offsets, fill, torch.minimum, include_self)
