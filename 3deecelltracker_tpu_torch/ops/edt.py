"""Exact Euclidean distance transform, dense and windowed methods
(counterpart of ``3deecelltracker_tpu/ops/edt.py:59-88`` and ``:221-267``).

The squared EDT is separable: the first pass runs straight off the binary
mask with two cumulative index scans; every further pass is a dense
min-plus reduction over the line.  All distances stay exact integer
squares (times the squared sampling) until the final square root, because
the watershed flood compares costs with ``==``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import numerics

_INF = 1e20
_CHUNK_ELEMS = 1 << 24


def _move_last(x: torch.Tensor, axis: int) -> torch.Tensor:
    return x.movedim(axis, -1)


def _binary_pass_scan(mask: torch.Tensor, axis: int, w: float
                      ) -> torch.Tensor:
    """fsq[i] = (w * distance to the nearest zero along the line)^2."""
    x = _move_last(mask != 0, axis)
    L = x.shape[-1]
    idx = torch.arange(L, dtype=torch.int32, device=x.device)
    big = 2 * L
    left = torch.cummax(torch.where(x, -1, idx), dim=-1).values
    right = torch.flip(torch.cummin(torch.flip(torch.where(x, big, idx),
                                               [-1]), dim=-1).values, [-1])
    d = torch.minimum(torch.where(left < 0, big, idx - left),
                      torch.where(right >= big, big, right - idx))
    wf = torch.tensor(w, dtype=torch.float32, device=x.device)
    fsq = torch.where(x, (d.to(torch.float32) * wf) ** 2, 0.0)
    fsq = torch.where(fsq > _INF / 2, _INF, fsq)
    fsq = torch.where(x & (left < 0) & (right >= big), _INF, fsq)
    return fsq.movedim(-1, axis)


def _minplus_pass(fsq: torch.Tensor, axis: int, w: float) -> torch.Tensor:
    """fsq'[..., i] = min_j fsq[..., j] + (w (i - j))^2, dense and chunked
    over lines."""
    x = _move_last(fsq, axis)
    shape = x.shape
    L = shape[-1]
    flat = x.reshape(-1, L)
    ii = np.arange(L, dtype=np.float32)
    cost = torch.from_numpy(((ii[:, None] - ii[None, :]) * np.float32(w))
                            ** 2).to(fsq.device)
    chunk = max(1, _CHUNK_ELEMS // max(1, L * L))
    out = torch.cat([torch.amin(rows[:, None, :] + cost[None], dim=-1)
                     for rows in torch.split(flat, chunk)])
    return out.reshape(shape).movedim(-1, axis)


def _minplus_pass_windowed(fsq: torch.Tensor, axis: int, w: float,
                           window: int) -> torch.Tensor:
    """fsq'[..., i] = min over |d| <= window of fsq[..., i + d] + (w d)^2,
    the d = 0 term first and then d = -W..W in order, as JAX's scan
    takes them."""
    x = _move_last(fsq, axis)
    L = x.shape[-1]
    W = min(int(window), L - 1)
    xp = torch.nn.functional.pad(x, (W, W), value=_INF)
    costs = (np.arange(-W, W + 1, dtype=np.float32) * np.float32(w)) ** 2
    best = x + float(costs[W])
    for k in range(2 * W + 1):
        best = torch.minimum(best, xp[..., k:k + L] + float(costs[k]))
    return best.movedim(-1, axis)


def distance_transform_edt(mask: torch.Tensor,
                           sampling: Optional[Sequence[float]] = None,
                           batch_ndim: int = 0,
                           window: Optional[int] = None) -> torch.Tensor:
    """Exact EDT: distance from each nonzero voxel to the nearest zero
    voxel, with physical ``sampling`` per axis.  The first ``batch_ndim``
    axes are independent batch axes (the JAX package vmaps instead).
    ``window``: the search radius in voxels of every pass after the first
    (JAX's windowed method, O(L * window) a line), exact wherever the true
    distance is below ``window * min(sampling)``."""
    nd = mask.dim() - batch_ndim
    if sampling is None:
        sampling = (1.0,) * nd
    sampling = tuple(float(s) for s in sampling)
    if len(sampling) != nd:
        raise ValueError("sampling must have one entry per spatial axis")
    fsq = None
    for i, w in enumerate(sampling):
        axis = batch_ndim + i
        if fsq is None:
            fsq = _binary_pass_scan(mask, axis, w)
        elif window is not None:
            fsq = _minplus_pass_windowed(fsq, axis, w, window)
        else:
            fsq = _minplus_pass(fsq, axis, w)
    return numerics.sqrt(fsq)
