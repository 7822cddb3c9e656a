"""Exact Euclidean distance transform, dense, lower-envelope and windowed
methods (counterpart of ``3deecelltracker_tpu/ops/edt.py``).

The squared EDT is separable: the first pass runs straight off the binary
mask with two cumulative index scans; every further pass is a min-plus
reduction over the line, dense or by Felzenszwalb and Huttenlocher's lower
envelope of parabolas.  All distances stay exact integer
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
_ENV_BIG = 1e9   # the envelope pass's finite infinity, raised by the caller
                 # past the largest achievable squared distance


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


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row b's entry ``idx[b]`` of a (B, L) tensor."""
    return torch.gather(x, 1, idx[:, None].long())[:, 0]


def _minplus_pass_envelope(fsq: torch.Tensor, axis: int, w: float,
                           env_big: float = _ENV_BIG) -> torch.Tensor:
    """The exact lower-envelope pass (JAX ``_minplus_pass_envelope``,
    ``edt.py:125``): O(L) amortized work a line.  The hull is built by one
    loop over the line's positions with every line advancing in lockstep,
    each step popping, while any line still must, the parabolas the new
    one overtakes; its breakpoints ``z`` then rise strictly along each
    line, so the parabola that rules position i is found for all lines and
    positions at once by a sorted search (JAX's query scan advances to the
    same one).  The arithmetic is JAX's, in float32."""
    x = _move_last(fsq, axis)
    shape = x.shape
    L = shape[-1]
    dev = x.device
    big = np.float32(env_big)
    f = torch.clamp_max(x.reshape(-1, L), float(big))
    B = f.shape[0]
    w2 = torch.tensor(np.float32(w * w), device=dev)
    iota = torch.arange(L, dtype=torch.float32, device=dev)
    fq_plus = f + w2 * iota[None, :] ** 2
    two_w2 = 2.0 * w2

    def intersect(q, vk):
        num = _take(fq_plus, q) - _take(fq_plus, vk)
        return num / (two_w2 * (q - vk).to(torch.float32))

    rows = torch.arange(B, device=dev)
    k = torch.zeros((B,), dtype=torch.int64, device=dev)
    v = torch.zeros((B, L), dtype=torch.int64, device=dev)
    z = torch.full((B, L), -torch.inf, dtype=torch.float32, device=dev)
    for q in range(1, L):
        qv = torch.full((B,), q, dtype=torch.int64, device=dev)
        while True:
            pop = (k > 0) & (intersect(qv, _take(v, k)) <= _take(z, k))
            if not bool(pop.any()):
                break
            k = torch.where(pop, k - 1, k)
        s = intersect(qv, _take(v, k))
        k = k + 1
        v[rows, k] = q
        z[rows, k] = s
    # j(i) = the last hull entry 1..k whose breakpoint lies below i
    pos = torch.arange(L, device=dev)[None, :]
    zs = torch.where((pos >= 1) & (pos <= k[:, None]), z, torch.inf)
    j = torch.searchsorted(zs[:, 1:].contiguous(),
                           iota[None, :].expand(B, L).contiguous())
    vj = torch.gather(v, 1, j)
    fv = torch.gather(f, 1, vj)
    out = w2 * (iota[None, :] - vj.to(torch.float32)) ** 2 + fv
    out = torch.where(out > big / 2, _INF, out)
    return out.reshape(shape).movedim(-1, axis)


def distance_transform_edt(mask: torch.Tensor,
                           sampling: Optional[Sequence[float]] = None,
                           window: Optional[int] = None,
                           method: str = "dense", *,
                           batch_ndim: int = 0) -> torch.Tensor:
    """Exact EDT: distance from each nonzero voxel to the nearest zero
    voxel, with physical ``sampling`` per axis (JAX ``ops/edt.py:221``).
    ``method``: every pass after the first, ``"dense"`` (O(L^2) a line) or
    ``"envelope"`` (the exact O(L) lower envelope, the same distances up to
    float32 rounding).  ``window``: the search radius in voxels of those
    passes (JAX's windowed method, O(L * window) a line, overriding
    ``method``), exact wherever the true distance is below ``window *
    min(sampling)``.  The first ``batch_ndim`` axes are independent batch
    axes (the JAX package vmaps instead)."""
    nd = mask.dim() - batch_ndim
    if sampling is None:
        sampling = (1.0,) * nd
    sampling = tuple(float(s) for s in sampling)
    if len(sampling) != nd:
        raise ValueError("sampling must have one entry per spatial axis")
    if method not in ("dense", "envelope"):
        raise ValueError(f"method {method!r}")
    fsq = None
    for i, w in enumerate(sampling):
        axis = batch_ndim + i
        if fsq is None:
            fsq = _binary_pass_scan(mask, axis, w)
        elif window is not None:
            fsq = _minplus_pass_windowed(fsq, axis, w, window)
        elif method == "envelope":
            # the sentinel must pass the largest achievable d^2, or large
            # finite distances would saturate where the dense pass is exact
            bound = sum(((n - 1) * s) ** 2
                        for n, s in zip(mask.shape[batch_ndim:], sampling))
            fsq = _minplus_pass_envelope(fsq, axis, w,
                                         max(_ENV_BIG, 16.0 * bound))
        else:
            fsq = _minplus_pass(fsq, axis, w)
    return numerics.sqrt(fsq)
