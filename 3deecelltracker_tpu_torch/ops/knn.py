"""Brute-force kNN and FFN feature vectors (counterpart of
``3deecelltracker_tpu/ops/knn.py``).  Point sets are padded to a static
size with a validity mask; padded points are parked at 1e6.  Every function
also takes a leading member axis, (E, n, 3) points with (E, n) masks: the
ensemble's members in one batch, each member computed as it is alone."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import numerics

_BIG = 1e10


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, m) squared euclidean distances, summed over the coordinates in
    order as a fused multiply-add chain, acc = fma(d_i, d_i, acc).

    That is how XLA evaluates the JAX twin's broadcast sum of squares, and
    the order decides kNN ties: points on the voxel lattice have many
    exactly equidistant neighbours, and a plain sum ranks them by rounding
    noise of its own.  The fma is taken in float64 and rounded once to
    float32 (the f32 product is exact in f64)."""
    d = a[..., :, None, :] - b[..., None, :, :]
    acc = d[..., 0] * d[..., 0]
    for i in range(1, d.shape[-1]):
        di = d[..., i].double()
        acc = (di * di + acc.double()).float()
    return acc


def knn(points: torch.Tensor, mask: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid neighbours of each point (itself first), ascending;
    ties toward the lower index like ``lax.top_k``."""
    d2 = pairwise_sq_dists(points, points)
    d2 = torch.where(mask[..., None, :], d2, _BIG)
    kk = min(k, points.shape[-2])
    srt, idx = torch.sort(d2, dim=-1, stable=True)
    return (numerics.sqrt(torch.clamp_min(srt[..., :kk], 0.0)),
            idx[..., :kk])


def _rows(x: torch.Tensor, idx: torch.Tensor, members: bool
          ) -> torch.Tensor:
    """``x[idx]`` along the point axis; with a member axis (``x`` and
    ``idx`` both (E, ...)) each member indexes its own rows."""
    if not members:
        return x[idx]
    member = torch.arange(idx.shape[0], device=idx.device).view(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[member, idx]


def knn_feature_vectors(points: torch.Tensor, mask: torch.Tensor,
                        k: int = 20) -> torch.Tensor:
    """(n, 3k+1) FFN features: the k nearest valid neighbours' offsets over
    the mean (k+1)-NN distance, plus that mean distance; rows of invalid
    points are zero."""
    n = points.shape[-2]
    kk = min(k + 1, n)
    members = mask.dim() == 2
    dists, idx = knn(points, mask, kk)
    nb_valid = _rows(mask, idx, members)
    dists = torch.where(nb_valid, dists, 0.0)
    n_nb = torch.clamp_min(torch.sum(nb_valid, dim=-1), 1)
    mean_dist = torch.sum(dists, dim=-1) / n_nb
    self_pt = _rows(points, idx[..., 0], members)
    neighbors = _rows(points, idx[..., 1:], members)
    rel = (neighbors - self_pt[..., None, :]) * nb_valid[..., 1:, None] \
        / torch.clamp_min(mean_dist, 1e-12)[..., None, None]
    rel_flat = rel.reshape(rel.shape[:-2] + (3 * (kk - 1),))
    if kk - 1 < k:
        rel_flat = F.pad(rel_flat, (0, 3 * (k - kk + 1)))
    feats = torch.cat([rel_flat, mean_dist[..., None]], dim=-1)
    return torch.where(mask[..., None], feats, 0.0)


def knn_feature_vectors_cross(base: torch.Tensor, query: torch.Tensor,
                              k: int = 20) -> torch.Tensor:
    """The FFN trainer's feature build (JAX ``ops/knn.py:51``): the
    (k+1)-NN of each query point within ``base`` (ties toward the lower
    index), the offsets of neighbours 1..k from the query point over the
    mean (k+1)-NN distance, then that mean distance: (n_query, 3k+1)."""
    kk = min(k + 1, base.shape[0])
    d2 = pairwise_sq_dists(query, base)
    srt, idx = torch.sort(d2, dim=-1, stable=True)
    dists = numerics.sqrt(torch.clamp_min(srt[:, :kk], 0.0))
    mean_dist = torch.mean(dists, dim=1)
    rel = (base[idx[:, 1:kk]] - query[:, None, :]) / mean_dist[:, None, None]
    rel_flat = rel.reshape(query.shape[0], 3 * (kk - 1))
    if kk - 1 < k:
        rel_flat = F.pad(rel_flat, (0, 3 * (k - kk + 1)))
    return torch.cat([rel_flat, mean_dist[:, None]], dim=1)
