"""Star-convex polyhedra rasterised into a label volume, in plain PyTorch:
the reference for the labels that the port's segmentation renders.

stardist's semantics: a polyhedron is a centre and one distance per ray of
stardist's golden-spiral ray set (``Rays_GoldenSpiral``, unit directions in
(z, y, x) scaled by ``1 / anisotropy`` and normalised again); a voxel is
inside when its distance from the centre is at most the distance of the
ray nearest to its direction (largest dot product, the first ray on a tie).
Instances are numbered 1, 2, ... by descending probability (stable), and
where two overlap the lower number wins.  Each instance is drawn inside a
box of ``box`` voxels whose corner is ``round(centre - (box - 1) / 2)``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def golden_spiral(n: int, anisotropy: Sequence[float]) -> np.ndarray:
    """(n, 3) float32 unit ray directions in (z, y, x)."""
    s = 3.6 / np.sqrt(n)
    dz = 2.0 / n
    z = 1.0 - dz / 2.0
    lon = 0.0
    out = np.empty((n, 3), np.float64)
    for k in range(n):
        r = np.sqrt(max(1.0 - z * z, 0.0))
        out[k] = (z, r * np.sin(lon), r * np.cos(lon))
        z -= dz
        lon += s / max(r, 1e-12)
    out /= np.asarray(anisotropy, np.float64)
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    return out.astype(np.float32)


def render(points: torch.Tensor, dists: torch.Tensor, probs: torch.Tensor,
           rays: torch.Tensor, shape: Tuple[int, int, int],
           box: Tuple[int, int, int], chunk: int = 256) -> torch.Tensor:
    """int32 (z, y, x) labels of the polyhedra at integer ``points`` (C, 3)
    with ``dists`` (C, R) and ``probs`` (C,)."""
    dev = points.device
    n = points.shape[0]
    order = torch.argsort(-probs, stable=True)
    ids = torch.empty(n, dtype=torch.int64, device=dev)
    ids[order] = torch.arange(1, n + 1, device=dev)
    half = torch.tensor([(b - 1) / 2.0 for b in box], device=dev)
    grid = torch.stack(torch.meshgrid(
        *(torch.arange(b, device=dev) for b in box), indexing="ij"),
        dim=-1).reshape(-1, 3)                                  # (V, 3)
    off = grid.float() - half
    d = torch.sqrt((off * off).sum(-1))
    dirs = off / torch.clamp_min(d, 1e-12)[:, None]
    nearest = torch.argmax(dirs @ rays.T, dim=-1)               # (V,)
    big = torch.iinfo(torch.int64).max
    size = shape[0] * shape[1] * shape[2]
    out = torch.full((size,), big, dtype=torch.int64, device=dev)
    lim = torch.tensor(shape, device=dev)
    for s in range(0, n, chunk):
        p = points[s:s + chunk].float()
        corner = torch.round(p - half).long()
        vox = corner[:, None, :] + grid[None]                   # (c, V, 3)
        inside = (d[None] <= dists[s:s + chunk][:, nearest]) & \
            ((vox >= 0) & (vox < lim)).all(-1)
        flat = (vox[..., 0] * shape[1] + vox[..., 1]) * shape[2] \
            + vox[..., 2]
        vals = ids[s:s + chunk, None].expand_as(flat)
        out.scatter_reduce_(0, flat[inside], vals[inside], "amin")
    out = torch.where(out == big, 0, out)
    return out.reshape(shape).to(torch.int32)
