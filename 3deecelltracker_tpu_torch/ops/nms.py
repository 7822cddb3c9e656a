"""Star-convex polyhedron NMS and label rendering (counterpart of
``3deecelltracker_tpu/ops/nms.py:93-275``).

1. ``overlap_matrix``: quasi-Monte-Carlo overlaps, volume-weighted samples,
   restricted to each candidate's nearest and the prob-strongest
   candidates;
2. ``greedy_nms``: sequential suppression in descending probability;
3. ``render_polyhedra_labels``: kept polyhedra rasterised into a label
   volume, the higher-probability instance winning overlaps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.stardist3d import stable_topk_desc
from . import numerics
from .rays import (nearest_ray, radius_gather, radius_toward,
                   sample_directions_fibonacci)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return numerics.sqrt(torch.sum(v * v, dim=-1))


def overlap_matrix(centers: torch.Tensor, dists: torch.Tensor,
                   rays: torch.Tensor, valid: torch.Tensor,
                   n_samples: int = 64, n_fracs: int = 4,
                   neighbor_limit: int = 32,
                   prob: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(k, k) overlap[i, j] ~ |P_i cap P_j| / |P_j| from ``n_samples``
    quasi-MC directions x ``n_fracs`` cube-root-uniform radius fractions
    (see the JAX twin for the sampling and the neighbour restriction)."""
    k = centers.shape[0]
    dev = centers.device
    dirs = torch.from_numpy(sample_directions_fibonacci(n_samples)).to(dev)
    fr = torch.from_numpy((((np.arange(n_fracs) + 0.5) / n_fracs)
                           ** (1.0 / 3.0)).astype(np.float32)).to(dev)
    r = radius_toward(dists, rays, dirs)                        # (k, s)
    pts = centers[:, None, None, :] + \
        (r[:, :, None, None] * fr[None, None, :, None]) * \
        dirs[None, :, None, :]
    pts = pts.reshape(k, -1, 3)                                 # (k, s*f, 3)
    w = torch.repeat_interleave(r ** 3, n_fracs, dim=1)         # (k, s*f)
    w_norm = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-20)

    if neighbor_limit and neighbor_limit < k:
        m = neighbor_limit
        d2 = torch.sum((centers[:, None, :] - centers[None, :, :]) ** 2, -1)
        d2 = torch.where(valid[None, :], d2, torch.inf)
        # lax.top_k(-d2, m): ascending d2, ties toward the lower index
        nbr = torch.sort(d2, dim=1, stable=True).indices[:, :m]
        if prob is not None:
            _, strong = stable_topk_desc(
                torch.where(valid, prob, -torch.inf), m)
            nbr = torch.cat([nbr, strong[None, :].expand(k, m)], dim=1)
        mm = nbr.shape[1]
        cen_n = centers[nbr]                                   # (j, mm, 3)
        dst_n = dists[nbr]                                     # (j, mm, R)
        off = pts[:, None, :, :] - cen_n[:, :, None, :]        # (j, mm, s, 3)
        dist_p = _norm(off)
        drs = off / torch.clamp_min(dist_p[..., None], 1e-12)
        radius = radius_gather(drs, dst_n[:, :, None, :], rays)
        frac_jm = torch.sum((dist_p <= radius).float()
                            * w_norm[:, None, :], dim=-1)
        jj = torch.arange(k, device=dev)[:, None].expand(k, mm)
        frac = torch.zeros((k, k), dtype=torch.float32, device=dev)
        frac[nbr.reshape(-1), jj.reshape(-1)] = frac_jm.reshape(-1)
    else:
        off = pts[None, :, :, :] - centers[:, None, None, :]   # (i, j, s, 3)
        dist_p = _norm(off)
        drs = off / torch.clamp_min(dist_p[..., None], 1e-12)
        radius = radius_gather(drs, dists[:, None, None, :], rays)
        frac = torch.sum((dist_p <= radius).float() * w_norm[None], dim=-1)
    return torch.where(valid[:, None] & valid[None, :], frac, 0.0)


def greedy_nms(prob: torch.Tensor, overlap: torch.Tensor,
               valid: torch.Tensor, nms_thresh: float = 0.3
               ) -> torch.Tensor:
    """Sequential greedy NMS; returns the kept mask.  The loop over the
    (few hundred) candidates runs on the host in numpy: it is inherently
    sequential, and one small transfer costs less than a device launch per
    step."""
    order = torch.argsort(-torch.where(valid, prob, -torch.inf),
                          stable=True).cpu().numpy()
    ov = overlap.cpu().numpy()
    val = valid.cpu().numpy()
    thr = np.float32(nms_thresh)
    kept = np.zeros(prob.shape[0], bool)
    for i in order:
        col = ov[:, i]
        covered = col[kept].max() if kept.any() else np.float32(0.0)
        covered = max(covered, np.float32(0.0))
        kept[i] = bool(val[i]) and covered <= thr
    return torch.from_numpy(kept).to(prob.device)


def render_polyhedra_labels(centers: torch.Tensor, dists: torch.Tensor,
                            rays: torch.Tensor, prob: torch.Tensor,
                            kept: torch.Tensor,
                            image_shape: Tuple[int, int, int],
                            box: Tuple[int, int, int]) -> torch.Tensor:
    """Rasterise kept polyhedra into an int32 (z, y, x) label volume.
    Ids follow descending probability among kept candidates; where
    polyhedra overlap the higher-probability one wins.

    The JAX twin pastes boxes one by one in ascending probability, so the
    last writer (the lowest id) wins each voxel: here that is one
    scatter-min of ids over every kept candidate's inside voxels."""
    k = centers.shape[0]
    dev = centers.device
    bz, by, bx = box
    order = torch.argsort(-torch.where(kept, prob, -torch.inf), stable=True)
    ranks = torch.zeros((k,), dtype=torch.int32, device=dev)
    ranks[order] = torch.arange(1, k + 1, dtype=torch.int32, device=dev)

    half = torch.tensor([(bz - 1) / 2.0, (by - 1) / 2.0, (bx - 1) / 2.0],
                        dtype=torch.float32, device=dev)
    grids = torch.meshgrid(*(torch.arange(s, dtype=torch.float32, device=dev)
                             for s in box), indexing="ij")
    off = torch.stack([g - h for g, h in zip(grids, half)], dim=-1)
    dn = _norm(off)
    d = dn.reshape(-1)                                           # (V,)
    dirs = off / torch.clamp_min(dn[..., None], 1e-12)
    nearest = nearest_ray(dirs.reshape(-1, 3), rays)             # (V,)

    sel = torch.nonzero(kept).reshape(-1)
    pad = torch.tensor(box, dtype=torch.int32, device=dev)
    canvas_shape = tuple(s + 2 * p for s, p in zip(image_shape, box))
    hi = torch.tensor([c - b for c, b in zip(canvas_shape, box)],
                      dtype=torch.int32, device=dev)
    radius = dists[sel][:, nearest]                              # (C, V)
    inside = d[None, :] <= radius
    corner = torch.round(centers[sel] - half).to(torch.int32) + pad
    corner = torch.minimum(torch.clamp_min(corner, 0), hi)       # (C, 3)
    vz, vy, vx = (g.reshape(-1).long() for g in torch.meshgrid(
        *(torch.arange(s, device=dev) for s in box), indexing="ij"))
    cz, cy, cx = canvas_shape
    flat = ((corner[:, 0, None].long() + vz) * cy
            + corner[:, 1, None].long() + vy) * cx \
        + corner[:, 2, None].long() + vx                         # (C, V)
    big = torch.iinfo(torch.int32).max
    vals = torch.where(inside, ranks[sel][:, None], big)
    canvas = torch.full((cz * cy * cx,), big, dtype=torch.int32, device=dev)
    canvas.scatter_reduce_(0, flat.reshape(-1), vals.reshape(-1), "amin")
    canvas = torch.where(canvas == big, 0, canvas).reshape(canvas_shape)
    return canvas[bz:bz + image_shape[0], by:by + image_shape[1],
                  bx:bx + image_shape[2]]
