"""StarDist training targets: per-voxel ray distances and the EDT-based
object probability (counterpart of ``3deecelltracker_tpu/ops/
stardist_gt.py``), batched over a patch batch.

- :func:`star_dist3d`: for every foreground voxel and ray, the steps along
  the ray until the label changes, by unit-step marching with the
  nearest-voxel sample.  Every base voxel is an integer coordinate, so the
  sample at step t of ray r is ``v + round(r t)``: one integer offset
  shared by all voxels.  The rays' n_rays x max_dist steps take far fewer
  distinct offsets; each distinct offset's same-label mask is built once,
  for a chunk of offsets at a time in one gather from a zero-padded label
  volume, and the march then only indexes those masks.  With ``grid`` the
  march runs at the subsampled voxels alone: a voxel's distances depend on
  its own label and the labels at its offsets, so the result equals the
  full-resolution one sliced by the grid.
- :func:`edt_prob`: the EDT to the nearest background or other-label
  voxel, plus one on foreground, normalized per object by its maximum.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .edt import distance_transform_edt
from .neighborhood import neighbor_offsets, shift

# elements of one chunk of same-label masks (int32 gather, then bool)
_CHUNK_ELEMS = 1 << 23


def ray_offsets(rays, max_dist: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(offsets, index)``: the distinct integer offsets ``round(r t)``
    (float64, numpy's half-even rounding, as the JAX version takes them)
    over rays r and steps t = 1..max_dist, (m, 3) int64, and for each
    (ray, step) the row of its offset, (n_rays, max_dist)."""
    r = np.asarray(rays, np.float64)
    steps = np.arange(1, max_dist + 1, dtype=np.float64)
    offs = np.round(r[:, None, :] * steps[None, :, None]).astype(np.int64)
    uniq, inverse = np.unique(offs.reshape(-1, 3), axis=0,
                              return_inverse=True)
    return uniq, inverse.reshape(r.shape[0], max_dist)


def _batch(labels: torch.Tensor) -> torch.Tensor:
    if labels.dim() == 3:
        return labels[None]
    if labels.dim() != 4:
        raise ValueError(f"labels must be ([b,] z, y, x), got "
                         f"{tuple(labels.shape)}")
    return labels


def star_dist3d(labels: torch.Tensor, rays, max_dist: int = 32,
                ray_chunk: int = 16, *,
                grid: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """([b,] z, y, x) int labels -> ([b,] z', y', x', n_rays) float32 ray
    distances at the voxels ``[::gz, ::gy, ::gx]``.  Background voxels get
    0; a ray still inside its label after ``max_dist`` steps gets
    ``max_dist``; samples outside the volume read background.  ``rays``
    are host values (numpy or a CPU tensor): they decide the offsets.
    ``ray_chunk`` is kept so the signature matches JAX's and is ignored,
    as JAX ignores it: every ray is marched in one pass."""
    del ray_chunk
    lab = _batch(labels).to(torch.int32)
    if isinstance(rays, torch.Tensor):
        rays = rays.detach().cpu().numpy()
    offsets, index = ray_offsets(rays, max_dist)
    b, z, y, x = lab.shape
    gz, gy, gx = (int(g) for g in grid)
    pad = np.abs(offsets).max(axis=0) if len(offsets) else np.zeros(3, int)
    pz, py, px = (int(p) for p in pad)
    lp = F.pad(lab, (px, px, py, py, pz, pz)).reshape(-1)
    sz, sy, sx = z + 2 * pz, y + 2 * py, x + 2 * px
    dev = lab.device
    zz = torch.arange(0, z, gz, device=dev) + pz
    yy = torch.arange(0, y, gy, device=dev) + py
    xx = torch.arange(0, x, gx, device=dev) + px
    bb = torch.arange(b, device=dev) * (sz * sy * sx)
    base = (bb[:, None, None, None] + zz[None, :, None, None] * (sy * sx)
            + yy[None, None, :, None] * sx + xx[None, None, None, :])
    out_shape = tuple(base.shape)
    base = base.reshape(-1)
    own = lp[base]
    fg = own > 0
    delta = torch.from_numpy(offsets[:, 0] * (sy * sx) + offsets[:, 1] * sx
                             + offsets[:, 2]).to(dev)
    chunk = max(1, _CHUNK_ELEMS // max(1, base.numel()))
    same = torch.cat([
        (lp[base[None, :] + d[:, None]] == own[None, :]) & fg[None, :]
        for d in torch.split(delta, chunk)])              # (m, n) bool
    idx = torch.from_numpy(index).to(dev)
    alive = same[idx[:, 0]]                               # (rays, n)
    dist = alive.to(torch.float32)
    for t in range(1, max_dist):
        alive = alive & same[idx[:, t]]
        dist = dist + alive
    dist = dist.t().reshape(out_shape + (len(index),))
    return dist if labels.dim() == 4 else dist[0]


def edt_prob(labels: torch.Tensor, max_labels: int = 1024,
             anisotropy: Tuple[float, float, float] = (1.0, 1.0, 1.0),
             window: Optional[int] = None) -> torch.Tensor:
    """Per-object EDT normalized to a maximum of 1 (stardist
    ``edt_prob``) of ([b,] z, y, x) labels: the zero set is the background
    and every voxel with a face neighbour of another label; foreground
    voxels add 1; labels above ``max_labels`` share its slot.
    ``window``: the EDT's search radius (``ops.edt``)."""
    lab = _batch(labels)
    diff = torch.zeros(lab.shape, dtype=torch.bool, device=lab.device)
    for off in neighbor_offsets(3, 1):
        diff |= shift(lab, (0,) + tuple(off), 0) != lab
    fg = lab > 0
    d = distance_transform_edt(fg & ~diff, anisotropy, batch_ndim=1,
                               window=window) + fg.to(torch.float32)
    b = lab.shape[0]
    seg = torch.clamp(lab, 0, max_labels).reshape(b, -1).to(torch.int64)
    per_max = torch.zeros((b, max_labels + 1), dtype=torch.float32,
                          device=lab.device).scatter_reduce(
        1, seg, d.reshape(b, -1), "amax")
    norm = torch.gather(per_max, 1, seg).reshape(lab.shape)
    prob = torch.where(fg, d / torch.clamp_min(norm, 1e-6), 0.0)
    return prob if labels.dim() == 4 else prob[0]
