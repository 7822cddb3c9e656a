"""Per-label reductions (counterpart of
``3deecelltracker_tpu/ops/segment_reduce.py``): weighted centres of mass and
bounding boxes."""

from __future__ import annotations

from typing import Tuple

import torch

_COM_CHUNK = 1 << 16


def center_of_mass(weights: torch.Tensor, labels: torch.Tensor,
                   max_labels: int) -> torch.Tensor:
    """Weighted centroid per label 1..max_labels, (max_labels, ndim) f32;
    absent or zero-weight labels are NaN (scipy's 0/0).

    As in the JAX package, the per-label sums are one-hot products over
    chunks of 65536 voxels accumulated in order, in full float32 (the
    device pins TF32 off)."""
    dev = labels.device
    ndim = labels.dim()
    w = weights.to(torch.float32).reshape(-1)
    lab = torch.clamp(labels.reshape(-1), 0, max_labels)
    coords = torch.meshgrid(*(torch.arange(s, dtype=torch.float32,
                                           device=dev)
                              for s in labels.shape), indexing="ij")
    feats = torch.stack([w] + [w * c.reshape(-1) for c in coords], dim=1)
    ids = torch.arange(max_labels + 1, dtype=lab.dtype, device=dev)
    acc = torch.zeros((max_labels + 1, ndim + 1), dtype=torch.float32,
                      device=dev)
    for start in range(0, w.shape[0], _COM_CHUNK):
        lab_c = lab[start:start + _COM_CHUNK]
        onehot = (lab_c[None, :] == ids[:, None]).to(torch.float32)
        acc = acc + torch.matmul(onehot, feats[start:start + _COM_CHUNK])
    com = acc[:, 1:] / acc[:, 0:1]
    return com[1:]


def find_objects_bounds(labels: torch.Tensor, max_labels: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive per-label bounding boxes ((max_labels, ndim) int32 mins,
    maxs); absent labels get mins = shape, maxs = -1."""
    dev = labels.device
    lab = labels.reshape(-1).long()
    seg = torch.clamp(lab, 0, max_labels)
    fg = lab > 0
    mins, maxs = [], []
    for d in range(labels.dim()):
        shape = [1] * labels.dim()
        shape[d] = labels.shape[d]
        c = torch.arange(labels.shape[d], dtype=torch.int32,
                         device=dev).reshape(shape).expand(
                             labels.shape).reshape(-1)
        big = labels.shape[d]
        mn = torch.full((max_labels + 1,), big, dtype=torch.int32,
                        device=dev).scatter_reduce(
            0, seg, torch.where(fg, c, big), "amin")
        mx = torch.full((max_labels + 1,), -1, dtype=torch.int32,
                        device=dev).scatter_reduce(
            0, seg, torch.where(fg, c, -1), "amax")
        mins.append(mn)
        maxs.append(mx)
    return torch.stack(mins, dim=1)[1:], torch.stack(maxs, dim=1)[1:]
