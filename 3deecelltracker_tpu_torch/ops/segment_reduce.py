"""Per-label reductions (counterpart of
``3deecelltracker_tpu/ops/segment_reduce.py``): weighted centres of mass,
voxel counts, bounding boxes and the activity readout (mean of each cell's
brightest voxels)."""

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


def label_counts(labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """Voxel count per label 0..max_labels (a bincount of static
    length)."""
    return torch.bincount(labels.reshape(-1).long(),
                          minlength=max_labels + 1)[:max_labels + 1]


def sort_by_label(raw: torch.Tensor, labels: torch.Tensor, max_labels: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Voxels sorted by (label, intensity), as ``jnp.lexsort((raw,
    labels))`` orders them: each label's voxels a contiguous run of
    ascending intensity.  Labels clip to 0..max_labels.  Returns (sorted
    labels, sorted intensities (f32), per-label counts, run starts)."""
    flat_raw = raw.to(torch.float32).reshape(-1)
    flat_lab = torch.clamp(labels.reshape(-1).long(), 0, max_labels)
    counts = torch.bincount(flat_lab, minlength=max_labels + 1)
    by_raw = torch.argsort(flat_raw, stable=True)
    order = by_raw[torch.argsort(flat_lab[by_raw], stable=True)]
    starts = torch.cumsum(counts, 0) - counts
    return flat_lab[order], flat_raw[order], counts, starts


def masked_label_mean(sorted_lab: torch.Tensor, sorted_raw: torch.Tensor,
                       keep: torch.Tensor, max_labels: int) -> torch.Tensor:
    """Per-label mean of the kept voxels, labels 1..max_labels; NaN where
    a label keeps none."""
    zeros = torch.zeros((max_labels + 1,), dtype=torch.float32,
                        device=sorted_raw.device)
    sums = zeros.index_add(0, sorted_lab, torch.where(keep, sorted_raw, 0.0))
    nkeep = zeros.index_add(0, sorted_lab, keep.to(torch.float32))
    return (sums / nkeep)[1:]


def topq_mean_intensity(raw: torch.Tensor, labels: torch.Tensor,
                        max_labels: int, discard_ratio: float = 0.1
                        ) -> torch.Tensor:
    """Per-label mean of the intensities strictly above the label's
    ``1 - discard_ratio`` percentile (linear interpolation, as
    ``np.percentile``): the reference's activity readout
    (``trackerlite.py:188-197``).  (max_labels,) f32; NaN for a label with
    no voxel, or none above its percentile."""
    sorted_lab, sorted_raw, counts, starts = sort_by_label(raw, labels,
                                                           max_labels)
    r = (counts.to(torch.float32) - 1.0) * (1.0 - discard_ratio)
    lo = torch.clamp_min(torch.floor(r).long(), 0)
    hi = torch.clamp_min(torch.ceil(r).long(), 0)
    frac = r - lo.to(torch.float32)
    last = sorted_raw.shape[0] - 1
    v_lo = sorted_raw[torch.clamp(starts + lo, 0, last)]
    v_hi = sorted_raw[torch.clamp(starts + hi, 0, last)]
    pthr = v_lo * (1.0 - frac) + v_hi * frac
    keep = (sorted_raw > pthr[sorted_lab]) & (sorted_lab > 0)
    return masked_label_mean(sorted_lab, sorted_raw, keep, max_labels)

