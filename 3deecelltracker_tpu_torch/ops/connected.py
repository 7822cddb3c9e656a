"""Value-equal connected components (counterpart of
``3deecelltracker_tpu/ops/connected.py:86-167``).

Two voxels join only when both are nonzero and equal-valued (skimage
``label`` on a label image).  Every foreground voxel starts with its own
1-based flat index; each round takes the minimum over equal-valued
neighbours (hook) and follows the stored index twice (pointer jumping),
until nothing changes or 256 rounds.  The converged labels are each
component's smallest index, so ``relabel_sequential`` gives skimage's
numbering.  This runs once per recording and stays plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .neighborhood import neighbor_offsets, shift

_BIG = torch.iinfo(torch.int32).max
CHECK_EVERY = 4   # rounds between host convergence checks (fixed point)


def label_components_values_raw(values: torch.Tensor,
                                connectivity: Optional[int] = None,
                                max_iters: int = 256) -> torch.Tensor:
    ndim = values.dim()
    conn = ndim if connectivity is None else int(connectivity)
    offsets = neighbor_offsets(ndim, conn)
    fg = values != 0
    n = values.numel()
    init = torch.arange(1, n + 1, dtype=torch.int32,
                        device=values.device).reshape(values.shape)
    labels = torch.where(fg, init, _BIG)
    # equal-valued foreground neighbour masks are fixed across rounds
    same = [(shift(values, off, 0) == values) & fg for off in offsets]

    def jump(lab):
        flat = lab.reshape(-1)
        idx = torch.clamp(flat.long() - 1, 0, n - 1)
        return torch.where(flat == _BIG, _BIG, flat[idx]).reshape(lab.shape)

    it = 0
    while it < max_iters:
        changed = []
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            best = labels
            for off, s in zip(offsets, same):
                best = torch.minimum(best, torch.where(
                    s, shift(labels, off, _BIG), _BIG))
            new = jump(jump(torch.where(fg, torch.minimum(labels, best),
                                        _BIG)))
            changed.append((new != labels).any())
            labels = new
            it += 1
        if not bool(torch.stack(changed).all()):
            break
    return torch.where(fg, labels, 0)


def relabel_sequential(labels: torch.Tensor) -> torch.Tensor:
    """Compact nonnegative ids (<= labels.numel()) to 1..K in id order:
    a presence bitmap and its cumulative sum."""
    flat = labels.reshape(-1).long()
    n = flat.shape[0]
    ids = torch.clamp(flat, 0, n)
    presence = torch.zeros((n + 1,), dtype=torch.int32, device=flat.device)
    presence[ids] = 1
    presence[0] = 0
    ranks = torch.cumsum(presence, 0).to(torch.int32)
    new = torch.where(flat == 0, 0, ranks[ids])
    return new.reshape(labels.shape).to(torch.int32)


def label_components_values(values: torch.Tensor,
                            connectivity: Optional[int] = None,
                            max_iters: int = 256) -> torch.Tensor:
    return relabel_sequential(label_components_values_raw(
        values, connectivity, max_iters))
