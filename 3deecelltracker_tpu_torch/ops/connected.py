"""Connected components (counterpart of
``3deecelltracker_tpu/ops/connected.py``).

Mask components (``label_components_raw``, :30-83): every foreground voxel
gets the 1-based flat index of its component's smallest voxel.  With full
connectivity on a CUDA tensor that is the hand-written CUDA kernel
``ops.hopper_cc.cc_label``, which runs to the fixed point; every other case
(a CPU tensor, or a connectivity below the number of axes, which the
full-box kernel does not take) runs the JAX loop in PyTorch, four hook
rounds a pointer jump, stopped after ``max_iters`` hook rounds as JAX's is.
The two differ only on a component that ``max_iters`` leaves unfinished,
which no mask of the path is (ROADMAP.md C.8).

Value-equal components (``label_components_values``, :115-167): two voxels
join only when both are nonzero and equal-valued (skimage ``label`` on a
label image).  Every foreground voxel starts with its own 1-based flat
index; each round takes the minimum over equal-valued neighbours (hook) and
follows the stored index twice (pointer jumping), until nothing changes or
``max_iters`` rounds.  The converged labels are each component's smallest
index, so ``relabel_sequential`` gives skimage's numbering.  This runs once
per recording and stays plain PyTorch.

``max_labels`` has no effect, as in JAX (kept there for API compatibility:
the presence bitmap of ``relabel_sequential`` needs no label budget).
"""

from __future__ import annotations

from typing import Optional

import torch

from .hopper_cc import cc_label, label_components_raw_plain
from .neighborhood import neighbor_offsets, shift

_BIG = torch.iinfo(torch.int32).max
CHECK_EVERY = 4   # rounds between host convergence checks (fixed point)


def label_components_raw(mask: torch.Tensor,
                         connectivity: Optional[int] = None,
                         max_iters: int = 256, *,
                         per_slice: bool = False) -> torch.Tensor:
    """Root-index component labels (>= 1, 0 background) of a mask;
    ``connectivity`` follows skimage, 1..ndim, default full.
    ``max_iters``: the hook rounds of the plain loop (the kernel runs to
    the fixed point; module docstring).  ``per_slice``: label every
    z-slice of an (x, y, z) volume alone, with slice-local indices
    (``watershed_2d``'s ``vmap``)."""
    spatial = mask.dim() - (1 if per_slice else 0)
    conn = spatial if connectivity is None else int(connectivity)
    if conn == spatial and mask.device.type != "cpu":
        return cc_label(mask != 0, per_slice)
    return label_components_raw_plain(mask, conn, per_slice, max_iters)


def label_components(mask: torch.Tensor,
                     connectivity: Optional[int] = None,
                     max_labels: int = 4096,
                     max_iters: int = 256) -> torch.Tensor:
    """skimage-style ``label()``: sequential labels 1..K, 0 background."""
    return relabel_sequential(label_components_raw(mask, connectivity,
                                                   max_iters))


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


def relabel_sequential(labels: torch.Tensor,
                       max_labels: int = 0) -> torch.Tensor:
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
                            max_labels: int = 4096,
                            max_iters: int = 256) -> torch.Tensor:
    return relabel_sequential(label_components_values_raw(
        values, connectivity, max_iters))
