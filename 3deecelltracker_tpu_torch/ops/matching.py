"""Greedy match peeling (counterpart of
``3deecelltracker_tpu/ops/matching.py``: ``_peel_loop``, ``simple_match``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


CHECK_EVERY = 4   # rounds between host reads of the loop condition


def _peel_loop(match_matrix: torch.Tensor, threshold: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy peel by mutual-max rounds: accept every entry that is the
    max of its row and of its column (first such per row and column),
    zero those rows/cols, repeat while the max is >= threshold and > 0.
    Once that condition fails a round accepts nothing, so the host checks
    only every ``CHECK_EVERY`` rounds; while it holds every round peels at
    least one row, so min(m, n) + 1 rounds always suffice.  Returns (pair
    mask, consumed matrix)."""
    mat = match_matrix.to(torch.float32)
    pairs = torch.zeros(mat.shape, dtype=torch.bool, device=mat.device)
    max_rounds = min(mat.shape) + 1
    rounds = 0
    while rounds < max_rounds:
        for _ in range(min(CHECK_EVERY, max_rounds - rounds)):
            row_max = torch.amax(mat, dim=1, keepdim=True)
            col_max = torch.amax(mat, dim=0, keepdim=True)
            mutual = ((mat >= threshold) & (mat == row_max)
                      & (mat == col_max) & (mat > 0))
            mutual = mutual & (torch.cumsum(mutual.to(torch.int32), 1) == 1)
            mutual = mutual & (torch.cumsum(mutual.to(torch.int32), 0) == 1)
            pairs = pairs | mutual
            used = (torch.any(mutual, dim=1, keepdim=True)
                    | torch.any(mutual, dim=0, keepdim=True))
            mat = torch.where(used, 0.0, mat)
            rounds += 1
        mx = torch.amax(mat)
        if not bool((mx >= threshold) & (mx > 0)):
            break
    return pairs, mat


def simple_match(initial_match_matrix: torch.Tensor, threshold: float = 0.1,
                 ref_mask: Optional[torch.Tensor] = None,
                 tgt_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every valid pair gets prior 0.1/(n_valid_ref-1); peeled (tgt, ref)
    pairs get 0.9.  Returns (prior (m, n) f32, pair mask)."""
    m, n = initial_match_matrix.shape
    dev = initial_match_matrix.device
    if ref_mask is None:
        ref_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones((m,), dtype=torch.bool, device=dev)
    valid = tgt_mask[:, None] & ref_mask[None, :]
    pairs, _ = _peel_loop(torch.where(valid, initial_match_matrix, 0.0),
                          threshold)
    n_valid = torch.sum(ref_mask.to(torch.float32))
    # a true f32 division (python scalar / tensor would multiply by the
    # reciprocal and round differently)
    base = torch.div(torch.tensor(0.1, dtype=torch.float32, device=dev),
                     n_valid - 1.0)
    prob = torch.where(valid, base, 0.0)
    return torch.where(pairs, 0.9, prob).to(torch.float32), pairs
