"""Greedy match peeling and the similarity normalizers (counterpart of
``3deecelltracker_tpu/ops/matching.py``: ``_peel_loop``, ``simple_match``,
``legacy_init_match``, ``non_max_suppression_normalize``,
``softmax_normalize``, ``row_wise_normalize``).  ``_peel_loop``,
``simple_match`` and ``legacy_init_match`` also take a leading member axis, (E, m, n) matrices with
(E, n) / (E, m) masks, and peel each member as it is alone.
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
    max_rounds = min(mat.shape[-2:]) + 1
    rounds = 0
    while rounds < max_rounds:
        for _ in range(min(CHECK_EVERY, max_rounds - rounds)):
            row_max = torch.amax(mat, dim=-1, keepdim=True)
            col_max = torch.amax(mat, dim=-2, keepdim=True)
            mutual = ((mat >= threshold) & (mat == row_max)
                      & (mat == col_max) & (mat > 0))
            mutual = mutual & (torch.cumsum(mutual.to(torch.int32), -1) == 1)
            mutual = mutual & (torch.cumsum(mutual.to(torch.int32), -2) == 1)
            pairs = pairs | mutual
            used = (torch.any(mutual, dim=-1, keepdim=True)
                    | torch.any(mutual, dim=-2, keepdim=True))
            mat = torch.where(used, 0.0, mat)
            rounds += 1
        # a member whose peel has ended accepts nothing in further rounds,
        # so the loop runs while any member still can
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
    *lead, m, n = initial_match_matrix.shape
    dev = initial_match_matrix.device
    if ref_mask is None:
        ref_mask = torch.ones((*lead, n), dtype=torch.bool, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones((*lead, m), dtype=torch.bool, device=dev)
    valid = tgt_mask[..., :, None] & ref_mask[..., None, :]
    pairs, _ = _peel_loop(torch.where(valid, initial_match_matrix, 0.0),
                          threshold)
    n_valid = torch.sum(ref_mask.to(torch.float32), dim=-1)
    # a true f32 division (python scalar / tensor would multiply by the
    # reciprocal and round differently)
    base = torch.div(torch.tensor(0.1, dtype=torch.float32, device=dev),
                     n_valid - 1.0)
    prob = torch.where(valid, base[..., None, None], 0.0)
    return torch.where(pairs, 0.9, prob).to(torch.float32), pairs


def legacy_init_match(corr: torch.Tensor, threshold: float = 0.5,
                      ref_mask: Optional[torch.Tensor] = None,
                      tgt_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The prior of the legacy ``pr_gls_quick`` (track.py:58-70): peel at
    ``threshold``; unmatched rows stay uniform 1/n, matched rows become
    0.1/(n-1) except 0.9 at the matched column.  n is the valid ref count;
    padded pairs get zero and can never be matched.  With a leading member
    axis ((E, m, n) scores, (E, n) ref masks; the target mask (m,) or
    (E, m)) each member's prior is its own."""
    *lead, m, n_static = corr.shape
    dev = corr.device
    if ref_mask is None:
        ref_mask = torch.ones((*lead, n_static), dtype=torch.bool,
                              device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones((m,), dtype=torch.bool, device=dev)
    valid = tgt_mask[..., :, None] & ref_mask[..., None, :]
    pairs, _ = _peel_loop(torch.where(valid, corr, 0.0), threshold)
    n = torch.sum(ref_mask.to(torch.float32), dim=-1)[..., None, None]
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    # true f32 divisions, as XLA does them (see simple_match)
    matched_row = torch.any(pairs, dim=-1, keepdim=True)
    base = torch.where(matched_row, torch.div(one * 0.1, n - 1.0),
                       torch.div(one, n))
    out = torch.where(pairs, 0.9, base.expand(corr.shape))
    return torch.where(valid, out, 0.0).to(torch.float32)


def non_max_suppression_normalize(similarity: torch.Tensor,
                                  threshold: float = 0.5) -> torch.Tensor:
    """``trackerlite.non_max_suppression_normalize`` (:393-406): 0.9 for
    the peeled pairs, the rest of a matched row 0.1 / (n - 1), an
    unmatched row 1 / n."""
    pairs, _ = _peel_loop(similarity, threshold)
    n = similarity.shape[1]
    matched_row = torch.any(pairs, dim=1, keepdim=True)
    base = torch.where(matched_row, 0.1 / (n - 1), 1.0 / n).to(
        torch.float32)
    return torch.where(pairs, torch.tensor(0.9, dtype=torch.float32,
                                           device=similarity.device),
                       base.expand(similarity.shape))


def softmax_normalize(similarity: torch.Tensor) -> torch.Tensor:
    """``trackerlite.softmax_normalize`` (:385-386): a softmax per row."""
    return torch.softmax(similarity, dim=1)


def row_wise_normalize(similarity: torch.Tensor) -> torch.Tensor:
    """``trackerlite.row_wise_normalize`` (:389-390): each row over its
    sum."""
    return similarity / torch.sum(similarity, dim=1, keepdim=True)
