"""The ensemble's member fan-out on one card (counterpart of
``3deecelltracker_tpu/parallel/ensemble.py``: ``ensemble_member_predictions``,
``ensemble_track_step`` and ``pad_members``, :25-73 and :119).

The reference predicts a volume from up to 20 earlier volumes in a serial
loop and combines the predictions with a 10% trimmed mean
(``trackerlite.py:111-125``).  JAX ``vmap``s ``track_step`` over the
members; here ``engine.tracker.track_step`` takes the member axis itself:
one batch of kNN features, FFN scores, peels and EM iterations, each
member computed as it is alone (a member whose EM has stopped keeps its
state while the others iterate).  The sharded builders
(``make_sharded_ensemble_*``) wait for ``torch.distributed`` (ROADMAP.md
A.5).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..engine.tracker import track_step
from ..ops.trim import trim_mean


def ensemble_member_predictions(ffn_params, ffn_state,
                                confirmed_stack: torch.Tensor,  # (E, L, 3)
                                seg_t1_stack: torch.Tensor,     # (E, M, 3)
                                seg_t1_masks: torch.Tensor,     # (E, M)
                                seg_t2: torch.Tensor,           # (M, 3)
                                seg_t2_mask: torch.Tensor,      # (M,)
                                beta: float = 3.0, lambda_: float = 3.0,
                                k_points: int = 20,
                                max_iteration: int = 2000) -> torch.Tensor:
    """Every member's tracked real coordinates at t2, (E, L, 3)."""
    return track_step(ffn_params, ffn_state, confirmed_stack, seg_t1_stack,
                      seg_t1_masks, seg_t2, seg_t2_mask, beta=beta,
                      lambda_=lambda_, k_points=k_points,
                      max_iteration=max_iteration).tracked


def ensemble_track_step(ffn_params, ffn_state,
                        confirmed_stack: torch.Tensor,
                        seg_t1_stack: torch.Tensor,
                        seg_t1_masks: torch.Tensor,
                        seg_t2: torch.Tensor, seg_t2_mask: torch.Tensor,
                        beta: float = 3.0, lambda_: float = 3.0,
                        k_points: int = 20, max_iteration: int = 2000,
                        trim_proportion: float = 0.1) -> torch.Tensor:
    """All members at once, combined by the trimmed mean: (L, 3)."""
    preds = ensemble_member_predictions(
        ffn_params, ffn_state, confirmed_stack, seg_t1_stack, seg_t1_masks,
        seg_t2, seg_t2_mask, beta=beta, lambda_=lambda_, k_points=k_points,
        max_iteration=max_iteration)
    return trim_mean(preds, trim_proportion, axis=0)


def pad_members(arrays: List[np.ndarray], multiple: int
                ) -> Tuple[np.ndarray, int]:
    """Stack member arrays, repeating the last to a multiple of
    ``multiple``; returns (stack, n_real).  The port's drivers run the
    real members only (no program to compile once), so only callers that
    want JAX's padded stack use it; a trimmed mean over padded members
    must take ``stack[:n_real]``."""
    n = len(arrays)
    stack = list(arrays)
    while len(stack) % multiple:
        stack.append(stack[-1])
    return np.stack(stack), n
