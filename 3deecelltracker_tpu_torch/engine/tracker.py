"""One tracking step (counterpart of
``3deecelltracker_tpu/engine/tracker.py::track_step``): normalize, kNN
features, all-pairs FFN scores, greedy matching, PR-GLS with two
references, denormalize."""

from __future__ import annotations

import torch

from ..models.ffn import ffn_pair_scores
from ..ops.knn import knn_feature_vectors
from ..ops.matching import simple_match
from ..ops.pointset import normalize_points
from ..ops.prgls import PrglsResult, prgls_with_two_ref

BETA, LAMBDA, MAX_ITERATION = 3.0, 3.0, 2000   # trackerlite.py:29
K_POINTS = 20                                  # trackerlite.py:30


def track_step(ffn_params, ffn_state, confirmed_t1_real: torch.Tensor,
               seg_t1_real: torch.Tensor, seg_t1_mask: torch.Tensor,
               seg_t2_real: torch.Tensor, seg_t2_mask: torch.Tensor,
               beta: float = BETA, lambda_: float = LAMBDA,
               k_points: int = K_POINTS,
               max_iteration: int = MAX_ITERATION) -> PrglsResult:
    """Predict the confirmed set's real coordinates at t2.  Returns the
    PR-GLS result with ``tracked`` already denormalized to real units
    (the JAX twin returns ``tracked`` alone)."""
    confirmed_norm, (mean, scale) = normalize_points(confirmed_t1_real)
    t1_norm = (seg_t1_real - mean) / scale
    t2_norm = (seg_t2_real - mean) / scale
    feats_t1 = knn_feature_vectors(t1_norm, seg_t1_mask, k_points)
    feats_t2 = knn_feature_vectors(t2_norm, seg_t2_mask, k_points)
    scores = ffn_pair_scores(ffn_params, ffn_state, feats_t1, feats_t2)
    prior, _ = simple_match(scores, threshold=0.1, ref_mask=seg_t1_mask,
                            tgt_mask=seg_t2_mask)
    result = prgls_with_two_ref(
        prior, t2_norm, t1_norm, confirmed_norm, beta=beta,
        lambda_=lambda_, max_iteration=max_iteration,
        tgt_mask=seg_t2_mask, ref_mask=seg_t1_mask)
    return result._replace(tracked=result.tracked * scale + mean)
