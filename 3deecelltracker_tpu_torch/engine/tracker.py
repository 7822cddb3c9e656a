"""One tracking step and the tracker's set-up (counterpart of
``3deecelltracker_tpu/engine/tracker.py``: ``track_step``, and
``TrackerLite``'s constructor and padding, :107-172).

``track_step``: normalize, kNN features, all-pairs FFN scores, greedy
matching, PR-GLS with two references, denormalize.  ``TrackerLite`` holds
the FFN weights on the device and the static pad of the segmented point
sets; its ensemble prediction (``ROADMAP.md`` A.5), ``match_by_ffn`` and
``activities`` (A.2) are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..coordinates import Coordinates
from ..io.artifacts import ResultsTree
from ..utils.convert import ffn_from_numpy, load_npz
from ..utils.device import to_device

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


class TrackerLite:
    """The tracker's state for one recording (reference
    ``trackerlite.py:33-68``).

    ``ffn_weights``: a ``save_pytree`` ``.npz`` of the FFN's (params,
    state), as the JAX package writes it, or a (params, state) pair of
    dicts of arrays or tensors; either way they land on the device of
    ``proofed_coords_vol1``.  ``max_cells``: the static pad of the
    segmented point sets, ``ceil(1.5 n1 / 64) * 64`` for n1 vol-1 cells by
    default."""

    def __init__(self, results_dir: Union[str, Path], ffn_weights,
                 proofed_coords_vol1: Coordinates,
                 miss_frame: Optional[List[int]] = None,
                 max_cells: Optional[int] = None,
                 m_step_refine: int = 0):
        if miss_frame is not None and not isinstance(miss_frame, list):
            raise TypeError(
                f"miss_frame should be a list or None, got {type(miss_frame)}")
        if m_step_refine:
            raise NotImplementedError(
                "m_step_refine > 0 is not ported: it measured worse "
                "(ROADMAP.md A, 'Do not port')")
        self.tree = ResultsTree(results_dir)
        self.tree.make_dirs()
        self.proofed_coords_vol1 = proofed_coords_vol1
        self.miss_frame = [] if miss_frame is None else miss_frame
        dev = proofed_coords_vol1.raw_f32.device
        if isinstance(ffn_weights, (str, Path)):
            if str(ffn_weights).endswith(".h5"):
                raise NotImplementedError(
                    "Keras FFN checkpoints are not ported yet (ROADMAP.md "
                    "A.8)")
            tree = load_npz(ffn_weights)
            self.ffn_params, self.ffn_state = ffn_from_numpy(
                tree["0"], tree["1"], dev)
        else:
            self.ffn_params, self.ffn_state = (to_device(w, dev)
                                               for w in ffn_weights)
        n1 = proofed_coords_vol1.cell_num
        self.max_cells = int(max_cells) if max_cells else int(
            np.ceil(n1 * 1.5 / 64) * 64)

    def _pad_np(self, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """A point set padded to ``max_cells`` rows: the padding parked at
        1e6 (beyond every kNN neighbourhood) and a bool mask of the real
        rows."""
        n = pts.shape[0]
        if n > self.max_cells:
            raise ValueError(
                f"{n} cells exceeds max_cells={self.max_cells}")
        out = np.zeros((self.max_cells, 3), np.float32)
        out[:n] = pts
        out[n:] = 1e6
        mask = np.zeros(self.max_cells, bool)
        mask[:n] = True
        return out, mask

