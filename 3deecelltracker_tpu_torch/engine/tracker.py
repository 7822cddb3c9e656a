"""FFN + PR-GLS tracking over the results tree (counterpart of
``3deecelltracker_tpu/engine/tracker.py``).

``track_step``: normalize, kNN features, all-pairs FFN scores, greedy
matching, PR-GLS with two references, denormalize; with a member axis it
runs an ensemble's members as one batch.  ``match_step`` is the FFN
matching alone.  ``get_volumes_list`` picks an ensemble's reference
volumes.  ``TrackerLite`` holds the FFN weights on the device and the
static pad of the segmented point sets, and predicts, matches and reads
activities from the ``seg/`` and ``track_results/`` artifacts.
"""

from __future__ import annotations

import re
from glob import glob
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..coordinates import Coordinates
from ..io.artifacts import ResultsTree
from ..io.imageio import load_2d_slices_at_time
from ..models.ffn import ffn_pair_scores
from ..ops.knn import knn_feature_vectors
from ..ops.matching import simple_match
from ..ops.pointset import normalize_points
from ..ops.prgls import PrglsResult, prgls_with_two_ref
from ..ops.segment_reduce import topq_mean_intensity
from ..ops.trim import trim_mean
from ..utils.convert import ffn_from_numpy, load_npz
from ..utils.device import to_device
from ..utils.keras_import import import_ffn
from ..viz import plot_initial_matching, plot_prgls_prediction

BETA, LAMBDA, MAX_ITERATION = 3.0, 3.0, 2000   # trackerlite.py:29
K_POINTS = 20                                  # trackerlite.py:30


def track_step(ffn_params, ffn_state, confirmed_t1_real: torch.Tensor,
               seg_t1_real: torch.Tensor, seg_t1_mask: torch.Tensor,
               seg_t2_real: torch.Tensor, seg_t2_mask: torch.Tensor,
               beta: float = BETA, lambda_: float = LAMBDA,
               k_points: int = K_POINTS,
               max_iteration: int = MAX_ITERATION,
               m_step_refine: int = 0) -> PrglsResult:
    """Predict the confirmed set's real coordinates at t2.  Returns the
    PR-GLS result with ``tracked`` already denormalized to real units
    (the JAX twin returns ``tracked`` alone).  ``m_step_refine``: the
    EM's compensated M-step (``ops.prgls``).

    With a leading member axis on the t1 inputs ((E, l, 3) confirmed,
    (E, m, 3) seg_t1, (E, m) mask) and the t2 set shared, the E members
    run as one batch, each as it runs alone (JAX ``vmap``s this function
    over the members, ``parallel/ensemble.py``); the result then carries
    the member axis."""
    confirmed_norm, (mean, scale) = normalize_points(confirmed_t1_real)
    mean, scale = mean[..., None, :], scale[..., None, None]
    t1_norm = (seg_t1_real - mean) / scale
    t2_norm = (seg_t2_real - mean) / scale
    t2_mask = seg_t2_mask.expand(seg_t1_mask.shape[:-1]
                                 + seg_t2_mask.shape[-1:])
    feats_t1 = knn_feature_vectors(t1_norm, seg_t1_mask, k_points)
    feats_t2 = knn_feature_vectors(t2_norm, t2_mask, k_points)
    scores = ffn_pair_scores(ffn_params, ffn_state, feats_t1, feats_t2)
    prior, _ = simple_match(scores, threshold=0.1, ref_mask=seg_t1_mask,
                            tgt_mask=t2_mask)
    result = prgls_with_two_ref(
        prior, t2_norm, t1_norm, confirmed_norm, beta=beta,
        lambda_=lambda_, max_iteration=max_iteration,
        tgt_mask=t2_mask, ref_mask=seg_t1_mask, m_step_refine=m_step_refine)
    return result._replace(tracked=result.tracked * scale + mean)


def match_step(ffn_params, ffn_state, ref_real: torch.Tensor,
               ref_mask: torch.Tensor, tgt_real: torch.Tensor,
               tgt_mask: torch.Tensor, k_points: int = K_POINTS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFN matching alone (``match_by_ffn``, trackerlite.py:127-142):
    returns the (m_tgt, n_ref) score matrix and its peeled pair mask."""
    ref_norm, (mean, scale) = normalize_points(ref_real, ref_mask)
    tgt_norm = (tgt_real - mean) / scale
    feats_ref = knn_feature_vectors(ref_norm, ref_mask, k_points)
    feats_tgt = knn_feature_vectors(tgt_norm, tgt_mask, k_points)
    scores = ffn_pair_scores(ffn_params, ffn_state, feats_ref, feats_tgt)
    _, pairs = simple_match(scores, threshold=0.1, ref_mask=ref_mask,
                            tgt_mask=tgt_mask)
    return scores, pairs


def evenly_distributed_volumes(current_vol: int, sampling_number: int,
                               start_vol: int = 1) -> List[int]:
    """``trackerlite.evenly_distributed_volumes`` (:420-424)."""
    interval = (current_vol - start_vol) // sampling_number
    start = int(np.mod(current_vol - start_vol, sampling_number)) + start_vol
    return list(range(start, current_vol - interval + 1, interval))


def get_volumes_list(current_vol: int, skip_volumes: List[int],
                     sampling_number: int = 20, adjacent: bool = False,
                     start_vol: int = 1) -> List[int]:
    """An ensemble's reference volumes for ``current_vol``
    (``trackerlite.get_volumes_list`` :427-438): every earlier volume
    while there are fewer than ``sampling_number``, else the last
    ``sampling_number`` (``adjacent``) or that many spread evenly; the
    skipped volumes left out."""
    assert current_vol > start_vol, \
        f"current_vol (={current_vol}) should be larger than start_vol"
    if current_vol - start_vol < sampling_number:
        vols = list(range(start_vol, current_vol))
    elif adjacent:
        vols = list(range(current_vol - sampling_number, current_vol))
    else:
        vols = evenly_distributed_volumes(current_vol, sampling_number,
                                          start_vol)
    return [v for v in vols if v not in skip_volumes]


class TrackerLite:
    """The tracker's state for one recording (reference
    ``trackerlite.py:33-68``).

    ``ffn_weights``: a ``save_pytree`` ``.npz`` of the FFN's (params,
    state), as the JAX package writes it, the reference's Keras ``.h5``
    checkpoint (``utils.keras_import.import_ffn``; it needs ``h5py``), or
    a (params, state) pair of
    dicts of arrays or tensors; either way they land on the device of
    ``proofed_coords_vol1``.  ``max_cells``: the static pad of the
    segmented point sets, ``ceil(1.5 n1 / 64) * 64`` for n1 vol-1 cells by
    default.  ``m_step_refine``: every prediction's EM runs the compensated
    M-step with that many corrections (``ops.prgls``; 0, the default, the
    floored solve)."""

    def __init__(self, results_dir: Union[str, Path], ffn_weights,
                 proofed_coords_vol1: Coordinates,
                 miss_frame: Optional[List[int]] = None,
                 max_cells: Optional[int] = None,
                 m_step_refine: int = 0):
        if miss_frame is not None and not isinstance(miss_frame, list):
            raise TypeError(
                f"miss_frame should be a list or None, got {type(miss_frame)}")
        self.tree = ResultsTree(results_dir)
        self.tree.make_dirs()
        self.proofed_coords_vol1 = proofed_coords_vol1
        self.miss_frame = [] if miss_frame is None else miss_frame
        self.m_step_refine = int(m_step_refine)
        dev = proofed_coords_vol1.raw_f32.device
        self.device = dev
        if isinstance(ffn_weights, (str, Path)):
            if str(ffn_weights).endswith(".h5"):
                # the reference's Keras checkpoint (trackerlite.py:63)
                params, state = import_ffn(ffn_weights)
            else:
                tree = load_npz(ffn_weights)
                params, state = tree["0"], tree["1"]
            self.ffn_params, self.ffn_state = ffn_from_numpy(params, state,
                                                             dev)
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

    def _pad(self, pts) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_pad_np` on the tracker's device."""
        out, mask = self._pad_np(np.asarray(pts))
        return (torch.from_numpy(out).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _get_segmented_pos(self, t: int) -> Coordinates:
        """``seg/coords*.npy`` of volume ``t`` (``trackerlite.py:144-150``)."""
        return Coordinates.from_raw(
            self.tree.load_seg_coords(t),
            self.proofed_coords_vol1.interpolation_factor,
            self.proofed_coords_vol1.voxel_size, device=self.device)

    def predict_cell_positions(self, t1: int, t2: int,
                               confirmed_coord_t1: Optional[Coordinates]
                               = None,
                               beta: float = BETA, lambda_: float = LAMBDA,
                               draw_fig: bool = False) -> Coordinates:
        """The confirmed cells of ``t1`` (its segmented cells if None)
        predicted at ``t2`` from the two volumes' ``seg/`` point sets
        (``trackerlite.py:70-109``).  ``draw_fig=True`` also draws the
        prediction (``viz.plot_prgls_prediction``; it needs matplotlib)."""
        assert t2 not in self.miss_frame
        seg_t1 = self._get_segmented_pos(t1)
        seg_t2 = self._get_segmented_pos(t2)
        if confirmed_coord_t1 is None:
            confirmed_coord_t1 = seg_t1
        p1, m1 = self._pad(seg_t1.real.cpu().numpy())
        p2, m2 = self._pad(seg_t2.real.cpu().numpy())
        tracked = track_step(self.ffn_params, self.ffn_state,
                             confirmed_coord_t1.real.to(self.device), p1, m1,
                             p2, m2, beta=beta, lambda_=lambda_,
                             m_step_refine=self.m_step_refine).tracked
        coords = Coordinates.from_real(
            tracked, self.proofed_coords_vol1.interpolation_factor,
            self.proofed_coords_vol1.voxel_size)
        if draw_fig:
            plot_prgls_prediction(confirmed_coord_t1.real.cpu().numpy(),
                                  seg_t2.real.cpu().numpy(),
                                  coords.real.cpu().numpy(), t1, t2)
        return coords

    def predict_cell_positions_ensemble(self, skipped_volumes: List[int],
                                        t2: int, coord_t1: Coordinates,
                                        beta: float = BETA,
                                        lambda_: float = LAMBDA,
                                        sampling_number: int = 20,
                                        adjacent: bool = False,
                                        t_start: int = 1) -> Coordinates:
        """``t2`` predicted from each reference volume's confirmed
        coordinates as written in ``track_results/coords_real/``, combined
        by the 10% trimmed mean (``trackerlite.py:111-125``).  The host
        reads the artifacts; the members then run as one batch
        (``track_step`` with a member axis), each as it runs alone."""
        seg_t2 = self._get_segmented_pos(t2)
        p2, m2 = self._pad(seg_t2.real.cpu().numpy())
        confirmed, seg1, mask1 = [], [], []
        for t1 in get_volumes_list(t2, skipped_volumes, sampling_number,
                                   adjacent, t_start):
            confirmed.append(Coordinates.from_real(
                self.tree.load_coords_real(t1),
                coord_t1.interpolation_factor, coord_t1.voxel_size,
                device=self.device).real)
            p1, m1 = self._pad(self._get_segmented_pos(t1).real.cpu()
                               .numpy())
            seg1.append(p1)
            mask1.append(m1)
        tracked = track_step(self.ffn_params, self.ffn_state,
                             torch.stack(confirmed), torch.stack(seg1),
                             torch.stack(mask1), p2, m2, beta=beta,
                             lambda_=lambda_,
                             m_step_refine=self.m_step_refine).tracked
        # each member as predict_cell_positions returns it
        preds = Coordinates.from_real(
            tracked, self.proofed_coords_vol1.interpolation_factor,
            self.proofed_coords_vol1.voxel_size).real
        return Coordinates.from_real(
            trim_mean(preds, 0.1), self.proofed_coords_vol1
            .interpolation_factor, self.proofed_coords_vol1.voxel_size)

    def match_by_ffn(self, t1: int, t2: int,
                     confirmed_coord_t1: Optional[Coordinates] = None
                     ) -> np.ndarray:
        """The FFN's initial matching of the confirmed cells of ``t1``
        (its segmented cells if None) to the segmented cells of ``t2``
        (``trackerlite.py:127-142``): (k, 2) (ref, tgt) row pairs.  It
        also draws the matching (``viz.plot_initial_matching``), a figure
        left open as JAX leaves it; where that fails (no matplotlib), it
        prints JAX's "matching figure skipped" line."""
        assert t2 not in self.miss_frame
        seg_t1 = self._get_segmented_pos(t1)
        seg_t2 = self._get_segmented_pos(t2)
        if confirmed_coord_t1 is None:
            confirmed_coord_t1 = seg_t1
        pr, mr = self._pad(confirmed_coord_t1.real.cpu().numpy())
        pt, mt = self._pad(seg_t2.real.cpu().numpy())
        _, pairs = match_step(self.ffn_params, self.ffn_state, pr, mr, pt,
                              mt)
        pairs_px2 = np.argwhere(pairs.cpu().numpy())[:, [1, 0]]
        try:
            plot_initial_matching(confirmed_coord_t1.real.cpu().numpy(),
                                  seg_t2.real.cpu().numpy(), pairs_px2, t1,
                                  t2)
        except Exception as e:
            print(f"matching figure skipped: {e}")
        return pairs_px2

    def activities(self, raw_path: str, discard_ratio: float = 0.1,
                   do_normalize: bool = False) -> np.ndarray:
        """(volumes, cells) activities from the tracked labels in
        ``track_results/labels/`` over the raw recording
        (``trackerlite.py:152-201``): per cell, the mean of its voxels
        strictly above its ``1 - discard_ratio`` percentile
        (``ops.segment_reduce.topq_mean_intensity``, on the device).  A
        volume whose raw images are missing ends the readout; one whose
        labels are missing reads NaN."""
        labels_dir = self.tree.labels_dir
        filenames = glob(str(labels_dir / "*t*.tif"))
        assert len(filenames) > 0, f"No labels found in {labels_dir}"
        numbers = [int(re.findall(r"t(\d+)", Path(f).name)[0])
                   for f in filenames]
        t_min, t_max = min(numbers), max(numbers)
        activities = None
        cell_num = 0
        for t in range(t_min, t_max + 1):
            try:
                raw = load_2d_slices_at_time(raw_path, t=t,
                                             do_normalize=do_normalize)
            except FileNotFoundError:
                print(f"Warning: raw images at t={t} missing; stopping.")
                break
            try:
                labels = load_2d_slices_at_time(
                    str(labels_dir / "*t%06i*.tif"), t=t, do_normalize=False)
            except FileNotFoundError:
                if t == t_min:
                    print("Warning: no label images; stopping.")
                    break
                print(f"Warning: skip volume {t}")
                activities[t - t_min, :] = np.nan
                continue
            if t == t_min:
                cell_num = int(labels.max())
                activities = np.zeros((t_max - t_min + 1, cell_num))
            activities[t - t_min] = topq_mean_intensity(
                torch.from_numpy(raw.astype(np.float32)).to(self.device),
                torch.from_numpy(labels.astype(np.int32)).to(self.device),
                cell_num, discard_ratio=discard_ratio).cpu().numpy()
        return activities
