"""Accuracy of a run against ground truth (counterpart of
``3deecelltracker_tpu/engine/metrics.py``: ``instance_matching`` :52 and
``tracking_accuracy`` :95, and of ``bench.py::tracking_id_metrics``
:338-366), in numpy: the card's machine has no JAX to run them.

The instance contingency table is one ``np.bincount`` over the label
pairs, as the JAX version's; every other step is the same host code.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _pair_contingency(gt: np.ndarray, pred: np.ndarray, max_gt: int,
                      max_pred: int):
    """Intersection voxel counts of every (gt, pred) label pair and the
    per-label sizes, in one pass."""
    g = np.clip(gt.reshape(-1).astype(np.int64), 0, max_gt)
    p = np.clip(pred.reshape(-1).astype(np.int64), 0, max_pred)
    inter = np.bincount(g * (max_pred + 1) + p,
                        minlength=(max_gt + 1) * (max_pred + 1))
    return (inter.reshape(max_gt + 1, max_pred + 1),
            np.bincount(g, minlength=max_gt + 1),
            np.bincount(p, minlength=max_pred + 1))


def instance_matching(gt_labels: np.ndarray, pred_labels: np.ndarray,
                      iou_thresh: float = 0.5) -> Dict[str, float]:
    """Greedy one-to-one IoU matching of instances above ``iou_thresh``
    (stardist ``matching`` semantics): precision, recall, F1, mean matched
    IoU, tp / fp / fn."""
    n_gt = int(gt_labels.max())
    n_pred = int(pred_labels.max())
    if n_gt == 0 or n_pred == 0:
        return dict(precision=0.0, recall=0.0, f1=0.0, mean_matched_iou=0.0,
                    tp=0, fp=n_pred, fn=n_gt)
    inter, gt_sizes, pred_sizes = _pair_contingency(
        np.asarray(gt_labels), np.asarray(pred_labels), n_gt, n_pred)
    inter = inter[1:, 1:].astype(np.float64)
    gs = gt_sizes[1:].astype(np.float64)
    ps = pred_sizes[1:].astype(np.float64)
    union = gs[:, None] + ps[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)

    tp, matched_iou = 0, []
    used_g = np.zeros(n_gt, bool)
    used_p = np.zeros(n_pred, bool)
    for flat in np.argsort(-iou, axis=None):
        g_i, p_i = divmod(int(flat), n_pred)
        if iou[g_i, p_i] < iou_thresh:
            break
        if used_g[g_i] or used_p[p_i]:
            continue
        used_g[g_i] = used_p[p_i] = True
        tp += 1
        matched_iou.append(iou[g_i, p_i])
    fp, fn = n_pred - tp, n_gt - tp
    return dict(precision=tp / max(tp + fp, 1), recall=tp / max(tp + fn, 1),
                f1=2 * tp / max(2 * tp + fp + fn, 1),
                mean_matched_iou=float(np.mean(matched_iou))
                if matched_iou else 0.0,
                tp=tp, fp=fp, fn=fn)


def tracking_accuracy(tracked_by_t: Dict[int, np.ndarray],
                      truth_by_t: Dict[int, np.ndarray],
                      radius: float = 3.0,
                      assign_at: int = None) -> Dict[str, float]:
    """Fraction of tracked positions within ``radius`` of their true
    trajectory.  Identities are assigned one to one at ``assign_at`` (the
    first common time point by default) by greedy nearest pairs, so a
    tracker that collapses every cell onto one trajectory cannot score."""
    ts = sorted(set(tracked_by_t) & set(truth_by_t))
    if not ts:
        raise ValueError(
            f"tracking_accuracy: no common time point between tracked "
            f"({sorted(tracked_by_t)[:5]}...) and truth "
            f"({sorted(truth_by_t)[:5]}...)")
    t0 = assign_at if assign_at is not None else ts[0]
    if t0 not in tracked_by_t or t0 not in truth_by_t:
        raise ValueError(
            f"tracking_accuracy: assign_at={t0} is not present in both "
            f"trajectory dicts (common time points: {ts[:5]}...)")
    d0 = np.linalg.norm(tracked_by_t[t0][:, None, :]
                        - truth_by_t[t0][None, :, :], axis=2)
    n_tr, n_gt = d0.shape
    assign = np.full(n_tr, -1, int)
    used_gt = np.zeros(n_gt, bool)
    for flat in np.argsort(d0, axis=None):
        i, j = divmod(int(flat), n_gt)
        if assign[i] >= 0 or used_gt[j]:
            continue
        assign[i] = j
        used_gt[j] = True
        if used_gt.all() or (assign >= 0).all():
            break
    # tracked cells left without a true one (more tracked than truth)
    # count as errors
    unmatched = assign < 0
    assign = np.where(unmatched, 0, assign)
    correct, total = 0, 0
    per_t = {}
    for t in ts:
        err = np.linalg.norm(tracked_by_t[t] - truth_by_t[t][assign],
                             axis=1)
        ok = (err <= radius) & ~unmatched
        per_t[t] = float(ok.mean())
        correct += int(ok.sum())
        total += err.size
    return dict(accuracy=correct / max(total, 1), per_volume=per_t)


def tracking_id_metrics(coords_by_t: Dict[int, np.ndarray],
                        centers_by_t: Dict[int, np.ndarray],
                        voxel_size: Tuple[float, float, float],
                        last_t: int) -> Dict[str, float]:
    """Identity-strict accuracy against the true centres (zyx, voxels):
    identities assigned one to one at t = 1 (:func:`tracking_accuracy`)
    at a gate of half the median nearest-neighbour spacing of the true
    t = 1 cloud; strict recall at ``last_t``, accuracy over every t, and
    identity switches (a tracked row whose nearest true centre changes
    between consecutive volumes)."""
    sc = np.asarray(voxel_size, np.float64)
    gt = {t: centers_by_t[t][:, [1, 2, 0]] * sc for t in centers_by_t}
    d1 = np.linalg.norm(gt[1][:, None] - gt[1][None, :], axis=2)
    np.fill_diagonal(d1, np.inf)
    gate = 0.5 * float(np.median(d1.min(axis=1)))
    acc = tracking_accuracy(coords_by_t, gt, radius=gate, assign_at=1)
    switches = 0
    prev_id = None
    for t in sorted(set(coords_by_t) & set(gt)):
        d = np.linalg.norm(coords_by_t[t][:, None] - gt[t][None, :],
                           axis=2)
        cur = d.argmin(axis=1)
        if prev_id is not None:
            switches += int(np.sum(cur != prev_id))
        prev_id = cur
    return dict(gate=round(gate, 2),
                strict_recall=round(acc["per_volume"][last_t], 4),
                strict_accuracy_all_t=round(acc["accuracy"], 4),
                id_switches=switches)
