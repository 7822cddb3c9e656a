"""Accuracy of a run against ground truth (counterpart of
``3deecelltracker_tpu/engine/metrics.py``: ``instance_matching`` :52 and
``tracking_accuracy`` :95, ``optimize_thresholds`` :174-238, and of
``bench.py::tracking_id_metrics`` :338-366), in numpy: the card's machine
has no JAX to run them.

The instance contingency table is one ``np.bincount`` over the label
pairs, as the JAX version's; every other step is the same host code.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


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


def optimize_thresholds(model, X_val: Sequence[np.ndarray],
                        Y_val: Sequence[np.ndarray],
                        prob_grid: Sequence[float] = (0.3, 0.4, 0.5, 0.6,
                                                      0.7),
                        nms_grid: Sequence[float] = (0.3, 0.4, 0.5),
                        iou_thresh: float = 0.5,
                        verbose: bool = True) -> Tuple[float, float]:
    """Grid-search ``(prob_thresh, nms_thresh)`` maximizing the mean
    F1@IoU over validation volumes (normalized (z, y, x) images, labels in
    the same frame) and store the best pair on ``model.thresholds`` (the
    first best in grid order).  The backbone runs once per volume
    (``StarDist3D.forward_grid``); only candidates, NMS and the render
    run again per grid point (``instances_from_grid``), with the
    thresholds in float32 as JAX passes them."""
    if len(X_val) == 0 or len(X_val) != len(Y_val):
        raise ValueError(
            f"optimize_thresholds needs matched non-empty X_val/Y_val "
            f"(got {len(X_val)} images, {len(Y_val)} labels)")
    grids = []
    with torch.no_grad():
        for x in X_val:
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
                model.device)
            grids.append(model.forward_grid(xt) + (tuple(x.shape),))
    best = (-1.0, None, None)
    with torch.no_grad():
        for prob_t in prob_grid:
            for nms_t in nms_grid:
                scores = []
                for (prob_g, dist_g, shape), y in zip(grids, Y_val):
                    labels = model.instances_from_grid(
                        prob_g, dist_g, shape, float(np.float32(prob_t)),
                        float(np.float32(nms_t)))[-1]
                    scores.append(instance_matching(
                        y, labels.cpu().numpy().astype(np.int32),
                        iou_thresh)["f1"])
                mean_f1 = float(np.mean(scores))
                if verbose:
                    print(f"prob={prob_t:.2f} nms={nms_t:.2f} "
                          f"F1@{iou_thresh}={mean_f1:.4f}")
                if mean_f1 > best[0]:
                    best = (mean_f1, prob_t, nms_t)
    _, prob_t, nms_t = best
    if prob_t is None:
        raise RuntimeError(
            "optimize_thresholds: no grid point produced a finite score "
            "(all F1 values were NaN) - check the validation volumes")
    model.thresholds = dict(prob=prob_t, nms=nms_t)
    if verbose:
        print(f"selected prob_thresh={prob_t}, nms_thresh={nms_t} "
              f"(F1={best[0]:.4f})")
    return prob_t, nms_t
