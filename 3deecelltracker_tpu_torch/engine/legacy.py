"""The legacy v0.4 U-Net segment-and-track path on arrays, single mode
(counterpart of ``3deecelltracker_tpu/engine/legacy.py``:
``legacy_fit_and_predict``, ``legacy_correction_and_render``, and the
single-mode methods of ``Tracker``).

Per volume: the U-Net segmenter (``engine.segmentation``), then
``track_one_vol``: 5 reps of FFN matching + the v0.4 PR-GLS fit with beta
annealed by 0.8 per rep, the motion replayed onto the tracked set, boundary
flags, the accurate correction (<= 20 x paste + probability-weighted centre
of mass + rint) and the label render with boundary recalculation.  The
per-cell history (displacements, segmented and tracked coordinates) stays in
float64 numpy on the host, exactly as the JAX ``Tracker`` keeps it; volumes
and the fit run on the device.

Not part of this port yet: folders and TIFFs (``load_unet``,
``load_ffn``, ``load_manual_seg``, ``save_coordinates``, the ``unet_cache``),
ensemble mode (``legacy_fit_members``, trim mean), miss frames,
``paste_mode="reference"``, U-Net retraining and drawing.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SegmentationConfig, TrackingConfig
from ..models.ffn import ffn_pair_scores
from ..models.unet3d import UNet3D
from ..ops.connected import label_components_values
from ..ops.knn import knn_feature_vectors
from ..ops.numerics import float64_to_float16
from ..ops.prgls import gaussian_gram, pr_gls_quick
from ..ops.segment_reduce import center_of_mass
from ..ops.subregions import (SubregionAtlas, build_subregion_atlas,
                              move_cells_sampled)
from ..ops.watershed import recalculate_cell_boundaries
from ..utils.device import select_device, to_device
from .segmentation import SegResult, UNetSegmenter
from .transformer import _box_shape, _relabel_sequential_np

REP_NUM_PRGLS = 5          # tracker.py:45
REP_NUM_CORRECTION = 20    # tracker.py:46
BOUNDARY_XY = 6            # tracker.py:47
K_POINTS = 20
CHECK_EVERY = 4            # correction rounds between host loop checks
PARK = 1e6                 # coordinate of padded points


def legacy_fit_and_predict(ffn_params, ffn_state, inter0: torch.Tensor,
                           inter_mask: torch.Tensor, tgt: torch.Tensor,
                           tgt_mask: torch.Tensor, tracked0: torch.Tensor,
                           beta0: float, lambda_: float,
                           rep: int = REP_NUM_PRGLS, max_iteration: int = 20,
                           k_points: int = K_POINTS):
    """The legacy per-source prediction (``tracker.py:1224-1289``) over
    padded point sets: ``rep`` x (kNN features, FFN scores, v0.4 PR-GLS with
    beta0 * 0.8^i) interleaved with the motion replay on ``tracked0``.
    beta and lambda are float32, as the JAX twin traces them.  Returns
    (pred (n_t0, 3), inters (rep, M, 3), Cs (rep, 3, M)); raises
    ``torch.linalg.LinAlgError`` after the ``rep`` fits if any of their
    M-step solves failed (one host sync per call)."""
    dev = tgt.device
    beta0 = torch.tensor(beta0, dtype=torch.float32, device=dev)
    lambda_ = torch.tensor(lambda_, dtype=torch.float32, device=dev)
    feats_t = knn_feature_vectors(tgt, tgt_mask, k_points)
    inter = inter0
    pred = tracked0.to(torch.float32)
    inters, cs = [], []
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(rep):
        beta_i = beta0 * torch.tensor(0.8 ** i, dtype=torch.float32,
                                      device=dev)
        feats_r = knn_feature_vectors(inter, inter_mask, k_points)
        corr = ffn_pair_scores(ffn_params, ffn_state, feats_r, feats_t)
        res = pr_gls_quick(inter, tgt, corr, beta=beta_i,
                           max_iteration=max_iteration, lambda_=lambda_,
                           ref_mask=inter_mask, tgt_mask=tgt_mask)
        gram = gaussian_gram(pred, inter, beta_i * beta_i)
        gram = torch.where(inter_mask[None, :], gram, 0.0)
        inters.append(inter)
        cs.append(res.coefficients)
        failed = failed | res.solve_failed
        pred = pred + gram @ res.coefficients.T
        inter = res.moved_ref
    if bool(failed):
        raise torch.linalg.LinAlgError(
            "legacy PR-GLS: an M-step solve met a zero pivot or gave a "
            "non-finite coefficient")
    return pred, torch.stack(inters), torch.stack(cs)


def legacy_correction_and_render(atlas: SubregionAtlas,
                                 weights: torch.Tensor,
                                 i_disp0: torch.Tensor,
                                 include: torch.Tensor,
                                 tracked_t0_real: torch.Tensor,
                                 z_xy_ratio: float, z_scaling: float,
                                 max_repetition: int = REP_NUM_CORRECTION):
    """The legacy accurate-correction fixed point (``tracker.py:1177-1191,
    1310-1348``) and the final label render (:1391-1400), with the JAX
    twin's defaults (``overlap_mode="add"``, ``out_of_range="clip"``): at
    most ``max_repetition`` x (paste, weighted centre of mass, rint) while
    the largest correction is >= 0.5 interpolated voxels.  The loop state
    freezes on the device once that condition fails; the host looks every
    ``CHECK_EVERY`` rounds, so it ends at JAX's iteration.  Returns
    (r_disp (n, 3) f32, i_disp (n, 3) int32, labels (x, y, z) int32)."""
    dev = weights.device
    f32 = torch.float32
    weights = weights.to(f32)
    n_t0 = atlas.n_cells
    one = torch.tensor(1.0, dtype=f32, device=dev)
    zr = torch.tensor(z_xy_ratio, dtype=f32, device=dev)
    zs = torch.tensor(z_scaling, dtype=f32, device=dev)
    to_layer = torch.stack([one, one, one / zr])
    to_interp = torch.stack([one, one, zs / zr])
    per_interp = torch.stack([one, one, one / zs])
    to_real = torch.stack([one, one, zr / zs])
    z_real = torch.stack([one, one, zr])
    base = tracked_t0_real.to(f32) * to_layer

    def once(i_disp):
        labels, overlap = move_cells_sampled(atlas, i_disp, include)
        markers = torch.where(overlap > 1, 0, labels)
        centers = center_of_mass(weights, markers, n_t0)
        l_moved = base + i_disp.to(f32) * per_interp
        lost = torch.isnan(centers[:, 0])
        corr = torch.where(lost[:, None], 0.0, centers - l_moved) * z_real
        r_disp = i_disp.to(f32) * to_real + corr
        i_new = torch.round(r_disp * to_interp).to(torch.int32)
        return r_disp, i_new, torch.max(torch.abs(corr * to_interp))

    i_disp = i_disp0.to(torch.int32)
    r_disp = torch.zeros_like(base)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    metric = torch.tensor(torch.inf, dtype=f32, device=dev)
    done = False
    while not done:
        for _ in range(CHECK_EVERY):
            active = (it < max_repetition) & (metric >= 0.5)
            n_r, n_i, n_metric = once(i_disp)
            r_disp = torch.where(active, n_r, r_disp)
            i_disp = torch.where(active, n_i, i_disp)
            metric = torch.where(active, n_metric, metric)
            it = it + active.to(torch.int32)
        done = not bool((it < max_repetition) & (metric >= 0.5))
    labels, overlap = move_cells_sampled(atlas, i_disp, include)
    labels = torch.where(overlap > 1, 0, labels)
    return r_disp, i_disp, recalculate_cell_boundaries(labels, overlap)


class History:
    """tracker.py:756-776."""

    def __init__(self):
        self.r_displacements = []
        self.r_segmented_coordinates = []
        self.r_tracked_coordinates = []


class Tracker:
    """Legacy orchestrator (tracker.py:779-1551), single mode, on arrays:
    raw volumes and the proofed vol-1 labels come in as (x, y, z) arrays
    instead of TIFF folders."""

    def __init__(self, volume_num: int, siz_xyz: tuple, z_xy_ratio,
                 z_scaling, noise_level, min_size, beta_tk, lambda_tk,
                 maxiter_tk, cell_num: int = 0, shrink=(24, 24, 2),
                 max_cells: int = 512, device=None):
        self.volume_num = volume_num
        self.x_siz, self.y_siz, self.z_siz = siz_xyz
        self.z_xy_ratio = float(z_xy_ratio)
        self.z_scaling = int(z_scaling)
        self.noise_level = noise_level
        self.min_size = min_size
        self.beta_tk = beta_tk
        self.lambda_tk = lambda_tk
        self.max_iteration = maxiter_tk
        self.cell_num = cell_num
        self.shrink = tuple(shrink)
        self.max_cells = max_cells
        self.device = select_device(device)
        self.history = History()
        self.unet_model: Optional[UNet3D] = None
        self.segmenter: Optional[UNetSegmenter] = None
        self.ffn_params = None
        self.ffn_state = None
        self.cells_on_boundary = None
        self.cell_num_t0 = None
        self.atlas: Optional[SubregionAtlas] = None
        self.segresult: Optional[SegResult] = None
        self.tracked_labels: Optional[torch.Tensor] = None

    # ---- model loading ------------------------------------------------------
    def _build_segmenter(self):
        cfg = SegmentationConfig(
            noise_level=self.noise_level, min_size=self.min_size,
            cell_num=self.cell_num, z_xy_ratio=self.z_xy_ratio,
            z_scaling=self.z_scaling, shrink=self.shrink)
        self.segmenter = UNetSegmenter(
            self.unet_model, self.unet_params, self.unet_bn_state, cfg,
            (self.x_siz, self.y_siz, self.z_siz), max_cells=self.max_cells,
            device=self.device)

    def load_unet_arrays(self, model: UNet3D, params, bn_state):
        self.unet_model = model
        self.unet_params, self.unet_bn_state = params, bn_state
        self._build_segmenter()

    def load_ffn_arrays(self, params, state):
        self.ffn_params = to_device(params, self.device)
        self.ffn_state = to_device(state, self.device)

    # ---- segmentation (tracker.py:583-603) ----------------------------------
    def _segment(self, image_raw, method: str = "min_size") -> SegResult:
        result = self.segmenter.segment(image_raw, method=method)
        # the segmenter learned min_size / cell_num (tracker.py:681-683)
        self.min_size = self.segmenter.config.min_size
        self.cell_num = self.segmenter.config.cell_num
        return result

    def segment_vol1(self, image_raw, method: str = "min_size"):
        self.segresult = self._segment(image_raw, method)
        self.r_coordinates_segment_t0 = \
            self.segresult.r_coordinates_segment.cpu().numpy()

    # ---- manual seg + interpolation (tracker.py:908-921, 1046-1112) ---------
    def interpolate_seg(self, manual_vol1_xyz: np.ndarray):
        """``load_manual_seg`` + ``interpolate_seg`` on an array: relabel
        the proofed vol-1 labels, smooth them through the z-interpolated
        atlas, split labels into value-equal components, rebuild the atlas,
        and set the vol-1 tracked labels and coordinates."""
        seg = torch.from_numpy(_relabel_sequential_np(
            np.asarray(manual_vol1_xyz).astype(np.int32))).to(self.device)
        n0 = int(seg.max())
        labels, overlap = move_cells_sampled(self._make_atlas(seg))
        smoothed = recalculate_cell_boundaries(labels, overlap)
        corrected = label_components_values(smoothed, connectivity=3)
        if int(corrected.max()) != n0:
            print(f"WARNING: {n0} cells were manually labeled while the "
                  f"program found {int(corrected.max())} separated cells "
                  "and corrected it")
        self.atlas = self._make_atlas(corrected)
        labels, overlap = move_cells_sampled(self.atlas)
        self.segmentation_manual_relabels = recalculate_cell_boundaries(
            labels, overlap)
        n = self.atlas.n_cells
        com = center_of_mass((self.segmentation_manual_relabels > 0).to(
            torch.float32), self.segmentation_manual_relabels, n)
        self.r_coordinates_tracked_t0 = com.cpu().numpy() * np.array(
            [1.0, 1.0, self.z_xy_ratio])
        self.cell_num_t0 = n

    def _make_atlas(self, seg: torch.Tensor) -> SubregionAtlas:
        n = int(seg.max())
        return build_subregion_atlas(seg, n_cells=n,
                                     box_shape=_box_shape(seg, n),
                                     interpolation_factor=self.z_scaling,
                                     smooth_sigma=2.5)

    # ---- tracking core ------------------------------------------------------
    def initiate_tracking(self):
        self.cells_on_boundary = np.zeros(self.cell_num_t0, int)
        self.history.r_displacements = [np.zeros((self.cell_num_t0, 3))]
        self.history.r_segmented_coordinates = [
            self.r_coordinates_segment_t0]
        self.history.r_tracked_coordinates = [self.r_coordinates_tracked_t0]

    def _pad_pts(self, pts: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad to ``max_cells`` rows (parked far) + mask, on the device."""
        n = pts.shape[0]
        if n > self.max_cells:
            raise ValueError(f"{n} cells exceeds max_cells="
                             f"{self.max_cells}")
        out = np.full((self.max_cells, 3), PARK, np.float32)
        out[:n] = pts
        mask = np.zeros((self.max_cells,), bool)
        mask[:n] = True
        return (torch.from_numpy(out).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _fused_predict_inputs(self, source_volume: int):
        inter0, m1 = self._pad_pts(np.asarray(
            self.history.r_segmented_coordinates[source_volume - 1],
            np.float32))
        tracked0 = torch.from_numpy(np.asarray(
            self.history.r_tracked_coordinates[source_volume - 1],
            np.float32)).to(self.device)
        return inter0, m1, tracked0

    def _get_cells_onBoundary(self, r_coords: np.ndarray) -> np.ndarray:
        """tracker.py:1291-1308, single mode (a 6-voxel xy margin)."""
        b = BOUNDARY_XY
        return np.where(
            (r_coords[:, 0] < b) | (r_coords[:, 1] < b)
            | (r_coords[:, 0] > self.x_siz - b)
            | (r_coords[:, 1] > self.y_siz - b)
            | (r_coords[:, 2] / self.z_xy_ratio < 0)
            | (r_coords[:, 2] / self.z_xy_ratio > self.z_siz))[0]

    def _seed_displacements(self, r_coor_predicted: np.ndarray):
        """Displacement seed from the prediction (tracker.py:1496-1500):
        accumulated real displacement plus this volume's predicted move,
        rounded to the interpolated-image integer grid."""
        r_disp = self.history.r_displacements[-1] + \
            (r_coor_predicted - self.history.r_tracked_coordinates[-1])
        i_disp = np.rint(r_disp * np.array(
            [1, 1, self.z_scaling / self.z_xy_ratio])).astype(np.int32)
        return r_disp, i_disp

    def track_one_vol(self, target_volume: int, segresult: SegResult):
        """tracker.py:1473-1536, single-source branch, with the volume's
        segmentation given (``segresult``, e.g. from :meth:`_segment`).
        The tracked labels stay on the device in ``tracked_labels``."""
        self.segresult = segresult
        tgt, m2 = self._pad_pts(np.asarray(
            segresult.r_coordinates_segment.cpu().numpy(), np.float32))
        inter0, m1, tracked0 = self._fused_predict_inputs(target_volume - 1)
        pred, _, _ = legacy_fit_and_predict(
            self.ffn_params, self.ffn_state, inter0, m1, tgt, m2, tracked0,
            self.beta_tk, self.lambda_tk, rep=REP_NUM_PRGLS,
            max_iteration=self.max_iteration)
        r_coor_mean = pred.cpu().numpy().astype(np.float64)
        cells_bd = self._get_cells_onBoundary(r_coor_mean)
        self.cells_on_boundary[cells_bd] = 1
        _, i_disp0 = self._seed_displacements(r_coor_mean)
        # the JAX twin ships the weight map as float16 (accumulation f32)
        weights = float64_to_float16(
            (segresult.image_cell_bg + segresult.image_gcn).double())
        include = torch.from_numpy(self.cells_on_boundary == 0).to(
            self.device)
        r_disp, _, labels = legacy_correction_and_render(
            self.atlas, weights, torch.from_numpy(i_disp0).to(self.device),
            include, torch.from_numpy(np.asarray(
                self.r_coordinates_tracked_t0, np.float32)).to(self.device),
            self.z_xy_ratio, self.z_scaling,
            max_repetition=REP_NUM_CORRECTION)
        r_disp = r_disp.cpu().numpy().astype(np.float64)
        self.tracked_labels = labels
        self.history.r_displacements.append(r_disp)
        self.history.r_segmented_coordinates.append(
            segresult.r_coordinates_segment.cpu().numpy())
        self.history.r_tracked_coordinates.append(
            self.r_coordinates_tracked_t0 + r_disp)


@dataclasses.dataclass
class LegacyResult:
    """``coords[t]``: (n, 3) float64 real coordinates (the tracker's
    history); ``labels[t]``: uint16 (x, y, z) tracked labels (t = 1: the
    interpolated proofed labels); ``cells[t]``: cells the segmenter found;
    ``auto_vol1``: the vol-1 automatic segmentation, int32 (x, y, z)."""
    coords: Dict[int, np.ndarray]
    labels: Dict[int, np.ndarray]
    cells: Dict[int, int]
    auto_vol1: np.ndarray


def legacy_segment_and_track_arrays(
        volumes_xyz: Sequence[np.ndarray], unet, ffn_weights,
        manual_vol1_xyz: np.ndarray, config: SegmentationConfig,
        tracking: TrackingConfig = TrackingConfig(
            beta=300.0, lambda_=0.1, max_iteration=20),
        max_cells: int = 512, device=None, timer=None) -> LegacyResult:
    """The legacy single-mode workflow on arrays (``examples/
    use_unet_legacy.py``: segment_vol1 -> load_manual_seg ->
    interpolate_seg -> initiate_tracking -> track), for raw (x, y, z)
    volumes in t order.  ``unet``: (UNet3D spec, params, state);
    ``ffn_weights``: (params, state).  ``config`` carries the segmentation
    knobs (noise_level, min_size, z_xy_ratio, z_scaling, shrink),
    ``tracking`` beta, lambda and the PR-GLS iterations.  ``timer``:
    optional object whose ``stage(name)`` is a context manager around each
    volume's "seg" (U-Net + watersheds) and "track" (fit, correction,
    render and the label download) calls."""
    if tracking.ensemble:
        raise ValueError("legacy_segment_and_track_arrays supports single "
                         "mode only")
    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext())
    model, params, state = unet
    tracker = Tracker(len(volumes_xyz), tuple(volumes_xyz[0].shape),
                      config.z_xy_ratio, config.z_scaling, config.noise_level,
                      config.min_size, tracking.beta, tracking.lambda_,
                      tracking.max_iteration, cell_num=config.cell_num,
                      shrink=config.shrink, max_cells=max_cells,
                      device=device)
    tracker.load_unet_arrays(model, params, state)
    tracker.load_ffn_arrays(*ffn_weights)
    with stage("seg"):
        tracker.segment_vol1(volumes_xyz[0])
    cells = {1: int(tracker.segresult.r_coordinates_segment.shape[0])}
    auto_vol1 = tracker.segresult.segmentation_auto.cpu().numpy()
    tracker.interpolate_seg(manual_vol1_xyz)
    tracker.initiate_tracking()
    labels = {1: tracker.segmentation_manual_relabels.cpu().numpy().astype(
        np.uint16)}
    for t in range(2, len(volumes_xyz) + 1):
        with stage("seg"):
            seg = tracker._segment(volumes_xyz[t - 1])
        cells[t] = int(seg.r_coordinates_segment.shape[0])
        with stage("track"):
            tracker.track_one_vol(t, segresult=seg)
            labels[t] = tracker.tracked_labels.cpu().numpy().astype(
                np.uint16)
    coords = {t: c for t, c in enumerate(
        tracker.history.r_tracked_coordinates, start=1)}
    return LegacyResult(coords, labels, cells, auto_vol1)
