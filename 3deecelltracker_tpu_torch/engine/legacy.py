"""The legacy v0.4 ``Tracker``, the U-Net generation of the API
(counterpart of ``3deecelltracker_tpu/engine/legacy.py``).

The folder workflow of ``examples/use_unet_legacy.py``: raw per-(t, z) TIFF
slices under ``<folder>/data/``, checkpoints under ``models/``, the proofed
vol-1 labels under ``manual_vol1/`` (``Paths.make_folders``).  Per volume:
the U-Net segmenter (``engine.segmentation``, its probabilities cached in
``unet_cache/``), then ``track_one_vol``: 5 reps of FFN matching + the v0.4
PR-GLS fit with beta annealed by 0.8 per rep, the motion replayed onto the
tracked set (in ensemble mode from every reference volume at once, one
batched fit, trim mean over the members), boundary flags, the accurate
correction (<= 20 x paste + probability-weighted centre of mass + rint) and
the label render with boundary recalculation, written as
``track_results_t%06i_z%04i.tif``.  Miss frames repeat the last labels and
displacement.  The per-cell history (displacements, segmented and tracked
coordinates) stays in float64 numpy on the host, as the JAX ``Tracker``
keeps it; volumes and the fits run on the device.

``paste_mode="reference"`` pastes cells as the reference does (id-order
last write wins, cells that leave the canvas dropped), ``"scatter"`` (the
default) sums overlapping ids and clamps.  ``retrain_unet`` retrains the
U-Net on the proofed vol 1 (``models.train_unet``).  ``load_unet`` and
``load_ffn`` take the reference's Keras ``.h5`` checkpoints
(``utils.keras_import``; they need ``h5py``).  The figures (``draw_*``,
``match``'s animation, ``save_figures``' per-volume 6-panel into
``anim/``) are drawn with matplotlib (``viz``), which they need.
``legacy_segment_and_track_arrays`` runs the single-mode workflow on
arrays, writing nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SegmentationConfig, TrackingConfig
from ..io.imageio import load_image, read_image_ts, save_label_slices
from ..models.ffn import ffn_pair_scores, init_ffn
from ..models.unet3d import UNet3D, get_unet
from ..ops.connected import label_components_values
from ..ops.knn import knn_feature_vectors
from ..ops.numerics import float64_to_float16
from ..ops.prgls import gaussian_gram, pr_gls_quick
from ..ops.segment_reduce import center_of_mass
from ..ops.subregions import (SubregionAtlas, build_subregion_atlas,
                              move_cells_sampled)
from ..ops.watershed import (find_boundaries_outer,
                             recalculate_cell_boundaries)
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.convert import ffn_from_numpy, unet_from_numpy
from ..utils.device import select_device, to_device
from ..utils.keras_import import import_ffn, import_unet3
from .. import viz
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
    M-step solves failed (one host sync per call).  A leading member axis
    on ``inter0``, ``inter_mask`` and ``tracked0`` ((E, M, 3), (E, M),
    (E, n_t0, 3)) fits every member to the one target at once: pred
    (E, n_t0, 3), inters (rep, E, M, 3), Cs (rep, E, 3, M)."""
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
        gram = torch.where(inter_mask[..., None, :], gram, 0.0)
        inters.append(inter)
        cs.append(res.coefficients)
        failed = failed | res.solve_failed
        pred = pred + gram @ res.coefficients.mT
        inter = res.moved_ref
    if bool(failed):
        raise torch.linalg.LinAlgError(
            "legacy PR-GLS: an M-step solve met a zero pivot or gave a "
            "non-finite coefficient")
    return pred, torch.stack(inters), torch.stack(cs)


def legacy_fit_members(ffn_params, ffn_state, inter0_stack: torch.Tensor,
                       inter_masks: torch.Tensor, tgt: torch.Tensor,
                       tgt_mask: torch.Tensor, tracked0_stack: torch.Tensor,
                       beta0: float, lambda_: float,
                       rep: int = REP_NUM_PRGLS, max_iteration: int = 20,
                       k_points: int = K_POINTS) -> torch.Tensor:
    """Every ensemble source volume in one batched fit
    (``tracker.py:1502-1507``): the (E, n_t0, 3) member predictions.  The
    caller pads E to the configured ensemble size by repeating a member and
    takes the trim mean over the real rows, as the JAX twin does."""
    pred, _, _ = legacy_fit_and_predict(
        ffn_params, ffn_state, inter0_stack, inter_masks, tgt, tgt_mask,
        tracked0_stack, beta0, lambda_, rep=rep, max_iteration=max_iteration,
        k_points=k_points)
    return pred


def legacy_correction_and_render(atlas: SubregionAtlas,
                                 weights: torch.Tensor,
                                 i_disp0: torch.Tensor,
                                 include: torch.Tensor,
                                 tracked_t0_real: torch.Tensor,
                                 z_xy_ratio: float, z_scaling: float,
                                 max_repetition: int = REP_NUM_CORRECTION,
                                 overlap_mode: str = "add",
                                 out_of_range: str = "clip",
                                 render: bool = True,
                                 labels_u8: bool = False):
    """The legacy accurate-correction fixed point (``tracker.py:1177-1191,
    1310-1348``) and the final label render (:1391-1400): at most
    ``max_repetition`` x (paste, weighted centre of mass, rint) while the
    largest correction is >= 0.5 interpolated voxels.  ``overlap_mode`` and
    ``out_of_range``: the paste's (``ops.subregions.move_cells_sampled``).
    The loop state freezes on the device once that condition fails; the
    host looks every ``CHECK_EVERY`` rounds, so it ends at JAX's
    iteration.  Returns (r_disp (n, 3) f32, i_disp (n, 3) int32, labels
    (x, y, z) int32, uint8 with ``labels_u8`` (valid for at most 255
    cells), or None without ``render``)."""
    dev = weights.device
    f32 = torch.float32
    weights = weights.to(f32)
    n_t0 = atlas.n_cells
    paste = dict(overlap_mode=overlap_mode, out_of_range=out_of_range)
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
        labels, overlap = move_cells_sampled(atlas, i_disp, include, **paste)
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
    if not render:
        return r_disp, i_disp, None
    labels = render_moved_labels(atlas, i_disp, include, **paste)
    return r_disp, i_disp, labels.to(torch.uint8) if labels_u8 else labels


def render_moved_labels(atlas: SubregionAtlas, i_disp: torch.Tensor,
                        include: torch.Tensor, **paste) -> torch.Tensor:
    """The included cells pasted at their displacements, overlaps
    cleared, and the boundaries recalculated (``tracker.py:1391-1400``):
    (x, y, z) int32 labels."""
    labels, overlap = move_cells_sampled(atlas, i_disp, include, **paste)
    labels = torch.where(overlap > 1, 0, labels)
    return recalculate_cell_boundaries(labels, overlap)


def get_tracking_path(adjacent: bool, ensemble, folder_path: str) -> str:
    """tracker.py:90-110."""
    if not ensemble:
        return os.path.join(folder_path, "track_results_SingleMode/")
    elif adjacent:
        return os.path.join(folder_path, "track_results_EnsembleAdjctMode/")
    return os.path.join(folder_path, "track_results_EnsembleDstrbtMode/")


def get_reference_vols(ensemble, vol: int, adjacent: bool = False
                       ) -> List[int]:
    """track.py:575-610: the source volumes of ``vol``'s prediction."""
    if not ensemble:
        return [vol - 1]
    if vol - 1 < ensemble:
        return list(range(1, vol))
    if adjacent:
        return list(range(vol - ensemble, vol))
    return get_remote_vols(ensemble, vol)


def get_remote_vols(ensemble, vol: int) -> List[int]:
    """track.py: ``ensemble`` evenly distributed earlier volumes."""
    interval = (vol - 1) // ensemble
    start = np.mod(vol - 1, ensemble) + 1
    return list(range(start, vol - interval + 1, interval))


class Paths:
    """tracker.py:687-753 folder conventions."""

    def __init__(self, folder_path, image_name, unet_model_file,
                 ffn_model_file):
        self.folder = folder_path
        self.image_name = image_name
        self.unet_model_file = unet_model_file
        self.ffn_model_file = ffn_model_file

    def make_folders(self, adjacent, ensemble):
        fp = self.folder

        def mk(p):
            os.makedirs(p, exist_ok=True)
            return p
        self.raw_image = mk(os.path.join(fp, "data/"))
        self.auto_segmentation_vol1 = mk(os.path.join(fp, "auto_vol1/"))
        self.manual_segmentation_vol1 = mk(os.path.join(fp, "manual_vol1/"))
        self.track_information = mk(os.path.join(fp, "track_information/"))
        self.models = mk(os.path.join(fp, "models/"))
        self.unet_cache = mk(os.path.join(fp, "unet_cache/"))
        self.track_results = mk(get_tracking_path(adjacent, ensemble, fp))
        self.anim = mk(os.path.join(fp, "anim/"))
        self.unet_weights = mk(os.path.join(self.models, "unet_weights/"))


class History:
    """tracker.py:756-776."""

    def __init__(self):
        self.r_displacements: List[np.ndarray] = []
        self.r_segmented_coordinates: List[np.ndarray] = []
        self.r_tracked_coordinates: List[np.ndarray] = []
        self.anim: List = []


def _numpy(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Tracker:
    """Legacy orchestrator (tracker.py:779-1551) with JAX's constructor and
    methods.  ``device``: the card unless ``"cpu"`` is passed."""

    def __init__(self, volume_num, siz_xyz: tuple, z_xy_ratio, z_scaling,
                 noise_level, min_size, beta_tk, lambda_tk, maxiter_tk,
                 folder_path, image_name, unet_model_file, ffn_model_file,
                 cell_num=0, ensemble=False, adjacent=False,
                 shrink=(24, 24, 2), miss_frame=None,
                 unet_variant: str = "a", max_cells: int = 512,
                 paste_mode: str = "scatter", *, device=None):
        self._init_state(volume_num, siz_xyz, z_xy_ratio, z_scaling,
                         noise_level, min_size, beta_tk, lambda_tk,
                         maxiter_tk, cell_num, ensemble, adjacent, shrink,
                         miss_frame, unet_variant, max_cells, paste_mode,
                         device)
        self.paths = Paths(folder_path, image_name, unet_model_file,
                           ffn_model_file)
        self.paths.make_folders(adjacent, ensemble)

    def _init_state(self, volume_num, siz_xyz, z_xy_ratio, z_scaling,
                    noise_level, min_size, beta_tk, lambda_tk, maxiter_tk,
                    cell_num, ensemble, adjacent, shrink, miss_frame,
                    unet_variant, max_cells, paste_mode, device):
        if paste_mode not in ("scatter", "reference"):
            raise ValueError(f"paste_mode {paste_mode!r}")
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
        self.ensemble = ensemble
        self.adjacent = adjacent
        self.shrink = tuple(shrink)
        self.miss_frame = [] if not miss_frame else miss_frame
        self.max_cells = max_cells
        self.device = select_device(device)
        self.paths: Optional[Paths] = None
        self.history = History()
        self.use_8_bit = True
        self.unet_variant = unet_variant
        self.unet_model: Optional[UNet3D] = None
        self.segmenter: Optional[UNetSegmenter] = None
        self.ffn_params = None
        self.ffn_state = None
        self.cells_on_boundary = None
        self.cell_num_t0 = None
        self.atlas: Optional[SubregionAtlas] = None
        self.segresult: Optional[SegResult] = None
        self.tracked_labels: Optional[torch.Tensor] = None
        self.save_figures = False
        # "scatter": overlaps accumulate and cells clamp at the canvas;
        # "reference": tracker.py:1366-1389's id-order last write wins and
        # out-of-range cells dropped
        self._paste_kwargs = (
            dict(overlap_mode="last", out_of_range="drop")
            if paste_mode == "reference" else {})

    @classmethod
    def _on_arrays(cls, volume_num, siz_xyz, config: SegmentationConfig,
                   tracking: TrackingConfig, max_cells: int,
                   device) -> "Tracker":
        """A single-mode tracker with no folder: it reads and writes
        nothing (``legacy_segment_and_track_arrays``)."""
        tracker = cls.__new__(cls)
        tracker._init_state(volume_num, siz_xyz, config.z_xy_ratio,
                            config.z_scaling, config.noise_level,
                            config.min_size, tracking.beta, tracking.lambda_,
                            tracking.max_iteration, config.cell_num, False,
                            False, config.shrink, None, "a", max_cells,
                            "scatter", device)
        return tracker

    # ---- parameter setters (tracker.py:520-550, 889-906) -----------------
    def set_segmentation(self, noise_level=None, min_size=None,
                         del_cache=False):
        changed = False
        if noise_level is not None and noise_level != self.noise_level:
            self.noise_level = noise_level
            changed = True
        if min_size is not None and min_size != self.min_size:
            self.min_size = min_size
            changed = True
        if changed or del_cache:
            for f in os.listdir(self.paths.unet_cache):
                os.remove(os.path.join(self.paths.unet_cache, f))
            print("All files under /unet_cache folder were deleted")
        if changed:
            self._build_segmenter()

    def set_tracking(self, beta_tk, lambda_tk, maxiter_tk):
        if (self.beta_tk, self.lambda_tk, self.max_iteration) == \
                (beta_tk, lambda_tk, maxiter_tk):
            print("Tracking parameters were not modified")
        else:
            self.beta_tk, self.lambda_tk, self.max_iteration = \
                beta_tk, lambda_tk, maxiter_tk
            print(f"Parameters were modified: beta_tk={beta_tk}, "
                  f"lambda_tk={lambda_tk}, maxiter_tk={maxiter_tk}")

    # ---- model loading ----------------------------------------------------
    def _build_segmenter(self):
        """The segmenter JAX's ``Tracker`` builds (``engine/legacy.py:
        346-353``): ``UNetSegmenter``'s default compute dtype, bfloat16."""
        self.segmenter = self._new_segmenter()

    def _new_segmenter(self, compute_dtype=torch.bfloat16) -> UNetSegmenter:
        """A segmenter of the current U-Net and settings computing in
        ``compute_dtype``."""
        cfg = SegmentationConfig(
            noise_level=self.noise_level, min_size=self.min_size,
            cell_num=self.cell_num, z_xy_ratio=self.z_xy_ratio,
            z_scaling=self.z_scaling, shrink=self.shrink)
        return UNetSegmenter(
            self.unet_model, self.unet_params, self.unet_bn_state, cfg,
            (self.x_siz, self.y_siz, self.z_siz), max_cells=self.max_cells,
            compute_dtype=compute_dtype, device=self.device)

    def _unet_template(self):
        return self.unet_model.init(torch.Generator().manual_seed(0),
                                    device=self.device)

    def load_unet(self):
        """Load ``models/<unet_model_file>``: an ``.npz`` that JAX's or the
        port's ``save_pytree`` wrote of ``(params, bn_state)`` (what
        ``TrainingUNet3D`` saves), or the reference's Keras ``.h5``
        (``tracker.py:579`` load_model, ``:991`` load_weights) through
        ``import_unet3(path, unet_variant)``; copy it to
        ``unet_weights/weights_initial.npz`` and build the segmenter."""
        path = os.path.join(self.paths.models, self.paths.unet_model_file)
        if path.endswith(".h5"):
            self.unet_model, params, state = import_unet3(
                path, self.unet_variant)
            self.unet_params, self.unet_bn_state = unet_from_numpy(
                params, state, self.device)
        else:
            self.unet_model = get_unet(self.unet_variant)
            self.unet_params, self.unet_bn_state = load_pytree(
                self._unet_template(), path)
        save_pytree((self.unet_params, self.unet_bn_state),
                    os.path.join(self.paths.unet_weights,
                                 "weights_initial.npz"))
        self._build_segmenter()
        print("Loaded the 3D U-Net model")

    def load_unet_arrays(self, model: UNet3D, params, bn_state):
        """In-memory variant for pipelines and tests."""
        self._set_unet(model, params, bn_state)
        self._build_segmenter()

    def _set_unet(self, model: UNet3D, params, bn_state):
        self.unet_model = model
        self.unet_params = to_device(params, self.device)
        self.unet_bn_state = to_device(bn_state, self.device)

    def load_ffn(self):
        """Load ``models/<ffn_model_file>``: an ``.npz`` of ``(params,
        state)`` that JAX's or the port's ``save_pytree`` wrote, or the
        reference's Keras ``.h5`` (``tracker.py:1121``, ``ffn.py:211-220``)
        through ``import_ffn``."""
        path = os.path.join(self.paths.models, self.paths.ffn_model_file)
        if path.endswith(".h5"):
            self.ffn_params, self.ffn_state = ffn_from_numpy(
                *import_ffn(path), self.device)
        else:
            self.ffn_params, self.ffn_state = load_pytree(
                init_ffn(torch.Generator().manual_seed(0),
                         device=self.device),
                path)
        print("Loaded the FFN model")

    def load_ffn_arrays(self, params, state):
        self.ffn_params = to_device(params, self.device)
        self.ffn_state = to_device(state, self.device)

    # ---- segmentation (tracker.py:583-603) ----------------------------------
    def _read_volume(self, vol: int) -> np.ndarray:
        pattern = os.path.join(self.paths.raw_image, self.paths.image_name)
        return read_image_ts(vol, pattern, (1, self.z_siz + 1))

    def _cache_path(self, vol: int) -> str:
        return os.path.join(self.paths.unet_cache, "t%06i.npy" % vol)

    def _segment_array(self, image_raw, method: str = "min_size",
                       cache_path=None) -> SegResult:
        result = self.segmenter.segment(image_raw, method=method,
                                        cache_path=cache_path)
        # the segmenter learned min_size / cell_num (tracker.py:681-683);
        # keep them for a later _build_segmenter
        self.min_size = self.segmenter.config.min_size
        self.cell_num = self.segmenter.config.cell_num
        return result

    def _segment(self, vol: int, method: str = "min_size") -> SegResult:
        return self._segment_array(self._read_volume(vol), method,
                                   self._cache_path(vol))

    def precompute_segmentation(self, volumes=None,
                                prefetch_depth: int = 2) -> None:
        """Fill the U-Net cache for ``volumes`` (all by default), the next
        volumes read while the card runs (tracker.py:652-669 in bulk)."""
        from ..io.prefetch import VolumePrefetcher
        if volumes is None:
            volumes = range(1, self.volume_num + 1)
        loader = VolumePrefetcher(self._read_volume, volumes,
                                  depth=prefetch_depth)
        for vol, image_raw in loader:
            self.segmenter.predict_cellregions(image_raw,
                                               self._cache_path(vol))
            print(f"cached U-Net prediction t={vol}", end="\r")
        print()

    def _segment_vol1(self, image_raw, method="min_size", cache_path=None):
        self.segresult = self._segment_array(image_raw, method, cache_path)
        self.r_coordinates_segment_t0 = _numpy(
            self.segresult.r_coordinates_segment)

    def segment_vol1(self, method="min_size"):
        """Segment vol 1 and write it to ``auto_vol1/`` for proofreading."""
        self._segment_vol1(self._read_volume(1), method, self._cache_path(1))
        auto = _numpy(self.segresult.segmentation_auto)
        self.use_8_bit = auto.max() <= 255
        save_label_slices(auto, self.paths.auto_segmentation_vol1,
                          "auto_R_t%04i_z%04i.tif", 1, self.use_8_bit)
        print("Segmented volume 1 and saved it")

    # ---- U-Net retraining (tracker.py:923-1044) ---------------------------
    def _remove_2d_boundary(self, labels3d) -> np.ndarray:
        """Zero the x-y boundaries between touching cells, slice by slice
        (tracker.py:944-962), so the retrained net learns them as
        background."""
        lab = torch.as_tensor(_numpy(labels3d))
        b = find_boundaries_outer(lab.permute(2, 0, 1), connectivity=2,
                                  batch_ndim=1).permute(1, 2, 0)
        return torch.where(b, 0, lab).numpy()

    def _unet_trainer(self):
        """The retraining's ``TrainingUNet3D`` on the proofed vol 1, from
        ``weights_initial.npz``."""
        from ..models.train_unet import TrainingUNet3D
        image_raw_vol1 = self._read_volume(1)
        label_vol1 = (self._remove_2d_boundary(
            self.segmentation_manual_relabels) > 0).astype(np.int32)
        trainer = TrainingUNet3D(
            noise_level=self.noise_level,
            folder_path=Path(self.paths.unet_weights) / "retrain",
            model=self.unet_model, device=self.device)
        trainer.start_from(*load_pytree(
            (trainer.params, trainer.bn_state),
            os.path.join(self.paths.unet_weights, "weights_initial.npz")))
        trainer.load_dataset_arrays(image_raw_vol1, label_vol1,
                                    image_raw_vol1, label_vol1)
        trainer.preprocess()
        return trainer

    def retrain_unet(self, iteration: int = 10,
                     weights_name: str = "unet_weights_retrain_",
                     steps_per_epoch: int = 60, verbose: bool = True):
        """Retrain the U-Net on the proofed vol 1 (tracker.py:964-1007):
        patches of vol 1 with the touching cells' x-y boundaries removed,
        ``steps_per_epoch`` steps per epoch (patch starts from
        ``np.random.RandomState(epoch)``), weights saved at every
        validation improvement.  Returns the validation losses, before
        retraining first."""
        trainer = self._unet_trainer()
        self.val_losses = [trainer.validation_loss()]
        if verbose:
            print("val_loss before retraining:", self.val_losses[0])
        for step in range(1, iteration + 1):
            rng_np = np.random.RandomState(step)
            for _ in range(steps_per_epoch):
                trainer.train_step(*trainer._train_batch(rng_np))
            loss = trainer.validation_loss()
            if loss < min(self.val_losses):
                if verbose:
                    print(f"val_loss updated from {min(self.val_losses):.4f}"
                          f" to {loss:.4f}")
                save_pytree((trainer.params, trainer.bn_state),
                            os.path.join(self.paths.unet_weights,
                                         f"{weights_name}step{step}.npz"))
            self.val_losses.append(loss)
        self._retrainer = trainer
        return self.val_losses

    def select_unet_weights(self, step: int,
                            weights_name: str = "unet_weights_retrain_"):
        """Restore the retrained (step >= 1) or initial (step == 0) weights
        (tracker.py:1021-1044)."""
        if step == 0:
            path = os.path.join(self.paths.unet_weights,
                                "weights_initial.npz")
        elif step > 0:
            path = os.path.join(self.paths.unet_weights,
                                f"{weights_name}step{step}.npz")
        else:
            raise ValueError("step should be an integer >= 0")
        self.unet_params, self.unet_bn_state = load_pytree(
            (self.unet_params, self.unet_bn_state), path)
        if step > 0:
            save_pytree((self.unet_params, self.unet_bn_state),
                        os.path.join(self.paths.unet_weights,
                                     "unet3_retrained.npz"))
        self._build_segmenter()

    # ---- manual seg + interpolation (tracker.py:908-921, 1046-1112) -------
    def load_manual_seg(self):
        """Read the proofed vol-1 labels from ``manual_vol1/``."""
        seg = load_image(self.paths.manual_segmentation_vol1)
        self.segmentation_manual_relabels = _relabel_sequential_np(
            seg.astype(np.int32))
        if self.segmentation_manual_relabels.max() > 255:
            self.use_8_bit = False
        print("Loaded manual _segment at vol 1")

    def _interpolate(self):
        """Smooth the proofed labels through the z-interpolated atlas,
        split labels into value-equal components, rebuild the atlas, and
        set the vol-1 tracked labels (on the device) and coordinates."""
        seg = torch.from_numpy(np.asarray(
            self.segmentation_manual_relabels, np.int32)).to(self.device)
        n0 = int(seg.max())
        labels, overlap = move_cells_sampled(self._make_atlas(seg),
                                             **self._paste_kwargs)
        smoothed = recalculate_cell_boundaries(labels, overlap)
        corrected = label_components_values(smoothed, connectivity=3)
        if int(corrected.max()) != n0:
            print(f"WARNING: {n0} cells were manually labeled while the "
                  f"program found {int(corrected.max())} separated cells "
                  "and corrected it")
        self.atlas = self._make_atlas(corrected)
        labels, overlap = move_cells_sampled(self.atlas,
                                             **self._paste_kwargs)
        self.segmentation_manual_relabels = recalculate_cell_boundaries(
            labels, overlap)
        n = self.atlas.n_cells
        com = center_of_mass((self.segmentation_manual_relabels > 0).to(
            torch.float32), self.segmentation_manual_relabels, n)
        self.r_coordinates_tracked_t0 = com.cpu().numpy() * np.array(
            [1.0, 1.0, self.z_xy_ratio])
        self.cell_num_t0 = n

    def interpolate_seg(self):
        """tracker.py:1046-1075: the vol-1 tracked labels from the proofed
        ones, written as ``track_results_t000001_z*.tif``."""
        self._interpolate()
        save_label_slices(_numpy(self.segmentation_manual_relabels),
                          self.paths.track_results,
                          "track_results_t%06i_z%04i.tif", 1,
                          self.use_8_bit)

    def _make_atlas(self, seg: torch.Tensor) -> SubregionAtlas:
        n = int(seg.max())
        return build_subregion_atlas(seg, n_cells=n,
                                     box_shape=_box_shape(seg, n),
                                     interpolation_factor=self.z_scaling,
                                     smooth_sigma=2.5)

    def cal_subregions(self):
        """tracker.py:1095-1112: the atlas already holds the padded
        subregions; kept for the workflow's order."""
        assert self.atlas is not None, "run interpolate_seg first"

    # ---- tracking core ----------------------------------------------------
    def initiate_tracking(self):
        self.cells_on_boundary = np.zeros(self.cell_num_t0, int)
        self.history.r_displacements = [np.zeros((self.cell_num_t0, 3))]
        self.history.r_segmented_coordinates = [
            self.r_coordinates_segment_t0]
        self.history.r_tracked_coordinates = [self.r_coordinates_tracked_t0]
        self.history.anim = []
        print("Initiated coordinates for tracking (from vol 1)")

    def _initial_matching(self, ref_real: np.ndarray, tgt_real: np.ndarray
                          ) -> torch.Tensor:
        """The legacy ``initial_matching_quick`` (track.py:117-178): FFN
        scores (m, n) on unnormalized real coordinates."""
        def feats(pts):
            pts = torch.as_tensor(np.asarray(pts, np.float32),
                                  device=self.device)
            mask = torch.ones((pts.shape[0],), dtype=torch.bool,
                              device=self.device)
            return knn_feature_vectors(pts, mask, K_POINTS)
        return ffn_pair_scores(self.ffn_params, self.ffn_state,
                               feats(ref_real), feats(tgt_real))

    def _fit_ffn_prgls(self, rep: int, r_coordinates_segment_pre):
        """tracker.py:1224-1267: ``rep`` x (FFN + legacy PR-GLS) with beta
        annealed by 0.8; returns the coefficients, betas and moved sets."""
        inter = np.asarray(r_coordinates_segment_pre, np.float32)
        tgt = np.asarray(_numpy(self.segresult.r_coordinates_segment),
                         np.float32)
        C_t, BETA_t, inter_list = [], [], []
        for i in range(rep):
            inter_list.append(inter.copy())
            corr = self._initial_matching(inter, tgt)
            beta_i = self.beta_tk * (0.8 ** i)
            res = pr_gls_quick(torch.as_tensor(inter, device=self.device),
                               torch.as_tensor(tgt, device=self.device),
                               corr, beta=beta_i,
                               max_iteration=self.max_iteration,
                               lambda_=self.lambda_tk)
            C_t.append(res.coefficients.cpu().numpy())
            BETA_t.append(beta_i)
            inter = res.moved_ref.cpu().numpy()
        return C_t, BETA_t, inter_list

    def _predict_one_rep(self, pred, inter, beta, C):
        """tracker.py:1269-1289: the stored motion basis applied to the
        tracked set."""
        gram = gaussian_gram(torch.as_tensor(np.asarray(pred, np.float32)),
                             torch.as_tensor(np.asarray(inter, np.float32)),
                             beta ** 2).numpy()
        return pred + gram @ C.T

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

    def _target(self):
        return self._pad_pts(np.asarray(
            _numpy(self.segresult.r_coordinates_segment), np.float32))

    def _fit_one(self, source_volume: int, frames: bool = False):
        """One fused fit from ``source_volume`` to the current volume:
        (the float64 prediction, and with ``frames`` its per-rep (pre,
        post) pairs replayed on the host, else None)."""
        inter0, m1, tracked0 = self._fused_predict_inputs(source_volume)
        tgt, m2 = self._target()
        pred, inters, cs = legacy_fit_and_predict(
            self.ffn_params, self.ffn_state, inter0, m1, tgt, m2, tracked0,
            self.beta_tk, self.lambda_tk, rep=REP_NUM_PRGLS,
            max_iteration=self.max_iteration)
        pred = pred.cpu().numpy().astype(np.float64)
        if not frames:
            return pred, None
        return pred, self._replay_rep_frames(
            tracked0.cpu().numpy(), m1.cpu().numpy(), inters.cpu().numpy(),
            cs.cpu().numpy())

    def _predict_pos_once(self, source_volume: int, draw: bool = False):
        """The prediction from one source volume (one fused fit in place
        of the reference's per-rep calls, tracker.py:1193-1289) and, with
        ``draw``, the animation of its reps (``viz.ffn_prgls_animation``,
        or None, printing "animation skipped", where it cannot be
        drawn)."""
        pred, frames = self._fit_one(source_volume, draw)
        if not draw:
            return pred, None
        anim = None
        try:
            anim = viz.ffn_prgls_animation(
                frames, _numpy(self.segresult.r_coordinates_segment))
        except Exception as e:
            print(f"animation skipped: {e}")
        return pred, anim

    def _replay_rep_frames(self, tracked0, m1, inters, cs):
        """The per-rep (pre, post) positions of the tracked set, replayed
        on the host from the fit's replay stacks (``inters`` (rep, M, 3),
        ``cs`` (rep, 3, M), ``m1`` the mask of the M rows;
        tracker.py:1205-1215 replays them inline)."""
        frames = []
        p = np.asarray(tracked0, np.float64)
        for i in range(REP_NUM_PRGLS):
            beta_i = self.beta_tk * (0.8 ** i)
            pre = p
            p = self._predict_one_rep(p, inters[i][m1], beta_i,
                                      cs[i][:, m1])
            frames.append((pre, p))
        return frames

    def draw_prediction_grid(self, target_volume: int, method="min_size",
                             segresult=None, path: Optional[str] = None):
        """The reps of the FFN + PR-GLS prediction of ``target_volume`` as
        a grid (``viz.ffn_prgls_grid``): one row per reference volume (one
        in single mode, every member in ensemble mode), one column per
        rep.  ``segresult`` as in :meth:`match`.  Returns the figure."""
        if target_volume in self.miss_frame:
            raise ValueError("target_volume is a miss_frame")
        self.segresult = segresult if segresult is not None else \
            self._segment(target_volume, method)
        source_vols = get_reference_vols(self.ensemble, target_volume,
                                         adjacent=self.adjacent)
        member_frames = [self._fit_one(sv, frames=True)[1]
                         for sv in source_vols]
        return viz.ffn_prgls_grid(
            member_frames, _numpy(self.segresult.r_coordinates_segment),
            member_labels=[f"from vol {sv}" for sv in source_vols],
            path=path)

    def _predict_from(self, source_vols: Sequence[int]) -> np.ndarray:
        """The prediction of the tracked set at the current volume: one
        fused fit from one source, else the trim mean (scipy's, cut 0.1)
        of every source's, fitted in one batched call with the member axis
        padded to the ensemble size by repeating the last."""
        if len(source_vols) == 1:
            return self._fit_one(source_vols[0])[0]
        tgt, m2 = self._target()
        ins = [self._fused_predict_inputs(sv) for sv in source_vols]
        n_real = len(ins)
        ins = ins + [ins[-1]] * (max(int(self.ensemble), n_real) - n_real)
        preds = legacy_fit_members(
            self.ffn_params, self.ffn_state,
            torch.stack([a for a, _, _ in ins]),
            torch.stack([m for _, m, _ in ins]), tgt, m2,
            torch.stack([t for _, _, t in ins]), self.beta_tk,
            self.lambda_tk, rep=REP_NUM_PRGLS,
            max_iteration=self.max_iteration)
        preds = preds.cpu().numpy().astype(np.float64)[:n_real]
        k = int(0.1 * n_real)
        return np.sort(preds, axis=0)[k:n_real - k].mean(axis=0)

    def _get_cells_onBoundary(self, r_coords: np.ndarray, ensemble):
        """tracker.py:1291-1308: a 6-voxel xy margin in single mode, none
        in ensemble mode."""
        b = 0 if ensemble else BOUNDARY_XY
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

    def _correct(self, r_coor_predicted: np.ndarray, include: np.ndarray,
                 render: bool = True):
        """The seed, then one correction/render on the device, the weight
        map as float16 as the JAX twin ships it (accumulated in f32)."""
        _, i_disp0 = self._seed_displacements(r_coor_predicted)
        s = self.segresult
        weights = float64_to_float16(
            (s.image_cell_bg + s.image_gcn).double())
        return legacy_correction_and_render(
            self.atlas, weights, torch.from_numpy(i_disp0).to(self.device),
            torch.from_numpy(include).to(self.device),
            torch.from_numpy(np.asarray(self.r_coordinates_tracked_t0,
                                        np.float32)).to(self.device),
            self.z_xy_ratio, self.z_scaling,
            max_repetition=REP_NUM_CORRECTION, render=render,
            **self._paste_kwargs)

    # ---- public tracking API ----------------------------------------------
    def match(self, target_volume: int, method="min_size", segresult=None):
        """tracker.py:1138-1175: vol 1's cells moved onto
        ``target_volume``.  Returns (the animation of the fit's reps, or
        None where it cannot be drawn, [boundary flags, target_volume,
        i_disp, predicted coordinates]).  ``segresult`` injects a
        segmentation made elsewhere."""
        if target_volume in self.miss_frame:
            raise ValueError("target_volume is a miss_frame")
        self.segresult = segresult if segresult is not None else \
            self._segment(target_volume, method)
        r_coor_predicted, anim = self._predict_pos_once(source_volume=1,
                                                        draw=True)
        cells_bd = self._get_cells_onBoundary(r_coor_predicted,
                                              self.ensemble)
        local = self.cells_on_boundary.copy()
        local[cells_bd] = 1
        _, i_disp, _ = self._correct(r_coor_predicted, local == 0,
                                     render=False)
        print(f"Matching between vol 1 and vol {target_volume} was "
              "computed")
        return anim, [local, target_volume, i_disp.cpu().numpy(),
                      r_coor_predicted]

    def _reset_tracking_state(self, from_volume):
        assert from_volume >= 2, "from_volume should >= 2"
        current = len(self.history.r_displacements)
        del self.history.r_displacements[from_volume - 1:]
        del self.history.r_segmented_coordinates[from_volume - 1:]
        del self.history.r_tracked_coordinates[from_volume - 1:]
        assert len(self.history.r_displacements) == from_volume - 1, \
            f"Tracked until vol {current}, cannot start from {from_volume}"

    def track(self, from_volume=2, fig=None, ax=None):
        """Track every volume from ``from_volume`` on (``fig`` and ``ax``,
        the reference's live figure, are accepted and unused)."""
        self._reset_tracking_state(from_volume)
        for vol in range(from_volume, self.volume_num + 1):
            self.track_one_vol(vol)

    def _track_volume(self, target_volume: int, segresult: SegResult):
        """tracker.py:1473-1536 on a given segmentation, writing nothing:
        the prediction from the reference volumes, boundary flags, the
        correction and render (labels on the device in
        ``tracked_labels``), the history."""
        self.segresult = segresult
        r_coor_mean = self._predict_from(get_reference_vols(
            self.ensemble, target_volume, adjacent=self.adjacent))
        cells_bd = self._get_cells_onBoundary(r_coor_mean, self.ensemble)
        self.cells_on_boundary[cells_bd] = 1
        r_disp, _, labels = self._correct(r_coor_mean,
                                          self.cells_on_boundary == 0)
        r_disp = r_disp.cpu().numpy().astype(np.float64)
        self.tracked_labels = labels
        if self.ensemble:
            # ensemble mode: boundary flags reset (tracker.py:1529-1531)
            self.cells_on_boundary = np.zeros(self.cell_num_t0, int)
        self.history.r_displacements.append(r_disp)
        self.history.r_segmented_coordinates.append(
            _numpy(segresult.r_coordinates_segment))
        self.history.r_tracked_coordinates.append(
            self.r_coordinates_tracked_t0 + r_disp)
        return r_coor_mean

    def _save_tracked(self, target_volume: int):
        save_label_slices(_numpy(self.tracked_labels),
                          self.paths.track_results,
                          "track_results_t%06i_z%04i.tif", target_volume,
                          self.use_8_bit)

    def track_one_vol(self, target_volume: int, fig=None, axc6=None,
                      method="min_size", segresult=None):
        """tracker.py:1473-1536: segment ``target_volume`` (or take
        ``segresult``), track it and write its labels.  A miss frame
        repeats the last labels and displacement.  ``fig`` and ``axc6``
        (the reference's live figure) are accepted and unused; with
        ``save_figures`` set, the volume's 6-panel figure
        (``viz.draw_matching_6panel``) goes to
        ``anim/track_anim_t%06i.png`` instead, printing "6-panel figure
        skipped" where it cannot be drawn."""
        if target_volume in self.miss_frame:
            self._save_tracked(target_volume)
            self.history.r_displacements.append(
                self.history.r_displacements[-1])
            self.history.r_segmented_coordinates.append(
                _numpy(self.segresult.r_coordinates_segment))
            self.history.r_tracked_coordinates.append(
                self.r_coordinates_tracked_t0 +
                self.history.r_displacements[-1])
            return
        seg = segresult if segresult is not None else \
            self._segment(target_volume, method)
        prev_tracked = self.history.r_tracked_coordinates[-1]
        r_coor_mean = self._track_volume(target_volume, seg)
        self._save_tracked(target_volume)
        if self.save_figures:
            try:
                viz.draw_matching_6panel(
                    self._read_volume(target_volume),
                    _numpy(self.tracked_labels), r_coor_mean,
                    _numpy(seg.r_coordinates_segment), prev_tracked,
                    z_xy_ratio=self.z_xy_ratio,
                    path=os.path.join(self.paths.anim,
                                      "track_anim_t%06i.png"
                                      % target_volume))
            except Exception as e:
                print(f"6-panel figure skipped: {e}")

    def save_coordinates(self):
        """tracker.py:1538-1551: ``track_information/
        tracked_coordinates.csv``, one row per (t, cell)."""
        coord = np.asarray(self.history.r_tracked_coordinates)
        t, cell, pos = coord.shape
        table = np.column_stack((
            np.repeat(np.arange(1, t + 1), cell),
            np.tile(np.arange(1, cell + 1), t),
            coord.reshape(t * cell, pos)))
        out = os.path.join(self.paths.track_information,
                           "tracked_coordinates.csv")
        np.savetxt(out, table, delimiter=",",
                   header="cell,t,x(row),y(column),z(interpolated)",
                   comments="")
        print(f"Cell coordinates were stored in {out}")

    # ---- inspection figures (tracker.py:212-441) ---------------------------
    def _transform_motion_to_image(self, cells_on_boundary_local, i_disp):
        """Vol 1's cells moved by ``i_disp`` (interpolated voxels), but
        the flagged ones: the rendered labels on the device."""
        include = torch.from_numpy(np.asarray(cells_on_boundary_local)
                                   == 0).to(self.device)
        return render_moved_labels(
            self.atlas, torch.as_tensor(np.asarray(i_disp),
                                        dtype=torch.int32,
                                        device=self.device),
            include, **self._paste_kwargs)

    def draw_correction(self, i_disp_from_vol1_updated, r_coor_predicted):
        """The accurate correction's arrows over the cell regions
        (``viz.draw_correction``, tracker.py:281-314)."""
        to_layer = np.array([1.0, 1.0, 1.0 / self.z_xy_ratio])
        corrected = (self.r_coordinates_tracked_t0 * to_layer
                     + np.asarray(i_disp_from_vol1_updated)
                     * np.array([1.0, 1.0, 1.0 / self.z_scaling]))
        return viz.draw_correction(
            _numpy(self.segresult.image_cell_bg),
            np.asarray(r_coor_predicted) * to_layer,
            _numpy(self.segresult.r_coordinates_segment) * to_layer,
            corrected, z_xy_ratio=self.z_xy_ratio)

    def draw_overlapping(self, cells_on_boundary_local, volume2,
                         i_disp_from_vol1_updated):
        """Move the cells by the given displacements into
        ``tracked_labels`` and draw the labels before and after matching
        over the current volume's cell regions (``viz.draw_overlapping``,
        tracker.py:316-390)."""
        self.tracked_labels = self._transform_motion_to_image(
            cells_on_boundary_local, i_disp_from_vol1_updated)
        return viz.draw_overlapping(
            _numpy(self.segresult.image_cell_bg) > 0.5,
            _numpy(self.segmentation_manual_relabels),
            _numpy(self.tracked_labels), z_xy_ratio=self.z_xy_ratio,
            volume2=volume2)

    def draw_segresult(self, percentile_high=99.9):
        """The raw image, the U-Net's cell regions and the automatic
        segmentation as a per-z animation, leaving their max projections
        on the figure (tracker.py:212-252)."""
        plt = viz.pyplot()
        from matplotlib import animation
        s = self.segresult
        fig, axs = plt.subplots(1, 3, figsize=(21, 7))
        axs[0].set_title("Raw image (gcn)")
        axs[1].set_title("Cell regions by U-Net")
        axs[2].set_title("Auto-segmentation")
        gcn = _numpy(s.image_gcn)
        regions = _numpy(s.image_cell_bg) > 0.5
        auto = _numpy(s.segmentation_auto).astype(np.int64)
        vmax = np.percentile(gcn, percentile_high)
        vmin = np.percentile(gcn, 10)
        cmap = viz.lbl_cmap
        ncol = len(cmap.colors)
        frames = []
        for z in range(self.z_siz):
            o1 = axs[0].imshow(gcn[:, :, z], vmin=vmin, vmax=vmax,
                               cmap="gray", animated=True)
            o2 = axs[1].imshow(regions[:, :, z], cmap="gray", animated=True)
            o3 = axs[2].imshow(auto[:, :, z] % ncol, cmap=cmap,
                               interpolation="none", animated=True)
            frames.append([o1, o2, o3])
        anim = animation.ArtistAnimation(fig, frames, interval=200)
        axs[0].imshow(np.max(gcn, axis=2), vmin=vmin, vmax=vmax,
                      cmap="gray")
        axs[1].imshow(np.max(regions, axis=2), cmap="gray")
        axs[2].imshow(np.max(auto, axis=2) % ncol, cmap=cmap,
                      interpolation="none")
        print("Segmentation results (max projection):")
        return anim

    def draw_manual_seg1(self):
        """The U-Net's cell regions beside the interpolated proofed labels,
        max projections (tracker.py:254-262).  Run after
        :meth:`interpolate_seg`."""
        plt = viz.pyplot()
        cmap = viz.lbl_cmap
        fig, ax = plt.subplots(1, 2, figsize=(14, 7))
        ax[0].imshow(np.max(_numpy(self.segresult.image_cell_bg), axis=2)
                     > 0.5, cmap="gray")
        ax[0].set_title("Cell regions by U-Net")
        ax[1].imshow(np.max(_numpy(self.segmentation_manual_relabels)
                            .astype(np.int64), axis=2) % len(cmap.colors),
                     cmap=cmap, interpolation="none")
        ax[1].set_title("Interpolated manual segmentation at vol 1")
        return fig

    def subplots_tracking(self):
        """The (3, 2) layout of the tracking figure (tracker.py:430-441):
        (fig, its six axes)."""
        plt = viz.pyplot()
        fig, axs = plt.subplots(
            3, 2, figsize=(14, max(int(21 * self.x_siz / self.y_siz), 7)))
        ax = (axs[0, 0], axs[0, 1], axs[1, 0], axs[1, 1],
              axs[2, 0], axs[2, 1])
        return fig, ax

    def replay_track_animation(self, from_volume: int = 2):
        """The saved ``anim/`` figures as an animation
        (``viz.replay_track_animation``, tracker.py:1433-1460); track with
        ``save_figures`` set first."""
        return viz.replay_track_animation(
            self.paths.anim, range(from_volume, self.volume_num + 1))


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
        max_cells: int = 512, device=None, timer=None,
        compute_dtype=torch.bfloat16) -> LegacyResult:
    """The legacy single-mode workflow on arrays (``examples/
    use_unet_legacy.py``: segment_vol1 -> load_manual_seg ->
    interpolate_seg -> initiate_tracking -> track), for raw (x, y, z)
    volumes in t order, on a :class:`Tracker` with no folder: nothing is
    read or written.  ``unet``: (UNet3D spec, params, state);
    ``ffn_weights``: (params, state).  ``config`` carries the segmentation
    knobs (noise_level, min_size, z_xy_ratio, z_scaling, shrink),
    ``tracking`` beta, lambda and the PR-GLS iterations.  ``timer``:
    optional object whose ``stage(name)`` is a context manager around each
    volume's "seg" (U-Net + watersheds) and "track" (fit, correction,
    render and the label download) calls.  ``compute_dtype``: the U-Net's,
    bfloat16 as the ``Tracker`` builds it by default."""
    if tracking.ensemble:
        raise ValueError("legacy_segment_and_track_arrays supports single "
                         "mode only")
    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext())
    model, params, state = unet
    tracker = Tracker._on_arrays(len(volumes_xyz),
                                 tuple(volumes_xyz[0].shape), config,
                                 tracking, max_cells, device)
    tracker._set_unet(model, params, state)
    tracker.segmenter = tracker._new_segmenter(compute_dtype)
    tracker.load_ffn_arrays(*ffn_weights)
    with stage("seg"):
        tracker._segment_vol1(volumes_xyz[0])
    cells = {1: int(tracker.segresult.r_coordinates_segment.shape[0])}
    auto_vol1 = tracker.segresult.segmentation_auto.cpu().numpy()
    tracker.segmentation_manual_relabels = _relabel_sequential_np(
        np.asarray(manual_vol1_xyz).astype(np.int32))
    tracker._interpolate()
    tracker.initiate_tracking()
    labels = {1: tracker.segmentation_manual_relabels.cpu().numpy().astype(
        np.uint16)}
    for t in range(2, len(volumes_xyz) + 1):
        with stage("seg"):
            seg = tracker._segment_array(volumes_xyz[t - 1])
        cells[t] = int(seg.r_coordinates_segment.shape[0])
        with stage("track"):
            tracker._track_volume(t, seg)
            labels[t] = tracker.tracked_labels.cpu().numpy().astype(
                np.uint16)
    coords = {t: c for t, c in enumerate(
        tracker.history.r_tracked_coordinates, start=1)}
    return LegacyResult(coords, labels, cells, auto_vol1)
