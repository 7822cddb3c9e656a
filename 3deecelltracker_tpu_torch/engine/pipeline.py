"""The v1.0 segment-and-track main path on arrays (counterpart of
``3deecelltracker_tpu/engine/pipeline.py``: ``seg_candidates_to_padded_real``,
the track-from-seg body (:40-86, :165-204), and the per-volume loop of
``_segment_and_track_device`` (:515-552), single device).

Per volume: one seg call (``StarDist3D.predict_instances_device``), then one
track call fed straight from the seg outputs, which stay on the device.
The vol-1 proofed labels build the subregion atlas and the vol-1 centres
once per recording.  Arrays in, arrays out: the TIFF results tree that
the JAX package's ``segment_and_track`` writes is not written here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TrackingConfig
from ..coordinates import Coordinates
from ..ops.subregions import SubregionAtlas
from ..ops.watershed import recalculate_cell_boundaries
from ..utils.device import select_device
from .correction import accurate_correction_loop, get_cells_on_boundary
from .stardist import StarDist3D
from .tracker import track_step
from .transformer import (BOUNDARY_XY, CoordsToImageTransformer,
                          upsample_prob_pipeline)


def seg_candidates_to_padded_real(points_zyx: torch.Tensor,
                                  kept: torch.Tensor, pad_n: int,
                                  voxel_size) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Seg candidates -> the tracker's padded point set, on the device:
    kept rows first (stable, so prob-descending), zyx -> pipeline (x, y, z)
    as (y, x, z), scaled to real units, padded to ``pad_n`` with the 1e6
    parking value and a bool mask.  Kept counts above ``pad_n`` are
    truncated."""
    dev = points_zyx.device
    k = int(points_zyx.shape[0])
    order = torch.argsort((~kept).to(torch.int8), stable=True)
    pts = points_zyx[order]
    pipe = torch.stack([pts[:, 1], pts[:, 2], pts[:, 0]],
                       dim=1).to(torch.float32)
    kept_sorted = kept[order]
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    m = min(k, int(pad_n))
    real = torch.full((int(pad_n), 3), 1e6, dtype=torch.float32, device=dev)
    mask = torch.zeros((int(pad_n),), dtype=torch.bool, device=dev)
    real[:m] = torch.where(kept_sorted[:m, None], pipe[:m] * vs, 1e6)
    mask[:m] = kept_sorted[:m]
    return real, mask


class TrackOutput(NamedTuple):
    corrected_raw: torch.Tensor     # (n, 3) f32, pipeline frame
    labels: torch.Tensor            # (x, y, z) int32
    prgls_iterations: torch.Tensor  # 0-d int32
    correction_iterations: torch.Tensor


def track_from_seg(ffn_params, ffn_state, confirmed_raw: torch.Tensor,
                   coord_vol1_raw: torch.Tensor,
                   pts1_zyx: torch.Tensor, kept1: torch.Tensor,
                   pts2_zyx: torch.Tensor, kept2: torch.Tensor,
                   prob_zyx_grid: torch.Tensor, atlas: SubregionAtlas,
                   voxel_size, image_shape, beta: float, lambda_: float,
                   max_repetition: int = 20, k_points: int = 20,
                   max_iteration: int = 2000,
                   prob_grid: Tuple[int, int, int] = (1, 1, 1),
                   pad_n: int = 192) -> TrackOutput:
    """One volume of the tracking recurrence fed directly from the seg
    outputs of t1 and t2 (``fused_track_from_seg`` with the single-mode
    ``_track_correct_body``): candidate compress/pad and the grid prob
    map's (z, y, x) -> (x, y, z) transpose and upsample on the device,
    then FFN matching + PR-GLS, boundary flags, accurate correction and
    boundary recalculation."""
    seg1_real, m1 = seg_candidates_to_padded_real(pts1_zyx, kept1, pad_n,
                                                  voxel_size)
    seg2_real, m2 = seg_candidates_to_padded_real(pts2_zyx, kept2, pad_n,
                                                  voxel_size)
    prob_img = prob_zyx_grid.permute(1, 2, 0)
    if tuple(prob_grid) != (1, 1, 1):
        prob_img = upsample_prob_pipeline(prob_img, prob_grid, image_shape)
    prob_img = prob_img.to(torch.float32)
    vs = torch.tensor(voxel_size, dtype=torch.float32,
                      device=confirmed_raw.device)
    res = track_step(ffn_params, ffn_state, confirmed_raw * vs,
                     seg1_real, m1, seg2_real, m2, beta=beta,
                     lambda_=lambda_, k_points=k_points,
                     max_iteration=max_iteration)
    boundary = get_cells_on_boundary(res.tracked, image_shape, voxel_size,
                                     ensemble=False,
                                     boundary_xy=BOUNDARY_XY)
    corrected_raw, labels, overlap, n_corr = accurate_correction_loop(
        atlas, coord_vol1_raw, res.tracked / vs, prob_img, boundary,
        max_repetition=max_repetition)
    corrected_labels = recalculate_cell_boundaries(
        labels, overlap, sampling_xy=tuple(voxel_size[:2]))
    return TrackOutput(corrected_raw, corrected_labels, res.n_iterations,
                       n_corr)


@dataclasses.dataclass
class SliceResult:
    """``coords[t]``: (n, 3) real coordinates; ``labels[t]``: uint16 (x, y, z)
    tracked label volume; ``stats[t]``: kept count and loop iterations;
    ``auto_vol1``: the seg program's rendered vol-1 labels (z, y, x)."""
    coords: Dict[int, np.ndarray]
    labels: Dict[int, np.ndarray]
    stats: Dict[int, dict]
    auto_vol1: Optional[np.ndarray] = None


def _upload_raw(vol: np.ndarray, device: torch.device) -> torch.Tensor:
    """Raw volume to the device in its own width; uint16 travels as int16
    bits and widens there (uint16 tensors have few kernels)."""
    if vol.dtype == np.uint16:
        bits = torch.from_numpy(np.ascontiguousarray(vol).view(np.int16)
                                ).to(device)
        return bits.to(torch.int32) & 0xFFFF
    return torch.from_numpy(np.ascontiguousarray(vol)).to(device)


def segment_and_track_arrays(volumes: Sequence[np.ndarray],
                             model: StarDist3D,
                             manual_vol1_xyz: np.ndarray,
                             ffn_weights,
                             voxel_size: Tuple[float, float, float],
                             interpolation_factor: int,
                             config: TrackingConfig = TrackingConfig(),
                             device=None,
                             timer=None) -> SliceResult:
    """Segment and track a recording given as raw (z, y, x) volumes in t
    order (t = 1, 2, ...) with the proofed vol-1 labels in the (x, y, z)
    frame.  ``ffn_weights``: (params, state) dicts of tensors
    (``utils.convert.ffn_from_numpy`` or ``models.ffn.init_ffn``).
    ``timer``: optional object whose ``stage(name)`` is a context manager
    around each volume's "seg" and "track" calls."""
    if config.ensemble:
        raise ValueError("segment_and_track_arrays supports single mode "
                         "only")
    dev = select_device(device)
    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext())
    transformer = CoordsToImageTransformer(voxel_size, dev)
    transformer.load_segmentation_array(manual_vol1_xyz)
    transformer.interpolate(interpolation_factor)
    coord_vol1 = transformer.coord_vol1
    vs_t = tuple(transformer.voxel_size)
    image_shape = transformer.proofed_segmentation.shape
    grid_t = tuple(int(g) for g in model.config.grid)
    pad_n = int(np.ceil(coord_vol1.cell_num * 1.5 / 64) * 64)
    params, state = (_to_device(w, dev) for w in ffn_weights)

    coords_t1 = coord_vol1
    coords: Dict[int, np.ndarray] = {}
    labels: Dict[int, np.ndarray] = {
        1: transformer.auto_corrected_segmentation.astype(np.uint16)}
    stats: Dict[int, dict] = {}
    prev_pts = prev_kept = auto_vol1 = None
    for t, vol in enumerate(volumes, start=1):
        vol = np.asarray(vol)
        mi, ma = np.percentile(vol, (1.0, 99.8))
        with stage("seg"):
            kept, _, _, points, prob_map, seg_labels = \
                model.predict_instances_device(
                    _upload_raw(vol, dev),
                    norm_minmax=(np.float32(mi), np.float32(ma)),
                    return_labels=(t == 1))
        stats[t] = {"kept": int(kept.sum())}
        if seg_labels is not None:
            auto_vol1 = seg_labels.cpu().numpy().astype(np.uint16)
        if t > 1:
            with stage("track"):
                out = track_from_seg(
                    params, state, coords_t1.raw_f32, coord_vol1.raw_f32,
                    prev_pts, prev_kept, points, kept, prob_map,
                    transformer.atlas, vs_t, image_shape,
                    beta=config.beta, lambda_=config.lambda_,
                    max_repetition=config.max_correction_reps,
                    k_points=config.k_neighbors,
                    max_iteration=config.max_iteration,
                    prob_grid=grid_t, pad_n=pad_n)
                coords_t1 = Coordinates(out.corrected_raw,
                                        interpolation_factor, vs_t)
                labels[t] = out.labels.cpu().numpy().astype(np.uint16)
            stats[t].update(prgls_iterations=int(out.prgls_iterations),
                            correction_iterations=int(
                                out.correction_iterations))
            coords[t] = coords_t1.real.cpu().numpy()
        prev_pts, prev_kept = points, kept
    coords[1] = coord_vol1.real.cpu().numpy()
    return SliceResult(dict(sorted(coords.items())), labels, stats,
                       auto_vol1)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return torch.as_tensor(tree, dtype=torch.float32).to(dev)

