"""The v1.0 workflow's drivers (counterpart of
``3deecelltracker_tpu/engine/pipeline.py``):
``seg_candidates_to_padded_real``, the per-volume track-and-correct step
fed from the ``seg/`` artifacts (``track_and_correct``, and under JAX's
name and return values ``fused_track_and_correct`` :40-125) or straight
from the seg outputs (``track_from_seg``, ``fused_track_from_seg``
:165-204),
``segment_and_track`` with ``handoff="disk"`` (:207-356) or ``"device"``
(``_segment_and_track_device`` :359-583), the artifact savers (:600-835)
and ``track_timelapse`` (:847-1074), single and ensemble mode.

The reference's workflow: ``engine.stardist.predict_and_save`` segments
the recording into ``seg/``, the user proofreads ``auto_vol1`` into
``manual_vol1``, and ``track_timelapse`` tracks the recording from
``seg/``.  ``segment_and_track`` runs both at once: with
``handoff="disk"`` the segmenter writes ``seg/`` on its own thread and
stream while tracking follows it volume by volume; with
``handoff="device"`` tracking takes each volume's seg outputs on the
device.  Over a mesh (``mesh=``) the segmentation and the ensemble's
members split over the ranks and rank 0 tracks.  Vol-1's proofed labels
build the subregion atlas and the vol-1 centres once per recording.
``segment_and_track_arrays`` takes arrays in and gives arrays out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import queue
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import TrackingConfig
from ..coordinates import Coordinates
from ..io.imageio import (PathPattern, check_recording, check_transport,
                          fast_percentiles, load_2d_slices_at_time,
                          transport_encode)
from ..io.prefetch import VolumePrefetcher, ready_event, to_host, upload_async
from ..ops.subregions import SubregionAtlas
from ..ops.trim import trim_mean
from ..parallel.ensemble import ensemble_member_predictions, lead_members
from ..utils.device import (same_device, select_device, to_device,
                            upload_raw)
from ..viz import pyplot, save_matching_figure
from .correction import correct_prediction
from .stardist import (MeshSegStream, SegArtifactSaver, StarDist3D,
                       predict_and_save)
from .tracker import TrackerLite, get_volumes_list, track_step
from .transformer import (BOUNDARY_XY, CoordsToImageTransformer,
                          upsample_prob_pipeline)


def seg_candidates_to_padded_real(points_zyx: torch.Tensor,
                                  kept: torch.Tensor, pad_n: int,
                                  voxel_size) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Seg candidates -> the tracker's padded point set, on the device:
    kept rows first (stable, so prob-descending), zyx -> pipeline (x, y, z)
    as (y, x, z), scaled to real units, padded to ``pad_n`` with the 1e6
    parking value and a bool mask.  The shapes are static, as in the JAX
    twin: rows past ``pad_n`` are dropped here, so the caller checks the
    kept count against ``pad_n`` first (``segment_and_track_arrays``
    raises above it)."""
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


def track_and_correct(ffn_params, ffn_state, confirmed_raw: torch.Tensor,
                      coord_vol1_raw: torch.Tensor,
                      seg_t1_real: torch.Tensor, seg_t1_mask: torch.Tensor,
                      seg_t2_real: torch.Tensor, seg_t2_mask: torch.Tensor,
                      prob_img: torch.Tensor, atlas: SubregionAtlas,
                      voxel_size, image_shape, beta: float, lambda_: float,
                      max_repetition: int = 20, k_points: int = 20,
                      max_iteration: int = 2000,
                      prob_grid: Tuple[int, int, int] = (1, 1, 1),
                      m_step_refine: int = 0, *,
                      ensemble: bool = False) -> TrackOutput:
    """One volume of the single-mode tracking recurrence
    (``fused_track_and_correct``): FFN matching + PR-GLS from the padded
    seg point sets of t1 and t2 (real units, ``TrackerLite._pad_np``),
    then boundary flags, accurate correction and boundary recalculation.
    ``prob_img``: t2's probability map in the (x, y, z) frame, any float
    dtype; with ``prob_grid`` != (1, 1, 1) it is the grid-resolution map
    of ``seg/prob*.npy``, upsampled and cropped on the device.
    ``m_step_refine``: the EM's compensated M-step (``ops.prgls``).
    ``ensemble``: flag no boundary cell at x/y (the ensemble's rule)."""
    if tuple(prob_grid) != (1, 1, 1):
        prob_img = upsample_prob_pipeline(prob_img, prob_grid, image_shape)
    # prob maps travel as float16; the correction weighs in f32
    prob_img = prob_img.to(torch.float32)
    vs = torch.tensor(voxel_size, dtype=torch.float32,
                      device=confirmed_raw.device)
    res = track_step(ffn_params, ffn_state, confirmed_raw * vs, seg_t1_real,
                     seg_t1_mask, seg_t2_real, seg_t2_mask, beta=beta,
                     lambda_=lambda_, k_points=k_points,
                     max_iteration=max_iteration, m_step_refine=m_step_refine)
    corrected_raw, labels, n_corr = correct_prediction(
        atlas, coord_vol1_raw, res.tracked / vs, res.tracked, prob_img,
        image_shape, voxel_size, ensemble=ensemble,
        max_repetition=max_repetition, boundary_xy=BOUNDARY_XY)
    return TrackOutput(corrected_raw, labels, res.n_iterations, n_corr)


def track_from_seg(ffn_params, ffn_state, confirmed_raw: torch.Tensor,
                   coord_vol1_raw: torch.Tensor,
                   pts1_zyx: torch.Tensor, kept1: torch.Tensor,
                   pts2_zyx: torch.Tensor, kept2: torch.Tensor,
                   prob_zyx_grid: torch.Tensor, atlas: SubregionAtlas,
                   voxel_size, image_shape, beta: float, lambda_: float,
                   max_repetition: int = 20, k_points: int = 20,
                   max_iteration: int = 2000,
                   prob_grid: Tuple[int, int, int] = (1, 1, 1),
                   m_step_refine: int = 0, pad_n: int = 192, *,
                   ensemble: bool = False) -> TrackOutput:
    """:func:`track_and_correct` fed directly from the seg outputs of t1
    and t2 (``fused_track_from_seg``): the candidates compressed and
    padded, and the grid prob map transposed (z, y, x) -> (x, y, z), on
    the device, as the ``seg/`` artifacts would hold them."""
    seg1_real, m1 = seg_candidates_to_padded_real(pts1_zyx, kept1, pad_n,
                                                  voxel_size)
    seg2_real, m2 = seg_candidates_to_padded_real(pts2_zyx, kept2, pad_n,
                                                  voxel_size)
    return track_and_correct(
        ffn_params, ffn_state, confirmed_raw, coord_vol1_raw, seg1_real, m1,
        seg2_real, m2, prob_zyx_grid.permute(1, 2, 0), atlas, voxel_size,
        image_shape, beta, lambda_, max_repetition=max_repetition,
        k_points=k_points, max_iteration=max_iteration, prob_grid=prob_grid,
        m_step_refine=m_step_refine, ensemble=ensemble)


def _labels_out(labels: torch.Tensor, labels_u8: bool) -> torch.Tensor:
    """JAX's label dtypes: uint16, or uint8 when ``labels_u8`` (valid for
    at most 255 cells)."""
    return labels.to(torch.uint8 if labels_u8 else torch.uint16)


def fused_track_and_correct(ffn_params, ffn_state,
                            confirmed_raw: torch.Tensor,
                            coord_vol1_raw: torch.Tensor,
                            seg_t1_real: torch.Tensor,
                            seg_t1_mask: torch.Tensor,
                            seg_t2_real: torch.Tensor,
                            seg_t2_mask: torch.Tensor,
                            prob_img: torch.Tensor, atlas,
                            voxel_size, image_shape,
                            beta: float, lambda_: float,
                            ensemble: bool = False,
                            max_repetition: int = 20,
                            k_points: int = 20,
                            max_iteration: int = 2000,
                            prob_grid: Tuple[int, int, int] = (1, 1, 1),
                            labels_u8: bool = False,
                            m_step_refine: int = 0):
    """JAX's ``fused_track_and_correct`` (:93) on the port:
    :func:`track_and_correct` returning JAX's ``(corrected_raw (n, 3)
    f32, labels (x, y, z) uint16, or uint8 with labels_u8)``."""
    out = track_and_correct(
        ffn_params, ffn_state, confirmed_raw, coord_vol1_raw, seg_t1_real,
        seg_t1_mask, seg_t2_real, seg_t2_mask, prob_img, atlas, voxel_size,
        image_shape, beta, lambda_, max_repetition=max_repetition,
        k_points=k_points, max_iteration=max_iteration, prob_grid=prob_grid,
        m_step_refine=m_step_refine, ensemble=ensemble)
    return out.corrected_raw, _labels_out(out.labels, labels_u8)


def fused_track_from_seg(ffn_params, ffn_state,
                         confirmed_raw: torch.Tensor,
                         coord_vol1_raw: torch.Tensor,
                         pts1_zyx: torch.Tensor, kept1: torch.Tensor,
                         pts2_zyx: torch.Tensor, kept2: torch.Tensor,
                         prob_zyx_grid: torch.Tensor, atlas,
                         voxel_size, image_shape,
                         beta: float, lambda_: float,
                         ensemble: bool = False,
                         max_repetition: int = 20,
                         k_points: int = 20,
                         max_iteration: int = 2000,
                         prob_grid: Tuple[int, int, int] = (1, 1, 1),
                         labels_u8: bool = False,
                         m_step_refine: int = 0,
                         pad_n: int = 192):
    """JAX's ``fused_track_from_seg`` (:165) on the port:
    :func:`track_from_seg` returning JAX's ``(corrected_raw, labels)``
    as :func:`fused_track_and_correct` does."""
    out = track_from_seg(
        ffn_params, ffn_state, confirmed_raw, coord_vol1_raw, pts1_zyx,
        kept1, pts2_zyx, kept2, prob_zyx_grid, atlas, voxel_size,
        image_shape, beta, lambda_, max_repetition=max_repetition,
        k_points=k_points, max_iteration=max_iteration, prob_grid=prob_grid,
        m_step_refine=m_step_refine, pad_n=pad_n, ensemble=ensemble)
    return out.corrected_raw, _labels_out(out.labels, labels_u8)


@dataclasses.dataclass
class SliceResult:
    """``coords[t]``: (n, 3) real coordinates; ``labels[t]``: uint16 (x, y, z)
    tracked label volume; ``stats[t]``: kept count and loop iterations;
    ``auto_vol1``: the seg program's rendered vol-1 labels (z, y, x)."""
    coords: Dict[int, np.ndarray]
    labels: Dict[int, np.ndarray]
    stats: Dict[int, dict]
    auto_vol1: Optional[np.ndarray] = None


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
    transformer = CoordsToImageTransformer(None, voxel_size, device=dev)
    transformer.load_segmentation_array(manual_vol1_xyz)
    transformer.interpolate(interpolation_factor)
    coord_vol1 = transformer.coord_vol1
    vs_t = tuple(transformer.voxel_size)
    image_shape = transformer.proofed_segmentation.shape
    grid_t = tuple(int(g) for g in model.config.grid)
    pad_n = int(np.ceil(coord_vol1.cell_num * 1.5 / 64) * 64)
    params, state = (to_device(w, dev) for w in ffn_weights)

    coords_t1 = coord_vol1
    coords: Dict[int, np.ndarray] = {}
    labels: Dict[int, np.ndarray] = {
        1: transformer.auto_corrected_segmentation.astype(np.uint16)}
    stats: Dict[int, dict] = {}
    prev_pts = prev_kept = auto_vol1 = None
    for t, vol in enumerate(volumes, start=1):
        vol = np.asarray(vol)
        mi, ma = fast_percentiles(vol, (1.0, 99.8))
        with stage("seg"):
            kept, _, _, points, prob_map, seg_labels = \
                model.predict_instances_device(
                    upload_raw(vol, dev),
                    norm_minmax=(np.float32(mi), np.float32(ma)),
                    return_labels=(t == 1))
        stats[t] = {"kept": int(kept.sum())}
        if stats[t]["kept"] > pad_n:
            # the tracker's padded point set holds pad_n rows
            raise ValueError(f"{stats[t]['kept']} cells exceeds "
                             f"max_cells={pad_n}")
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
                    prob_grid=grid_t, m_step_refine=config.m_step_refine,
                    pad_n=pad_n)
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




class _AsyncTrackSaver:
    """Writes each tracked volume's ``coords_real``, label TIFFs and
    merged-label PNGs on ``N_WRITERS`` threads (the codec encodes with the
    GIL released).  A volume's labels stay on the device until a writer
    fetches them.  With a ``seg_gate`` (the device handoff, whose seg
    artifacts are written beside tracking), a writer waits until the same
    volume's seg artifacts are written and writes nothing for a volume
    whose seg artifacts failed: no tracked artifacts from a truncated
    candidate set.

    With ``save_figures`` a writer also draws the volume's matching
    figure (``viz.save_matching_figure``, JAX ``pipeline.py:717-725``)
    from host arrays: the previous volume's confirmed cells, fetched with
    the labels, and the volume's ``seg/coords`` read back.  pyplot's state
    is global and not thread-safe, so figures are drawn under
    ``FIGURE_LOCK``.  A failed figure is an error of the saver, which the
    driver raises, as in JAX."""

    N_WRITERS = 2
    FIGURE_LOCK = threading.Lock()

    def __init__(self, transformer: CoordsToImageTransformer,
                 images_path: Optional[PathPattern],
                 stream: Optional["torch.cuda.Stream"],
                 seg_gate: Optional[SegArtifactSaver] = None,
                 save_figures: bool = False):
        self.transformer = transformer
        self.images_path = images_path
        self.stream = stream
        self.seg_gate = seg_gate
        self.save_figures = save_figures
        self.q: "queue.Queue" = queue.Queue(maxsize=4)
        self.errors: List[Exception] = []
        self.threads = [threading.Thread(target=self._run, daemon=True)
                        for _ in range(self.N_WRITERS)]
        for th in self.threads:
            th.start()

    def put(self, t2: int, real: torch.Tensor, labels: torch.Tensor,
            t1_real: torch.Tensor) -> None:
        """Volume ``t2``'s real coordinates and labels, and the confirmed
        real coordinates it was tracked from (read only for the
        figure)."""
        arrays = (real, labels, t1_real if self.save_figures else None)
        self.q.put((t2, arrays, ready_event(real.device)))

    def close(self) -> None:
        for _ in self.threads:
            self.q.put(None)
        for th in self.threads:
            th.join()

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            t2, arrays, ready = item
            try:
                real, labels, t1_real = to_host(arrays, ready, self.stream)
                if self.seg_gate is None or self.seg_gate.wait_written(t2):
                    self.transformer.save_tracking_results(
                        real, labels, t2, images_path=self.images_path)
                    if self.save_figures:
                        self._figure(t2, real, t1_real)
            except Exception as e:      # surfaced by the driver
                self.errors.append(e)

    def _figure(self, t2: int, real: np.ndarray, t1_real: np.ndarray):
        tr = self.transformer
        seg_t2 = Coordinates.from_raw(
            tr.tree.load_seg_coords(t2), tr.interpolation_factor,
            tr.voxel_size, device="cpu").real.numpy()
        with self.FIGURE_LOCK:
            save_matching_figure(tr.tree, t1_real, seg_t2, real, t2 - 1, t2)


def segment_and_track(images_path, model: StarDist3D,
                      results_dir: Union[str, Path],
                      manual_vol1_glob: str,
                      ffn_weights,
                      voxel_size: Tuple[float, float, float],
                      interpolation_factor: int,
                      t_range: Tuple[int, int],
                      config: TrackingConfig = TrackingConfig(),
                      miss_frame: Optional[List[int]] = None,
                      save_figures: bool = False,
                      verbose: bool = True,
                      timer=None,
                      handoff: str = "disk",
                      mesh=None,
                      data_axis: str = "data",
                      transport: str = "u16", *,
                      device=None) -> Dict[int, np.ndarray]:
    """Segment and track a recording into a results tree, the two
    stages at once (JAX ``segment_and_track``).

    ``images_path``: the recording's slices as a pattern over t, e.g.
    ``"raw/raw_t%03i_z*.tif"``, or an HDF5 recording ``{"h5_file",
    "channel"[, "dset"]}`` (``io.imageio``; it needs ``h5py``);
    ``manual_vol1_glob``: the proofed vol-1
    label slices (``"results/manual_vol1/*.tif"``); ``ffn_weights``: a
    ``.npz`` path or a (params, state) pair (``engine.tracker.TrackerLite``);
    ``t_range``: (first, last) volume.  Returns ``{t: (n, 3) real
    coordinates}`` of the vol-1 cells, t_range[0] included.  Both handoffs
    write the tree as JAX does: ``seg/`` for every volume, ``auto_vol1/``,
    and ``track_results/`` (``coords_real/``, ``labels/``,
    ``merged_labels{,_xz}/``) for every tracked volume.

    ``handoff``: how tracking takes the segmentation.
      - ``"disk"`` (default, as in JAX): ``predict_and_save`` runs on a
        thread of its own, on its own CUDA stream, and
        :func:`track_timelapse` on the caller's, each volume tracked once
        its ``seg/`` artifacts are written (a watermark under a
        condition).  Single or ensemble mode.  When tracking fails, the
        segmenter stops after its volume in flight; a segmenter error
        surfaces here.
      - ``"device"``: per volume one seg call, then one track call fed
        from the seg outputs on the device (single mode only, as in JAX);
        the saver threads write ``seg/`` and ``track_results/`` off the
        critical path, a volume's track artifacts after its seg artifacts.
    A volume in ``miss_frame`` is segmented but not tracked: it keeps the
    previous positions, and the next volume pairs with the last tracked
    one.  A recording that ends before ``t_range[1]`` raises JAX's
    ``RuntimeError`` once the volumes before the gap are tracked.

    ``timer``: optional ``utils.timing.CudaStageTimer``; it times the whole
    ``"call"`` (host work included: decode, percentiles, uploads, the
    artifacts' wait at the end), the vol-1 interpolation, and each
    volume's ``"track"`` (and, with ``handoff="device"``, ``"seg"``).
    ``device``: the card by default (``"cpu"`` to run on the CPU); the
    model must be on it.

    ``mesh``: a ``DeviceMesh`` (``parallel.make_mesh``) whose
    ``data_axis`` spans it.  Every rank of the mesh calls
    ``segment_and_track`` with the same arguments (its model on its own
    device, by default its device), and every rank returns the
    coordinates.  With ``handoff="device"`` the volumes after the first
    are segmented in groups of the axis size, one a rank
    (``engine.stardist.MeshSegStream``); each group's outputs go to rank 0
    by point-to-point sends, and rank 0 runs the serial tracking
    recurrence in t order, as JAX's ``_seg_stream`` feeds its device 0.
    With ``handoff="disk"`` the segmenter thread runs ``predict_and_save``
    over the mesh (on a process group of its own) and tracking runs
    ``track_timelapse`` over it.  Rank 0 writes every file, with the bytes
    of the same call without a mesh.

    ``transport``: the raw volume's wire format to the card
    (``io.imageio.transport_encode``): ``"u16"`` (default, lossless) or
    ``"u8"``, quantized on the host against the volume's 1/99.8
    percentiles (``quantize_u8``), half the upload bytes and lossy; the
    device normalizes it with ``norm_minmax=(0, 255)``.

    ``save_figures``: also write each tracked volume's matching figure,
    ``track_results/figure/matching_<t>.png`` (``viz.save_matching_figure``),
    drawn on the track saver's threads from host arrays.  It needs
    matplotlib, checked before any work."""
    if handoff not in ("disk", "device"):
        raise ValueError(f"handoff must be 'disk' or 'device', got "
                         f"{handoff!r}")
    ax = None
    if mesh is not None:
        from ..parallel.mesh import mesh_axis
        ax = mesh_axis(mesh, data_axis, sole=True)
        if device is None:
            device = ax.device
    if save_figures:
        pyplot()                        # raises without matplotlib
    if handoff == "device" and config.ensemble:
        raise ValueError(
            "handoff='device' supports single mode only; ensemble "
            "tracking draws confirmed references from many past volumes "
            "— use the disk-coupled driver (handoff='disk')")
    check_transport(transport)
    check_recording(images_path)
    dev = select_device(device)
    if not same_device(model.device, dev):
        raise ValueError(f"the model is on {model.device}, the driver on "
                         f"{dev}")
    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext())
    drive = (_segment_and_track_device if handoff == "device"
             else _segment_and_track_disk)
    if ax is not None and not same_device(ax.device, dev):
        raise ValueError(f"this rank is on {ax.device}, the driver on "
                         f"{dev}")
    with stage("call"):
        coords_by_t = drive(
            images_path, model, results_dir, manual_vol1_glob, ffn_weights,
            voxel_size, interpolation_factor, t_range, config, miss_frame,
            save_figures, verbose, stage, transport, dev, ax)
    if verbose and timer is not None:
        print()
        print(timer.summary())
    return coords_by_t


def _segment_and_track_disk(images_path, model, results_dir,
                            manual_vol1_glob, ffn_weights, voxel_size,
                            interpolation_factor, t_range, config,
                            miss_frame, save_figures, verbose, stage,
                            transport, dev, ax=None
                            ) -> Dict[int, np.ndarray]:
    """``predict_and_save`` on a thread (and CUDA stream) of its own,
    :func:`track_timelapse` here, gated volume by volume on the written
    ``seg/`` artifacts (JAX ``pipeline.py:281-356``).  Over a mesh axis
    ``ax`` the segmenter takes a process group of its own, made here on
    every rank before the thread starts."""
    from ..parallel.comm import duplicate
    seg_ax = duplicate(ax) if ax is not None else None
    t_min, t_max = t_range
    done_lock = threading.Condition()
    done: set = set()
    watermark = [t_min - 1]
    seg_error: List[Exception] = []
    seg_done = [False]
    # set when tracking fails: the segmenter stops after its volume in
    # flight instead of sweeping the rest of the recording
    cancel = threading.Event()

    def progress(t):
        with done_lock:
            done.add(t)
            while watermark[0] + 1 in done:
                watermark[0] += 1
            done_lock.notify_all()

    seg_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def seg_thread():
        try:
            with (torch.cuda.stream(seg_stream) if seg_stream is not None
                  else contextlib.nullcontext()):
                predict_and_save(images_path, model, results_dir,
                                 volumes=list(range(t_min, t_max + 1)),
                                 progress_cb=progress,
                                 should_stop=cancel.is_set,
                                 mesh=seg_ax, transport=transport)
        except Exception as e:          # surfaced on the tracking side
            seg_error.append(e)
        with done_lock:
            seg_done[0] = True
            done_lock.notify_all()

    def volume_ready(t):
        # a segmenter that has finished does not imply volume t exists:
        # predict_and_save stops with a warning where the raw images end
        with done_lock:
            done_lock.wait_for(
                lambda: watermark[0] >= t or seg_done[0] or seg_error)
            reached = watermark[0]
        if seg_error:
            raise RuntimeError("segmentation failed") from seg_error[0]
        if reached < t:
            raise RuntimeError(
                f"segmentation ended at t={reached} before volume {t} "
                f"(raw images missing from the recording?); tracking "
                f"cannot continue")

    th = threading.Thread(target=seg_thread, daemon=True)
    th.start()
    tracked_ok = False
    try:
        coords = _track_timelapse(
            results_dir, manual_vol1_glob, ffn_weights, voxel_size,
            interpolation_factor, t_range,
            tuple(int(g) for g in model.config.grid), config, miss_frame,
            images_path, save_figures, verbose, stage, volume_ready, dev,
            ax)
        tracked_ok = True
    finally:
        if not tracked_ok:
            cancel.set()
        th.join()
        if seg_ax is not None:
            torch.distributed.destroy_process_group(seg_ax.group)
    if seg_error:
        raise seg_error[0]
    return coords


def _segment_and_track_device(images_path, model, results_dir,
                              manual_vol1_glob, ffn_weights, voxel_size,
                              interpolation_factor, t_range, config,
                              miss_frame, save_figures, verbose, stage,
                              transport, dev, ax=None
                              ) -> Dict[int, np.ndarray]:
    args = (images_path, model, results_dir, manual_vol1_glob, ffn_weights,
            voxel_size, interpolation_factor, t_range, config, miss_frame,
            save_figures, verbose, stage, transport, dev)
    if ax is None:
        return _device_handoff(*args)
    from ..parallel.comm import follow, lead_result
    if ax.index == 0:
        return lead_result(ax, lambda: _device_handoff(*args, ax))
    # the other ranks segment their share of each group, then take rank
    # 0's coordinates (or its error)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    stream = MeshSegStream(model, ax, _raw_loader(images_path, transport,
                                                  dev, side),
                           list(range(t_range[0], t_range[1] + 1)),
                           t_range[0])
    try:
        for _ in stream:
            pass
    finally:
        stream.close()
    return follow(ax)


def _raw_loader(images_path, transport, dev, side):
    """A prefetch worker's load of volume t: the raw slices, their exact
    percentiles, and the upload started on stream ``side``."""
    def load(t):
        x = load_2d_slices_at_time(images_path, t=t, do_normalize=False)
        x, mi, ma = transport_encode(x, transport)
        return upload_async(x, dev, side), mi, ma
    return load


def _device_handoff(images_path, model, results_dir, manual_vol1_glob,
                    ffn_weights, voxel_size, interpolation_factor, t_range,
                    config, miss_frame, save_figures, verbose, stage,
                    transport, dev, ax=None) -> Dict[int, np.ndarray]:
    """The device handoff on one card, or on rank 0 of mesh axis ``ax``
    (the volumes after the first from a :class:`MeshSegStream`)."""
    t_min, t_max = t_range
    transformer = CoordsToImageTransformer(results_dir, voxel_size,
                                           device=dev)
    transformer.load_segmentation(manual_vol1_glob)
    with stage("interpolate_vol1"):
        transformer.interpolate(interpolation_factor, t_start=t_min)
    tracker = TrackerLite(results_dir, ffn_weights, transformer.coord_vol1,
                          miss_frame=miss_frame,
                          m_step_refine=config.m_step_refine)
    vol1 = transformer.coord_vol1
    grid_t = tuple(int(g) for g in model.config.grid)
    vs_t = tuple(transformer.voxel_size)
    image_shape = transformer.proofed_segmentation.shape
    labels_dtype = torch.uint8 if vol1.cell_num <= 255 else torch.int32
    miss = set(miss_frame or [])
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    load_raw = _raw_loader(images_path, transport, dev, side)
    seg_saver = SegArtifactSaver(model, results_dir, t_min, side,
                                 n_writers=1, max_cells=tracker.max_cells)
    track_saver = _AsyncTrackSaver(transformer, images_path, side,
                                   seg_saver, save_figures)
    truncated = [False]

    def one_card():
        loader = VolumePrefetcher(load_raw, range(t_min, t_max + 1),
                                  depth=2, workers=2)
        volumes = iter(loader)
        try:
            while True:
                try:
                    t, (upload, mi, ma) = next(volumes)
                except StopIteration:
                    return
                except FileNotFoundError:
                    # the recording ended early: the volumes before the
                    # gap are tracked, then the driver raises
                    truncated[0] = True
                    return
                with stage("seg"):
                    seg_out = model.predict_instances_device(
                        upload.wait(), norm_minmax=(mi, ma),
                        return_labels=(t == t_min))
                yield t, seg_out
        finally:
            loader.close()

    stream = None
    if ax is not None:
        stream = MeshSegStream(
            model, ax, load_raw, list(range(t_min, t_max + 1)), t_min,
            lambda: bool(seg_saver.errors or track_saver.errors))
    coords_t1 = vol1
    corrected_by_t: Dict[int, Coordinates] = {}
    prev_pts = prev_kept = None
    done_t = t_min - 1
    segmented = one_card() if stream is None else iter(stream)
    try:
        for t, seg_out in segmented:
            kept, _, _, points, prob_map, _ = seg_out
            seg_saver.put(t, seg_out)
            if t == t_min:
                prev_pts, prev_kept = points, kept
            elif t in miss:
                # segmented, not tracked: the positions stay, and the next
                # volume pairs with the last tracked one
                corrected_by_t[t] = coords_t1
            else:
                with stage("track"):
                    out = track_from_seg(
                        tracker.ffn_params, tracker.ffn_state,
                        coords_t1.raw_f32, vol1.raw_f32, prev_pts,
                        prev_kept, points, kept, prob_map,
                        transformer.atlas, vs_t, image_shape,
                        beta=config.beta, lambda_=config.lambda_,
                        max_repetition=config.max_correction_reps,
                        k_points=config.k_neighbors,
                        max_iteration=config.max_iteration,
                        prob_grid=grid_t,
                        m_step_refine=tracker.m_step_refine,
                        pad_n=tracker.max_cells)
                corrected = Coordinates(out.corrected_raw,
                                        transformer.interpolation_factor,
                                        vs_t)
                track_saver.put(t, corrected.real,
                                out.labels.to(labels_dtype), coords_t1.real)
                corrected_by_t[t] = coords_t1 = corrected
                prev_pts, prev_kept = points, kept
            done_t = t
            if seg_saver.errors:
                raise seg_saver.errors[0]
            if track_saver.errors:
                raise track_saver.errors[0]
            if verbose and t > t_min:
                print(f"tracked t={t}/{t_max}", end="\r")
        if truncated[0] or (stream is not None and stream.truncated):
            raise RuntimeError(
                f"segmentation ended at t={done_t} before volume "
                f"{done_t + 1} (raw images missing from the "
                f"recording?); tracking cannot continue")
    finally:
        if stream is not None:
            stream.close()
        else:
            segmented.close()
        seg_saver.close()
        track_saver.close()
    if seg_saver.errors:
        raise seg_saver.errors[0]
    if track_saver.errors:
        raise track_saver.errors[0]
    print(f"All images from t={t_min} to t={done_t} have been segmented")
    coords_by_t = {t_min: vol1.real.cpu().numpy()}
    for t2, c in corrected_by_t.items():
        coords_by_t[t2] = c.real.cpu().numpy()
    return coords_by_t


def track_timelapse(results_dir: Union[str, Path],
                    manual_vol1_glob: str,
                    ffn_weights,
                    voxel_size: Tuple[float, float, float],
                    interpolation_factor: int,
                    t_range: Tuple[int, int],
                    grid: Tuple[int, int, int] = (1, 1, 1),
                    config: TrackingConfig = TrackingConfig(),
                    miss_frame: Optional[List[int]] = None,
                    images_path: Optional[PathPattern] = None,
                    save_figures: bool = False,
                    verbose: bool = True,
                    timer=None,
                    mesh=None,
                    volume_ready=None, *,
                    device=None) -> Dict[int, np.ndarray]:
    """Track every volume of ``t_range`` from the ``seg/`` artifacts that
    ``engine.stardist.predict_and_save`` wrote and the proofed vol-1 labels
    at ``manual_vol1_glob``; returns ``{t: (n, 3) real coordinates}``
    (JAX ``track_timelapse``).  ``grid``: the StarDist model's grid, which
    ``seg/prob*.npy`` is sampled on.

    Single mode: per volume one track-and-correct step
    (:func:`track_and_correct`) from the seg point sets of t and of the
    last tracked volume.  Ensemble mode (``config.ensemble``): t is
    predicted from each reference volume of
    ``engine.tracker.get_volumes_list`` (up to ``config.sampling_number``)
    with its corrected coordinates from this run, all members in one batch
    (``parallel.ensemble``), combined by the trimmed mean over the real
    members (``config.trim_proportion``), then corrected with no x/y
    boundary.  A volume in ``miss_frame`` keeps the previous positions and
    is no reference.

    Two prefetch workers read each volume's artifacts (and wait on
    ``volume_ready(t)`` first, when given: the disk handoff's gate) and
    start their upload on a side stream; the saver threads write
    ``track_results/`` (``coords_real/``, ``labels/``, and with
    ``images_path`` the merged-label PNGs) off the critical path.
    ``timer``: optional ``utils.timing.CudaStageTimer`` (``"track"`` per
    volume, ``"interpolate_vol1"``).  ``device``: the card by default.

    ``mesh``: a ``DeviceMesh`` whose ``"data"`` axis spans it.  Every rank
    calls ``track_timelapse`` with the same arguments, and every rank
    returns the coordinates.  Rank 0 reads the artifacts, runs the
    recurrence and writes ``track_results/`` (the bytes of the same call
    without a mesh); in ensemble mode each volume's members, padded to a
    multiple of the axis size, are split over the ranks
    (``parallel.ensemble``), gathered, and the padding dropped before the
    trimmed mean.  Single mode runs on rank 0 alone (the recurrence is
    serial), as JAX's ignores the mesh there.

    ``save_figures``: also write each tracked volume's matching figure,
    ``track_results/figure/matching_<t>.png``, as :func:`segment_and_track`
    does (it needs matplotlib, checked before any work)."""
    ax = None
    if mesh is not None:
        from ..parallel.mesh import mesh_axis
        ax = mesh_axis(mesh, "data", sole=True)
        if device is None:
            device = ax.device
    if save_figures:
        pyplot()                        # raises without matplotlib
    dev = select_device(device)
    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext())
    coords_by_t = _track_timelapse(
        results_dir, manual_vol1_glob, ffn_weights, voxel_size,
        interpolation_factor, t_range, tuple(int(g) for g in grid), config,
        miss_frame, images_path, save_figures, verbose, stage, volume_ready,
        dev, ax)
    if verbose and timer is not None:
        print()
        print(timer.summary())
    return coords_by_t


def _track_timelapse(results_dir, manual_vol1_glob, ffn_weights, voxel_size,
                     interpolation_factor, t_range, grid_t, config,
                     miss_frame, images_path, save_figures, verbose, stage,
                     volume_ready, dev, ax=None) -> Dict[int, np.ndarray]:
    """The tracking loop on one card, or over mesh axis ``ax``: rank 0
    runs it and sends its result (or error) to the other ranks, which run
    their share of each volume's ensemble members meanwhile."""
    args = (results_dir, manual_vol1_glob, ffn_weights, voxel_size,
            interpolation_factor, t_range, grid_t, config, miss_frame,
            images_path, save_figures, verbose, stage, volume_ready, dev)
    if ax is None:
        return _track_volumes(*args)
    from ..parallel.comm import follow, lead_result
    from ..parallel.ensemble import MemberFollower
    if ax.index == 0:
        return lead_result(ax, lambda: _track_volumes(*args, ax))
    return follow(ax, MemberFollower(ax, dev))


def _track_volumes(results_dir, manual_vol1_glob, ffn_weights, voxel_size,
                   interpolation_factor, t_range, grid_t, config,
                   miss_frame, images_path, save_figures, verbose, stage,
                   volume_ready, dev, ax=None) -> Dict[int, np.ndarray]:
    t_min, t_max = t_range
    transformer = CoordsToImageTransformer(results_dir, voxel_size,
                                           device=dev)
    transformer.load_segmentation(manual_vol1_glob)
    with stage("interpolate_vol1"):
        transformer.interpolate(interpolation_factor, t_start=t_min)
    tracker = TrackerLite(results_dir, ffn_weights, transformer.coord_vol1,
                          miss_frame=miss_frame,
                          m_step_refine=config.m_step_refine)
    vol1 = transformer.coord_vol1
    vs_t = tuple(transformer.voxel_size)
    vs_np = np.asarray(vs_t, np.float32)
    image_shape = transformer.proofed_segmentation.shape
    labels_dtype = torch.uint8 if vol1.cell_num <= 255 else torch.int32
    miss = set(tracker.miss_frame)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    # single mode pairs each volume with the last volume that is not a
    # miss frame (a miss frame is no reference)
    prev_of: Dict[int, int] = {}
    prev = t_min
    for t in range(t_min + 1, t_max + 1):
        if t not in miss:
            prev_of[t] = prev
            prev = t

    def padded_seg(t):
        # the seg point set in real units, padded: the f32 product of
        # TrackerLite._get_segmented_pos(t).real
        return tracker._pad_np(
            tracker.tree.load_seg_coords(t).astype(np.float32) * vs_np)

    def load_inputs(t2):
        if volume_ready is not None:
            volume_ready(t2)
        prob = transformer.tree.load_seg_prob(t2).astype(np.float16)
        if config.ensemble:
            return upload_async(prob, dev, side), None, None
        (p1, m1), (p2, m2) = padded_seg(prev_of[t2]), padded_seg(t2)
        return (upload_async(prob, dev, side),
                upload_async(np.stack([p1, p2]), dev, side),
                upload_async(np.stack([m1, m2]), dev, side))

    prefetcher = VolumePrefetcher(
        load_inputs, [t for t in range(t_min + 1, t_max + 1)
                      if t not in miss], depth=2, workers=2)
    inputs = iter(prefetcher)
    saver = _AsyncTrackSaver(transformer, images_path, side,
                             save_figures=save_figures)
    coords_t1 = vol1
    corrected_by_t: Dict[int, Coordinates] = {}
    try:
        for t2 in range(t_min + 1, t_max + 1):
            if t2 in miss:
                corrected_by_t[t2] = coords_t1
                continue
            t_in, (prob_up, pts_up, masks_up) = next(inputs)
            assert t_in == t2
            if config.ensemble:
                # the reference volumes' seg/coords are read here, not by
                # the gated prefetcher: the segmenter has written them
                # once t2 is ready
                t1s = get_volumes_list(t2, tracker.miss_frame,
                                       config.sampling_number,
                                       config.adjacent, t_min)
                seg1, mask1 = (torch.from_numpy(np.stack(a)).to(dev)
                               for a in zip(*map(padded_seg, t1s)))
                seg2, mask2 = (torch.from_numpy(a).to(dev)
                               for a in padded_seg(t2))
                confirmed = torch.stack(
                    [(vol1 if t1 == t_min else corrected_by_t[t1]).real
                     for t1 in t1s])
                members = ensemble_member_predictions if ax is None else \
                    functools.partial(lead_members, ax)
                with stage("track"):
                    preds = members(
                        tracker.ffn_params, tracker.ffn_state, confirmed,
                        seg1, mask1, seg2, mask2, beta=config.beta,
                        lambda_=config.lambda_, k_points=config.k_neighbors,
                        max_iteration=config.max_iteration,
                        m_step_refine=tracker.m_step_refine)
                    pred = Coordinates.from_real(
                        trim_mean(preds, config.trim_proportion, axis=0),
                        transformer.interpolation_factor, vs_t)
                    corrected, labels = transformer.accurate_correction(
                        t2, grid_t, pred, ensemble=True,
                        max_repetition=config.max_correction_reps,
                        prob_map_grid=prob_up.wait(), return_device=True)
            else:
                pts, masks = pts_up.wait(), masks_up.wait()
                with stage("track"):
                    out = track_and_correct(
                        tracker.ffn_params, tracker.ffn_state,
                        coords_t1.raw_f32, vol1.raw_f32, pts[0], masks[0],
                        pts[1], masks[1], prob_up.wait(), transformer.atlas,
                        vs_t, image_shape, beta=config.beta,
                        lambda_=config.lambda_,
                        max_repetition=config.max_correction_reps,
                        k_points=config.k_neighbors,
                        max_iteration=config.max_iteration,
                        prob_grid=grid_t,
                        m_step_refine=tracker.m_step_refine)
                corrected = Coordinates(out.corrected_raw,
                                        transformer.interpolation_factor,
                                        vs_t)
                labels = out.labels
            saver.put(t2, corrected.real, labels.to(labels_dtype),
                      coords_t1.real)
            corrected_by_t[t2] = coords_t1 = corrected
            if saver.errors:
                raise saver.errors[0]
            if verbose:
                print(f"tracked t={t2}/{t_max}", end="\r")
    finally:
        # stop the prefetch workers first: an early error would otherwise
        # leave one blocked on the bounded queue
        prefetcher.close()
        saver.close()
    if saver.errors:
        raise saver.errors[0]
    coords_by_t = {t_min: vol1.real.cpu().numpy()}
    for t2, c in corrected_by_t.items():
        coords_by_t[t2] = c.real.cpu().numpy()
    return coords_by_t
