"""The v1.0 segment-and-track main path (counterpart of
``3deecelltracker_tpu/engine/pipeline.py``: ``seg_candidates_to_padded_real``,
the track-from-seg body (:40-86, :165-204), ``segment_and_track`` with
``handoff="device"`` (``_segment_and_track_device`` :359-583) and its
artifact savers (:600-835), single device).

Per volume: one seg call (``StarDist3D.predict_instances_device``), then one
track call fed straight from the seg outputs, which stay on the device.
The vol-1 proofed labels build the subregion atlas and the vol-1 centres
once per recording.  ``segment_and_track`` reads a TIFF recording and
writes the results tree, the artifacts off the critical path on saver
threads; ``segment_and_track_arrays`` takes arrays in and gives arrays
out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import TrackingConfig
from ..coordinates import Coordinates
from ..io.artifacts import ResultsTree
from ..io.imageio import (check_transport, fast_percentiles,
                          load_2d_slices_at_time, save_volume_slices,
                          transport_encode)
from ..io.prefetch import VolumePrefetcher, upload_async
from ..ops.subregions import SubregionAtlas
from ..ops.watershed import recalculate_cell_boundaries
from ..utils.device import select_device, to_device, upload_raw
from .correction import accurate_correction_loop, get_cells_on_boundary
from .stardist import StarDist3D
from .tracker import TrackerLite, track_step
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



def _ready_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event at the end of the work enqueued so far on ``device``'s
    current stream (None off the card)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _to_host(tensors, ready: Optional[torch.cuda.Event],
             stream: Optional["torch.cuda.Stream"]) -> List:
    """Host numpy copies of ``tensors`` (None passes through).  On the
    card: pinned buffers filled by ``non_blocking`` copies on ``stream``
    once ``ready`` has passed, then waited for.  The caller holds the
    tensors until this returns, so their memory is not reused while the
    side stream reads it."""
    if ready is None:
        return [None if a is None else a.detach().cpu().numpy()
                for a in tensors]
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        host = [None if a is None else
                torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                .copy_(a, non_blocking=True) for a in tensors]
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return [None if h is None else h.numpy() for h in host]


class _AsyncSegSaver:
    """Writes each volume's seg artifacts as ``predict_and_save`` does
    (``seg/coords*.npy``, ``seg/prob*.npy``, and the ``auto_vol1`` labels
    of the first volume) on its own thread, off the tracking path.

    It also holds the contract that the device adapter cannot: a volume
    that keeps more candidates than the tracker's pad raises here (the
    adapter's static shapes drop the rest).  An error is terminal: no
    later volume's artifacts are written."""

    def __init__(self, model: StarDist3D, tree: ResultsTree,
                 results_folder, t_min: int, max_cells: int,
                 stream: Optional["torch.cuda.Stream"]):
        self.model = model
        self.tree = tree
        self.results_folder = Path(results_folder)
        self.t_min = t_min
        self.max_cells = int(max_cells)
        self.stream = stream
        self.q: "queue.Queue" = queue.Queue(maxsize=4)
        self.errors: List[Exception] = []
        # volumes arrive and are written in t order on the one thread, so
        # "written through t" is one integer; the track saver waits on it
        self._cond = threading.Condition()
        self._done_t = t_min - 1
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def wait_written(self, t: int) -> bool:
        """Block until volume ``t``'s seg artifacts are written; False if
        the saver failed first."""
        with self._cond:
            self._cond.wait_for(lambda: self._done_t >= t or self.errors)
            return self._done_t >= t

    def put(self, t: int, seg_out) -> None:
        kept, probs, _, points, prob_map, labels = seg_out
        self.q.put((t, (kept, probs, points, prob_map, labels),
                    _ready_event(kept.device)))

    def close(self) -> None:
        self.q.put(None)
        self.thread.join()

    def _write_one(self, t: int, finalized) -> None:
        (labels, details), prob_map = finalized
        n = int(details["points"].shape[0])
        if n > self.max_cells:
            raise ValueError(f"{n} cells exceeds max_cells={self.max_cells}")
        self.tree.save_seg_coords(t, details["points"][:, [1, 2, 0]])
        self.tree.save_seg_prob(t, prob_map.transpose((1, 2, 0)))
        if t == self.t_min and labels is not None:
            save_volume_slices(labels.transpose((1, 2, 0)),
                               self.results_folder / "auto_vol1",
                               "auto_vol1_z%04i.tif")
        with self._cond:
            self._done_t = t
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            if self.errors:
                continue        # drain, so the producer never blocks
            t, arrays, ready = item
            try:
                kept, probs, points, prob_map, labels = _to_host(
                    arrays, ready, self.stream)
                self._write_one(t, self.model.finalize_instances(
                    (kept, probs, None, points, prob_map, labels)))
            except Exception as e:      # surfaced by the driver
                self.errors.append(e)
                with self._cond:
                    self._cond.notify_all()


class _AsyncTrackSaver:
    """Writes each tracked volume's ``coords_real``, label TIFFs and
    merged-label PNGs on ``N_WRITERS`` threads (the codec encodes with the
    GIL released).  A volume's labels stay on the device until a writer
    fetches them.  A writer waits until the same volume's seg artifacts
    are written (``seg_gate``) and writes nothing for a volume whose seg
    artifacts failed: no tracked artifacts from a truncated candidate
    set."""

    N_WRITERS = 2

    def __init__(self, transformer: CoordsToImageTransformer,
                 images_path: str, stream: Optional["torch.cuda.Stream"],
                 seg_gate: _AsyncSegSaver):
        self.transformer = transformer
        self.images_path = images_path
        self.stream = stream
        self.seg_gate = seg_gate
        self.q: "queue.Queue" = queue.Queue(maxsize=4)
        self.errors: List[Exception] = []
        self.threads = [threading.Thread(target=self._run, daemon=True)
                        for _ in range(self.N_WRITERS)]
        for th in self.threads:
            th.start()

    def put(self, t2: int, real: torch.Tensor, labels: torch.Tensor
            ) -> None:
        self.q.put((t2, (real, labels), _ready_event(real.device)))

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
                real, labels = _to_host(arrays, ready, self.stream)
                if self.seg_gate.wait_written(t2):
                    self.transformer.save_tracking_results(
                        real, labels, t2, images_path=self.images_path)
            except Exception as e:      # surfaced by the driver
                self.errors.append(e)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def segment_and_track(images_path: str, model: StarDist3D,
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
                      handoff: str = "device",
                      mesh=None,
                      transport: str = "u16",
                      device=None) -> Dict[int, np.ndarray]:
    """Segment and track a TIFF recording into a results tree: the v1.0
    driver with ``handoff="device"`` (JAX ``segment_and_track`` ->
    ``_segment_and_track_device``).

    ``images_path``: the recording's slices as a pattern over t, e.g.
    ``"raw/raw_t%03i_z*.tif"``; ``manual_vol1_glob``: the proofed vol-1
    label slices (``"results/manual_vol1/*.tif"``); ``ffn_weights``: a
    ``.npz`` path or a (params, state) pair (``engine.tracker.TrackerLite``);
    ``t_range``: (first, last) volume.  Returns ``{t: (n, 3) real
    coordinates}`` of the vol-1 cells, t_range[0] included.

    Per volume: the prefetcher decodes the TIFFs and takes the exact 1/99.8
    percentiles on two threads and starts the upload on a side stream;
    then one seg call, and one track call fed from the seg outputs on the
    device.  Saver threads copy results to the host on a side stream and
    write the tree as JAX does: ``seg/`` for every volume, ``auto_vol1/``,
    and ``track_results/`` (``coords_real/``, ``labels/``,
    ``merged_labels{,_xz}/``) for every tracked volume, a volume's track
    artifacts after its seg artifacts.
    A volume in ``miss_frame`` is segmented but not tracked: it keeps the
    previous positions, and the next volume pairs with the last tracked
    one.  A recording that ends before ``t_range[1]`` raises once the
    volumes before the gap are tracked.

    ``timer``: optional ``utils.timing.CudaStageTimer``; it times each
    volume's ``"seg"`` and ``"track"`` and the whole ``"call"`` (host work
    included: decode, percentiles, uploads, the artifacts' wait at the
    end).  ``device``: the card by default (``"cpu"`` to run on the CPU);
    the model must be on it.

    Not ported yet, each raising: ``handoff="disk"`` (ROADMAP.md A.2),
    ``mesh`` and ``transport="u8"`` (A.5), ``save_figures=True`` (A.9),
    and ensemble tracking, which the JAX device handoff refuses as
    well."""
    if handoff == "disk":
        raise NotImplementedError(
            "handoff='disk' (tracking through the seg/ tree) is not ported "
            "yet (ROADMAP.md A.2); use handoff='device'")
    if handoff != "device":
        raise ValueError(f"handoff must be 'disk' or 'device', got "
                         f"{handoff!r}")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (segmentation over several cards) is not ported yet "
            "(ROADMAP.md A.5)")
    if save_figures:
        raise NotImplementedError(
            "save_figures=True (the matching figures) is not ported yet "
            "(ROADMAP.md A.9)")
    if config.ensemble:
        raise ValueError(
            "handoff='device' supports single mode only; ensemble "
            "tracking draws confirmed references from many past volumes "
            "— use the disk-coupled driver (handoff='disk')")
    check_transport(transport)
    dev = select_device(device)
    if not _same_device(model.device, dev):
        raise ValueError(f"the model is on {model.device}, the driver on "
                         f"{dev}")
    stage = timer.stage if timer is not None else (
        lambda name: contextlib.nullcontext())
    with stage("call"):
        coords_by_t = _segment_and_track_device(
            images_path, model, results_dir, manual_vol1_glob, ffn_weights,
            voxel_size, interpolation_factor, t_range, config, miss_frame,
            verbose, stage, transport, dev)
    if verbose and timer is not None:
        print()
        print(timer.summary())
    return coords_by_t


def _segment_and_track_device(images_path, model, results_dir,
                              manual_vol1_glob, ffn_weights, voxel_size,
                              interpolation_factor, t_range, config,
                              miss_frame, verbose, stage, transport, dev
                              ) -> Dict[int, np.ndarray]:
    t_min, t_max = t_range
    transformer = CoordsToImageTransformer(voxel_size, dev, results_dir)
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

    def _load_raw(t):
        x = load_2d_slices_at_time(images_path, t=t, do_normalize=False)
        x, mi, ma = transport_encode(x, transport)
        return upload_async(x, dev, side), mi, ma

    loader = VolumePrefetcher(_load_raw, range(t_min, t_max + 1), depth=2,
                              workers=2)
    seg_saver = _AsyncSegSaver(model, transformer.tree, results_dir, t_min,
                               tracker.max_cells, side)
    track_saver = _AsyncTrackSaver(transformer, images_path, side,
                                   seg_saver)
    coords_t1 = vol1
    corrected_by_t: Dict[int, Coordinates] = {}
    prev_pts = prev_kept = None
    done_t = t_min - 1
    truncated = False
    try:
        volumes = iter(loader)
        while True:
            try:
                t, (upload, mi, ma) = next(volumes)
            except StopIteration:
                break
            except FileNotFoundError:
                # the recording ended early: the volumes before the gap
                # are tracked, then the driver raises
                truncated = True
                break
            with stage("seg"):
                seg_out = model.predict_instances_device(
                    upload.wait(), norm_minmax=(mi, ma),
                    return_labels=(t == t_min))
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
                        prob_grid=grid_t, pad_n=tracker.max_cells)
                corrected = Coordinates(out.corrected_raw,
                                        transformer.interpolation_factor,
                                        vs_t)
                track_saver.put(t, corrected.real,
                                out.labels.to(labels_dtype))
                corrected_by_t[t] = coords_t1 = corrected
                prev_pts, prev_kept = points, kept
            done_t = t
            if seg_saver.errors:
                raise seg_saver.errors[0]
            if track_saver.errors:
                raise track_saver.errors[0]
            if verbose and t > t_min:
                print(f"tracked t={t}/{t_max}", end="\r")
        if truncated:
            raise RuntimeError(
                f"segmentation ended at t={done_t} before volume "
                f"{done_t + 1} (raw images missing from the "
                f"recording?); tracking cannot continue")
    finally:
        loader.close()
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
