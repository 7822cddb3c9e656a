"""StarDist3D instance program, the segmentation step of the v1.0
workflow and the training data helpers (counterpart of
``3deecelltracker_tpu/engine/stardist.py``: ``save`` :82, :173-217,
:292-327, ``load_stardist_model`` :779, ``predict_and_save`` :833-1083,
``fill_label_holes``, ``load_training_images``, ``configure`` and
``calculate_extents`` :1085-1229).

One call per volume: normalize the raw volume on the device with the
host's 1/99.8 percentiles, reflect-pad to the network's ``div_by``, run the
backbone, gather the sparse candidates, then overlap matrix, greedy NMS
and, when asked, the label render.  Outputs stay on the device.
``finalize_instances`` is the host half of a call that writes artifacts
(``StarDist3D._finalize_instances``, JAX ``engine/stardist.py:327``): it
orders the kept candidates once their arrays are on the host.
:class:`SegArtifactSaver` writes them as ``seg/`` artifacts on saver
threads, and :func:`predict_and_save` segments a whole TIFF recording into
a results tree with it.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import StarDistConfig
from ..io.artifacts import ResultsTree
from ..io.imageio import (check_recording, check_transport, get_t_range,
                          load_2d_slices_at_time, save_volume_slices,
                          transport_encode)
from ..io.prefetch import VolumePrefetcher, ready_event, to_host, upload_async
from ..models.stardist3d import StarDist3DNet, sparse_candidates
from ..ops.nms import greedy_nms, overlap_matrix, render_polyhedra_labels
from ..ops.rays import rays_golden_spiral
from ..utils.checkpoint import save_pytree
from ..utils.convert import load_npz, stardist_params_from_numpy
from ..utils.device import select_device


class StarDist3D:
    """StarDist3D model (arch ``"tpu"``) with its per-volume instance
    program.  ``params``: the network's ``{layer: {"w", "b"}}`` tensors
    (``utils.convert`` for JAX weights, ``StarDist3DNet.init`` for a seeded
    random init)."""

    def __init__(self, config: StarDistConfig, params,
                 max_candidates: int = 1024,
                 render_box: Tuple[int, int, int] = (33, 65, 65),
                 device=None):
        self.config = config
        self.device = select_device(device)
        self.net = StarDist3DNet(config)
        self.params = {name: {k: v.to(self.device, torch.float32)
                              .contiguous() for k, v in layer.items()}
                       for name, layer in params.items()}
        self.rays = torch.from_numpy(rays_golden_spiral(
            config.n_rays, config.anisotropy)).to(self.device)
        self.max_candidates = int(max_candidates)
        self.render_box = tuple(int(b) for b in render_box)
        self.thresholds = dict(prob=config.prob_thresh,
                               nms=config.nms_thresh)

    @staticmethod
    def load(model_dir: Union[str, Path], device=None) -> "StarDist3D":
        """Read a JAX-package model folder (``config.json`` +
        ``weights.npz`` [+ ``thresholds.json``]) with numpy alone."""
        model_dir = Path(model_dir)
        with open(model_dir / "config.json") as fh:
            raw = json.load(fh)
        arch = raw.pop("arch", "tpu")
        if arch != "tpu":
            raise NotImplementedError(f"arch {arch!r}: the port has 'tpu'")
        for key in ("grid", "anisotropy", "unet_pool", "unet_kernel_size",
                    "train_patch_size"):
            if raw.get(key) is not None:
                raw[key] = tuple(raw[key])
        dev = select_device(device)
        params = stardist_params_from_numpy(
            load_npz(model_dir / "weights.npz"), dev)
        model = StarDist3D(StarDistConfig(**raw), params=params, device=dev)
        if (model_dir / "thresholds.json").exists():
            with open(model_dir / "thresholds.json") as fh:
                model.thresholds = json.load(fh)
        return model

    def save(self, model_dir: Union[str, Path]) -> None:
        """Write the model folder JAX's ``StarDist3D.load`` reads:
        ``weights.npz`` (``save_pytree`` of the params), ``config.json``
        (the config with ``arch``) and ``thresholds.json``."""
        model_dir = Path(model_dir)
        model_dir.mkdir(parents=True, exist_ok=True)
        save_pytree(self.params, model_dir / "weights.npz")
        cfg = dict(dataclasses.asdict(self.config), arch="tpu")
        with open(model_dir / "config.json", "w") as fh:
            json.dump(cfg, fh, indent=2)
        with open(model_dir / "thresholds.json", "w") as fh:
            json.dump(self.thresholds, fh)

    def predict_instances_device(self, x_raw: torch.Tensor,
                                 norm_minmax: Tuple[float, float],
                                 return_labels: bool = True):
        """The instance program on one raw (z, y, x) volume (any dtype),
        normalized on the device with ``norm_minmax``, the host's 1/99.8
        percentiles, by csbdeep's formula.

        Returns ``(kept, probs, dists, points, prob_map, labels)`` on the
        device: kept (K,) bool, probs (K,), dists (K, n_rays), points (K, 3)
        int32 zyx, the grid-resolution prob map as float16 (as the JAX
        program ships it), and int32 (z, y, x) labels or None."""
        cfg = self.config
        dev = self.device
        orig_shape = tuple(int(s) for s in x_raw.shape)
        gshape = tuple(-(-s // g) for s, g in zip(orig_shape, cfg.grid))
        mi = torch.tensor(norm_minmax[0], dtype=torch.float32, device=dev)
        ma = torch.tensor(norm_minmax[1], dtype=torch.float32, device=dev)
        x = (x_raw.to(dev).to(torch.float32) - mi) / (ma - mi + 1e-20)
        prob_g, dist_g = self.forward_grid(x)
        prob_map = prob_g[:gshape[0], :gshape[1], :gshape[2]].to(
            torch.float16)
        kept, probs, dists, points, labels = self.instances_from_grid(
            prob_g, dist_g, orig_shape, self.thresholds["prob"],
            self.thresholds["nms"], return_labels)
        return kept, probs, dists, points, prob_map, labels

    def forward_grid(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The backbone on one normalized (z, y, x) float32 volume on the
        device, reflect-padded to ``div_by``: the padded grid-resolution
        ``(prob (gz, gy, gx), dist (gz, gy, gx, n_rays))``."""
        pads = [(-s) % d for s, d in zip(x.shape, self.net.div_by)]
        xp = F.pad(x[None, None], (0, pads[2], 0, pads[1], 0, pads[0]),
                   mode="reflect")[0, 0]
        prob_g, dist_g = self.net.apply(self.params, xp[None, ..., None])
        return prob_g[0, ..., 0], dist_g[0]

    def instances_from_grid(self, prob_g: torch.Tensor,
                            dist_g: torch.Tensor,
                            orig_shape: Tuple[int, int, int],
                            prob_thresh: float, nms_thresh: float,
                            return_labels: bool = True):
        """Candidates, overlaps, greedy NMS and (when asked) the label
        render of one volume of shape ``orig_shape`` from its
        :meth:`forward_grid` output, at the given thresholds: ``(kept,
        probs, dists, points, labels)`` on the device."""
        probs, dists, points, valid = sparse_candidates(
            prob_g, dist_g, self.config.grid, prob_thresh,
            max_candidates=self.max_candidates)
        valid = (valid & (points[:, 0] < orig_shape[0])
                 & (points[:, 1] < orig_shape[1])
                 & (points[:, 2] < orig_shape[2]))
        centers = points.to(torch.float32)
        overlaps = overlap_matrix(centers, dists, self.rays, valid,
                                  prob=probs)
        kept = greedy_nms(probs, overlaps, valid, nms_thresh)
        labels = None
        if return_labels:
            labels = render_polyhedra_labels(
                centers, dists, self.rays, probs, kept, orig_shape,
                self.render_box)
        return kept, probs, dists, points, labels

    def finalize_instances(self, fetched):
        """Host selection from one call's outputs as numpy arrays,
        ``(kept, probs, dists, points, prob_map, labels)`` (``dists`` and
        ``labels`` may be None): the kept candidates by descending prob,
        stably (tied probs keep candidate order, as the device adapter
        ``seg_candidates_to_padded_real`` does), and the grid prob map in
        float32.  Returns ``((labels, details), prob_map)``."""
        kept, probs, dists, points, prob_map, labels = fetched
        order = np.argsort(-np.where(kept, probs, -np.inf), kind="stable")
        sel = order[:int(kept.sum())]
        details: Dict[str, np.ndarray] = {
            "points": points[sel],
            "prob": probs[sel],
            "dist": dists[sel] if dists is not None else None,
            "rays_vertices": self.rays.cpu().numpy(),
        }
        return (labels, details), np.asarray(prob_map, np.float32)


def load_stardist_model(model_name: str = "stardist",
                        basedir: str = "stardist_models",
                        device=None) -> StarDist3D:
    """``stardistwrapper.load_stardist_model`` (:39-43): the model folder
    ``basedir/model_name`` in the JAX package's format (``config.json`` +
    ``weights.npz`` [+ ``thresholds.json``]).  A reference Keras folder
    (``weights_*.h5``) is not ported yet (ROADMAP.md A.8) and raises.
    ``device``: the card by default."""
    model_dir = Path(basedir) / model_name
    if not (model_dir / "weights.npz").exists():
        raise NotImplementedError(
            f"{model_dir} has no weights.npz: Keras model folders are not "
            f"ported yet (ROADMAP.md A.8)")
    model = StarDist3D.load(model_dir, device=device)
    print(f"Load pretrained stardist model '{model_name}' "
          f"from folder '{basedir}'")
    return model


class SegArtifactSaver:
    """Writes each volume's ``seg/`` artifacts as the JAX package's
    ``predict_and_save`` does, on ``n_writers`` threads: ``put(t, seg_out)``
    takes one call's device outputs; a writer copies them to the host on
    ``stream`` once they are ready, orders the kept candidates
    (``finalize_instances``) and writes ``seg/coords*.npy`` (pipeline
    frame), ``seg/prob*.npy`` (the grid map, (x, y, z)) and, for volume
    ``labels_t``, ``auto_vol1/``, then calls ``progress_cb(t)``.

    ``max_cells``: a volume that keeps more candidates raises (the device
    handoff's tracker pads to it and would drop the rest).  An error is
    kept in ``errors`` and is terminal: no volume taken from the queue
    after it is written, so a resumable tree holds no artifacts queued
    past a failure."""

    def __init__(self, model: StarDist3D, results_folder: Union[str, Path],
                 labels_t: int, stream: Optional["torch.cuda.Stream"],
                 n_writers: int = 2, max_cells: Optional[int] = None,
                 progress_cb: Optional[Callable[[int], None]] = None):
        self.model = model
        self.tree = ResultsTree(results_folder)
        self.results_folder = Path(results_folder)
        self.labels_t = labels_t
        self.stream = stream
        self.max_cells = max_cells
        self.progress_cb = progress_cb
        self.q: "queue.Queue" = queue.Queue(maxsize=2 + n_writers)
        self.errors: List[Exception] = []
        self._cond = threading.Condition()
        self._written: Set[int] = set()
        self.threads = [threading.Thread(target=self._run, daemon=True)
                        for _ in range(n_writers)]
        for th in self.threads:
            th.start()

    def wait_written(self, t: int) -> bool:
        """Block until volume ``t``'s artifacts are written; False if a
        writer failed first."""
        with self._cond:
            self._cond.wait_for(lambda: t in self._written or self.errors)
            return t in self._written

    def put(self, t: int, seg_out) -> None:
        kept, probs, _, points, prob_map, labels = seg_out
        self.q.put((t, (kept, probs, points, prob_map, labels),
                    ready_event(kept.device)))

    def close(self) -> None:
        for _ in self.threads:
            self.q.put(None)
        for th in self.threads:
            th.join()

    def _write_one(self, t: int, finalized) -> None:
        (labels, details), prob_map = finalized
        n = int(details["points"].shape[0])
        if self.max_cells is not None and n > self.max_cells:
            raise ValueError(f"{n} cells exceeds max_cells={self.max_cells}")
        self.tree.save_seg_coords(t, details["points"][:, [1, 2, 0]])
        self.tree.save_seg_prob(t, prob_map.transpose((1, 2, 0)))
        if t == self.labels_t and labels is not None:
            save_volume_slices(labels.transpose((1, 2, 0)),
                               self.results_folder / "auto_vol1",
                               "auto_vol1_z%04i.tif")
        if self.progress_cb is not None:
            self.progress_cb(t)
        with self._cond:
            self._written.add(t)
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
                kept, probs, points, prob_map, labels = to_host(
                    arrays, ready, self.stream)
                self._write_one(t, self.model.finalize_instances(
                    (kept, probs, None, points, prob_map, labels)))
            except Exception as e:      # surfaced by the caller
                with self._cond:
                    self.errors.append(e)
                    self._cond.notify_all()


def predict_and_save(images_path: str, model: StarDist3D,
                     results_folder: Union[str, Path],
                     prefetch_depth: int = 2,
                     batch_size: int = 4,
                     volumes=None,
                     progress_cb: Optional[Callable[[int], None]] = None,
                     tile_shape=None,
                     should_stop: Optional[Callable[[], bool]] = None,
                     mesh=None,
                     transport: str = "u16") -> None:
    """Segment every volume of a TIFF recording into ``results_folder/seg/``
    (``stardistwrapper.predict_and_save`` :75-111): ``seg/coords*.npy``, the
    kept centres in the pipeline's (x, y, z) frame, and ``seg/prob*.npy``,
    the grid-resolution probability map in (x, y, z) (float16 values, as
    the device ships them, stored in float32 as JAX stores them), and the
    recording's first volume rendered as ``auto_vol1/`` labels for the
    user to proofread into ``manual_vol1/``.

    ``volumes``: the time points to segment (default: the recording).
    ``progress_cb``: ``cb(t)``, called on a saver thread once volume t's
    artifacts are written.  ``should_stop``: ``fn() -> bool``, polled once
    per volume; the sweep ends when it turns true.  A recording whose
    images end early stops with JAX's warning; a write failure raises.

    Pipelined as in JAX: two prefetch workers decode the TIFFs, take the
    exact percentiles and start the upload on a side stream; one seg call
    per volume runs on the caller's current stream (``batch_size`` is
    accepted for JAX's signature: the card needs no dispatch batching);
    two saver threads copy the results back on the side stream and write
    them.  ``model.device`` is the device.

    Not ported yet, each raising: ``tile_shape`` (ROADMAP.md A.6; its
    ``tile_candidates``, ``tile_batch`` and ``shrink`` come with it),
    ``mesh`` and ``transport="u8"`` (A.5), HDF5 recordings (A.2)."""
    if tile_shape is not None:
        raise NotImplementedError(
            "tile_shape= (the tiled StarDist sweep) is not ported yet "
            "(ROADMAP.md A.6)")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (segmentation over several cards) is not ported yet "
            "(ROADMAP.md A.5)")
    check_transport(transport)
    check_recording(images_path)
    tree = ResultsTree(results_folder)
    tree.make_dirs()
    t_max, t_min = get_t_range(images_path)
    work = list(volumes) if volumes is not None else \
        list(range(t_min, t_max + 1))
    dev = model.device
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def _load_raw(t):
        x = load_2d_slices_at_time(images_path, t=t, do_normalize=False)
        x, mi, ma = transport_encode(x, transport)
        return upload_async(x, dev, side), mi, ma

    loader = VolumePrefetcher(_load_raw, work, depth=prefetch_depth,
                              workers=2)
    saver = SegArtifactSaver(model, results_folder, t_min, side,
                             progress_cb=progress_cb)
    done_t = work[0] - 1
    volumes_in = iter(loader)
    try:
        while not (should_stop is not None and should_stop()):
            # only the image load is the end of the recording: a write
            # failure surfaces from the saver as itself
            try:
                t, (upload, mi, ma) = next(volumes_in)
            except StopIteration:
                break
            except FileNotFoundError:
                print(f"Warning: segmentation stopped; images at "
                      f"t={done_t + 1} cannot be loaded!")
                break
            saver.put(t, model.predict_instances_device(
                upload.wait(), norm_minmax=(mi, ma),
                return_labels=(t == t_min)))
            done_t = t
            if saver.errors:
                break
    finally:
        loader.close()
        saver.close()
    if saver.errors:
        raise saver.errors[0]
    print(f"All images from t={work[0]} to t={done_t} have been segmented")


UP_LIMIT = 400000  # stardistwrapper.py:32


def fill_label_holes(lbl: np.ndarray) -> np.ndarray:
    """Fill holes inside each labeled instance (csbdeep/stardist
    ``fill_label_holes``, used by ``stardistwrapper.py:180``)."""
    import scipy.ndimage as ndi

    out = lbl.copy()
    for sl, idx in zip(ndi.find_objects(lbl), range(1, lbl.max() + 1)):
        if sl is None:
            continue
        grown = tuple(slice(max(s.start - 1, 0), s.stop + 1) for s in sl)
        mask = lbl[grown] == idx
        filled = ndi.binary_fill_holes(mask)
        out[grown][filled] = idx
    return out


def load_training_images(path_train_images: str, path_train_labels: str,
                         max_projection: bool = True, plot: bool = True):
    """Load and normalize StarDist training volumes and split them
    (``stardistwrapper.load_training_images`` :168-211): sorted globs with
    matching file names, every page of each multi-page TIFF
    (``io.imageio.imread_volume``), per-volume 1/99.8 percentile
    normalization, label-hole filling, the single-volume duplication and
    the seeded 15% validation split.  ``plot=True`` (the matplotlib
    preview) is not ported yet (ROADMAP.md A.9) and raises.

    Returns (X, Y, X_trn, Y_trn, X_val, Y_val, n_channel)."""
    from glob import glob

    from ..io.imageio import imread_volume, percentile_normalize

    if plot:
        raise NotImplementedError(
            "plot=True (the training preview figure) is not ported yet "
            "(ROADMAP.md A.9); pass plot=False")
    del max_projection
    X_paths = sorted(glob(path_train_images))
    Y_paths = sorted(glob(path_train_labels))
    if not X_paths or not Y_paths:
        raise FileNotFoundError("Error: No images found in either X or Y.")
    if len(X_paths) != len(Y_paths) or not all(
            Path(x).name == Path(y).name for x, y in zip(X_paths, Y_paths)):
        raise ValueError("Error: Filenames in X and Y do not match.")
    X = [np.asarray(imread_volume(p)) for p in X_paths]
    Y = [np.asarray(imread_volume(p)) for p in Y_paths]
    if X[0].ndim != 3:
        raise NotImplementedError(
            f"{X_paths[0]}: volumes with channels are not ported yet; the "
            f"port reads (z, y, x) grayscale pages, got {X[0].shape}")
    n_channel = 1
    X = [percentile_normalize(x.astype(np.float32), 1, 99.8) for x in X]
    Y = [fill_label_holes(y.astype(np.int32)) for y in Y]
    if len(X) == 1:
        print("Warning: only one training data was provided! It will be "
              "used for both training and validation purposes!")
        X = [X[0], X[0]]
        Y = [Y[0], Y[0]]
    rng = np.random.RandomState(42)
    ind = rng.permutation(len(X))
    n_val = max(1, int(round(0.15 * len(ind))))
    ind_train, ind_val = ind[:-n_val], ind[-n_val:]
    X_val, Y_val = [X[i] for i in ind_val], [Y[i] for i in ind_val]
    X_trn, Y_trn = [X[i] for i in ind_train], [Y[i] for i in ind_train]
    print('number of images: %3d' % len(X))
    print('- training:       %3d' % len(X_trn))
    print('- validation:     %3d' % len(X_val))
    print(f"X[0].shape={X[0].shape}")
    return X, Y, X_trn, Y_trn, X_val, Y_val, n_channel


def configure(Y: List[np.ndarray], n_channel: int = 1,
              up_limit: int = UP_LIMIT) -> StarDistConfig:
    """Config heuristics from training labels
    (``stardistwrapper.configure`` :213-259): anisotropy from the median
    instance extents, grid 2 on near-isotropic axes, 96 golden-spiral
    rays, the patch solved under the voxel budget and the ``div_by``
    constraint, square y/x patches."""
    extents = calculate_extents(Y)
    anisotropy = tuple(float(np.max(extents) / e) for e in extents)
    n_rays = 96
    grid = tuple(1 if a > 1.5 else 2 for a in anisotropy)

    a, b, c = anisotropy
    train_patch_size = np.cbrt(up_limit * a * b * c) / np.array([a, b, c])
    up_limit_xyz = (Y[0].shape[0], min(Y[0].shape[1:3]),
                    min(Y[0].shape[1:3]))
    scaling = np.min(np.asarray(up_limit_xyz) / train_patch_size)
    if scaling < 1:
        train_patch_size = train_patch_size * scaling
    unet_n_depth = 2
    unet_pool = (2, 2, 2)
    div_by = tuple(p ** unet_n_depth * g for p, g in zip(unet_pool, grid))
    train_patch_size = [int(d * (i // d))
                        for i, d in zip(train_patch_size, div_by)]
    train_patch_size[1] = train_patch_size[2] = min(train_patch_size[1:])

    return StarDistConfig(
        n_rays=n_rays, grid=grid, anisotropy=anisotropy,
        unet_n_depth=unet_n_depth, unet_pool=unet_pool,
        n_channel_in=n_channel,
        train_patch_size=tuple(train_patch_size))


def calculate_extents(Y: List[np.ndarray], func=np.median) -> np.ndarray:
    """Median per-axis instance extent over labeled volumes (stardist
    ``calculate_extents``)."""
    import scipy.ndimage as ndi
    extents = []
    for y in Y:
        for sl in ndi.find_objects(y):
            if sl is None:
                continue
            extents.append([s.stop - s.start for s in sl])
    if not extents:
        return np.ones(3)
    return func(np.asarray(extents, np.float64), axis=0)
