"""StarDist3D: the per-volume API, the instance program, tiled
prediction, the segmentation step of the v1.0 workflow and the training
data helpers (counterpart of ``3deecelltracker_tpu/engine/stardist.py``:
``StarDist3D`` :37-405, its tiled path :408-777, ``load_stardist_model``
:779, ``predict_and_save`` :833-1083, ``fill_label_holes``,
``load_training_images``, ``save_arrays_to_folder``,
``save_auto_seg_vol1``, ``print_dict``, ``configure`` and
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
a results tree with it, on one card or, over a mesh, a volume a rank
(:class:`MeshSegStream`).  :meth:`StarDist3D.predict_instances_sharded`
splits one volume's tiles over the ranks.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import sys
import threading
from pathlib import Path
import warnings
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
from ..models.stardist3d import (StarDist3DNet, neighborhood_max_3x3x3,
                                 sparse_candidates)
from ..ops.nms import greedy_nms, overlap_matrix, render_polyhedra_labels
from ..ops.rays import rays_golden_spiral
from ..ops.tiling import TilePlan, pad_for_tiles, plan_tiles
from ..utils.checkpoint import save_pytree
from ..utils.convert import load_npz, stardist_params_from_numpy
from ..utils.device import same_device, select_device, upload_raw
from ..utils.keras_import import import_stardist3d, stardist_config_from_json
from ..viz import plot_img_label_center_slice, plot_img_label_max_projection


class StarDist3D:
    """StarDist3D model with the reference's per-volume
    API (:meth:`predict_instances`, :meth:`predict`,
    :meth:`predict_sparse`), tiled prediction for volumes too large for one
    pass (:meth:`predict_instances_tiled`) and the device programs the
    drivers call (:meth:`predict_instances_device`,
    :meth:`predict_instances_tiled_device`).

    ``params``: the network's ``{layer: {"w", "b"}}`` tensors
    (``utils.convert`` carries JAX weights across); None initializes them
    with ``StarDist3DNet.init`` from ``rng``, a ``torch.Generator`` or an
    int seed (default 0).  A seed gives other weights than JAX's
    ``PRNGKey`` of the same number: the two generators differ.
    ``arch``: ``"tpu"`` or ``"keras"``, the reference's Keras topology
    (``models.stardist3d.StarDist3DNet``; :func:`load_stardist_keras_dir`
    builds one from a reference model folder).
    ``lmax_prefilter``: only 3x3x3 prob local maxima become NMS candidates
    (``models.stardist3d.sparse_candidates``).  ``device``: the card by
    default."""

    def __init__(self, config: StarDistConfig, params=None, rng=None,
                 max_candidates: int = 1024,
                 render_box: Tuple[int, int, int] = (33, 65, 65),
                 arch: str = "tpu", lmax_prefilter: bool = True, *,
                 device=None):
        self.net = StarDist3DNet(config, arch=arch)
        self.config = config
        self.arch = arch
        self.device = select_device(device)
        if params is None:
            gen = rng if isinstance(rng, torch.Generator) else \
                torch.Generator().manual_seed(0 if rng is None else int(rng))
            params = self.net.init(gen, device=self.device)
        self.params = {name: {k: v.to(self.device, torch.float32)
                              .contiguous() for k, v in layer.items()}
                       for name, layer in params.items()}
        self.rays = torch.from_numpy(rays_golden_spiral(
            config.n_rays, config.anisotropy)).to(self.device)
        self.max_candidates = int(max_candidates)
        self.render_box = tuple(int(b) for b in render_box)
        self.lmax_prefilter = bool(lmax_prefilter)
        self.thresholds = dict(prob=config.prob_thresh,
                               nms=config.nms_thresh)

    @property
    def _thresholds(self) -> Dict[str, float]:
        """``thresholds`` under the JAX package's name."""
        return self.thresholds

    @_thresholds.setter
    def _thresholds(self, value: Dict[str, float]) -> None:
        self.thresholds = value

    @staticmethod
    def load(model_dir: Union[str, Path], *, device=None) -> "StarDist3D":
        """Read a JAX-package model folder (``config.json`` with its
        ``arch`` + ``weights.npz`` [+ ``thresholds.json``]) with numpy
        alone."""
        model_dir = Path(model_dir)
        with open(model_dir / "config.json") as fh:
            raw = json.load(fh)
        arch = raw.pop("arch", "tpu")
        for key in ("grid", "anisotropy", "unet_pool", "unet_kernel_size",
                    "train_patch_size"):
            if raw.get(key) is not None:
                raw[key] = tuple(raw[key])
        dev = select_device(device)
        params = stardist_params_from_numpy(
            load_npz(model_dir / "weights.npz"), dev)
        model = StarDist3D(StarDistConfig(**raw), params=params, arch=arch,
                           device=dev)
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
        cfg = dict(dataclasses.asdict(self.config), arch=self.arch)
        with open(model_dir / "config.json", "w") as fh:
            json.dump(cfg, fh, indent=2)
        with open(model_dir / "thresholds.json", "w") as fh:
            json.dump(self.thresholds, fh)

    # ---- helpers -----------------------------------------------------------
    def _volume(self, x) -> torch.Tensor:
        """A (z, y, x) volume (array or tensor, any dtype) on this model's
        device; uint16 arrays widen there (``utils.device.upload_raw``)."""
        return upload_raw(x if isinstance(x, torch.Tensor) else
                          np.asarray(x), self.device)

    def _normalize(self, x_raw: torch.Tensor,
                   norm_minmax: Tuple[float, float]) -> torch.Tensor:
        """csbdeep's formula on the device in float32, with the host's
        1/99.8 percentiles (``(0, 1)`` leaves a normalized volume as it
        is)."""
        dev = self.device
        mi = torch.tensor(norm_minmax[0], dtype=torch.float32, device=dev)
        ma = torch.tensor(norm_minmax[1], dtype=torch.float32, device=dev)
        return (x_raw.to(dev).to(torch.float32) - mi) / (ma - mi + 1e-20)

    def _grid_shape(self, shape) -> Tuple[int, int, int]:
        return tuple(-(-int(s) // g) for s, g in zip(shape,
                                                     self.config.grid))

    def _candidates(self, prob_g: torch.Tensor, dist_g: torch.Tensor,
                    shape, prob_thresh: float):
        """``sparse_candidates`` of a :meth:`forward_grid` output, with
        ``valid`` cleared outside a volume of ``shape``
        (``resizer.filter_points``: the ``div_by`` pad margin holds none):
        ``(probs, dists, points, valid)``."""
        probs, dists, points, valid = sparse_candidates(
            prob_g, dist_g, self.config.grid, prob_thresh,
            max_candidates=self.max_candidates,
            lmax_prefilter=self.lmax_prefilter)
        valid = valid & ((points[:, 0] < shape[0])
                         & (points[:, 1] < shape[1])
                         & (points[:, 2] < shape[2]))
        return probs, dists, points, valid

    # ---- the per-volume API (stardist3dcustom.py:152) ----------------------
    def predict_sparse(self, x, prob_thresh: Optional[float] = None):
        """``(probs (K,), dists (K, n_rays), points (K, 3) zyx, valid (K,),
        prob_map)`` on the device for a normalized (z, y, x) volume
        (``_predict_sparse_generator``, stardist3dcustom.py:168-261).
        ``prob_map`` is at grid resolution with the ``div_by`` padding
        cropped; ``valid`` excludes candidates in the pad margin."""
        if prob_thresh is None:
            prob_thresh = self.thresholds["prob"]
        xv = self._volume(x).to(torch.float32)
        prob_g, dist_g = self.forward_grid(xv)
        gz, gy, gx = self._grid_shape(xv.shape)
        return (*self._candidates(prob_g, dist_g, xv.shape, prob_thresh),
                prob_g[:gz, :gy, :gx])

    def predict(self, x) -> Tuple[np.ndarray, np.ndarray]:
        """Dense outputs of a normalized (z, y, x) volume at grid
        resolution, the ``div_by`` padding cropped: ``(prob (gz, gy, gx),
        dist (gz, gy, gx, n_rays))`` as host arrays (the ``sparse=False``
        branch of stardist3dcustom.py:116-126)."""
        xv = self._volume(x).to(torch.float32)
        prob_g, dist_g = self.forward_grid(xv)
        gz, gy, gx = self._grid_shape(xv.shape)
        return (prob_g[:gz, :gy, :gx].cpu().numpy(),
                dist_g[:gz, :gy, :gx].cpu().numpy())

    def predict_instances(self, x, prob_thresh: Optional[float] = None,
                          nms_thresh: Optional[float] = None,
                          return_labels: bool = True, sparse: bool = True,
                          return_predict: bool = False):
        """``((labels, details), prob_map)`` of a normalized (z, y, x)
        volume (reference ``StarDist3DCustom.predict_instances``,
        stardist3dcustom.py:152), through :meth:`predict_instances_device`
        and :meth:`finalize_instances`; ``prob_map`` is the grid map in
        float16 steps, as the instance program ships it.

        ``sparse=False`` also runs :meth:`predict` and returns its float32
        prob map instead; the instances are the same.
        ``return_predict=True`` implies ``sparse=False`` (with the
        reference's warning) and returns ``((labels, details), (prob,
        dist), prob)``, the documented intent of stardist3dcustom.py:75-84
        (its own dense branch raises on a tuple of the wrong length)."""
        if return_predict and sparse:
            warnings.warn(
                "Setting sparse to False because return_predict is True")
            sparse = False
        instances, prob_map = self.finalize_instances(to_host(
            self.predict_instances_device(
                self._volume(x), (0.0, 1.0), return_labels,
                prob_thresh=prob_thresh, nms_thresh=nms_thresh),
            None, None))
        if sparse:
            return instances, prob_map
        prob, dist = self.predict(x)
        if return_predict:
            return instances, (prob, dist), prob
        return instances, prob

    # ---- the instance program ---------------------------------------------
    def predict_instances_device(self, x_raw: torch.Tensor,
                                 norm_minmax: Tuple[float, float],
                                 return_labels: bool = True, *,
                                 prob_thresh: Optional[float] = None,
                                 nms_thresh: Optional[float] = None):
        """The instance program on one raw (z, y, x) volume (any dtype),
        normalized on the device with ``norm_minmax``, the host's 1/99.8
        percentiles, by csbdeep's formula.  The thresholds default to
        ``thresholds``.

        Returns ``(kept, probs, dists, points, prob_map, labels)`` on the
        device: kept (K,) bool, probs (K,), dists (K, n_rays), points (K, 3)
        int32 zyx, the grid-resolution prob map as float16 (as the JAX
        program ships it), and int32 (z, y, x) labels or None."""
        orig_shape = tuple(int(s) for s in x_raw.shape)
        gz, gy, gx = self._grid_shape(orig_shape)
        prob_g, dist_g = self.forward_grid(self._normalize(x_raw,
                                                           norm_minmax))
        prob_map = prob_g[:gz, :gy, :gx].to(torch.float16)
        kept, probs, dists, points, labels = self.instances_from_grid(
            prob_g, dist_g, orig_shape,
            self.thresholds["prob"] if prob_thresh is None else prob_thresh,
            self.thresholds["nms"] if nms_thresh is None else nms_thresh,
            return_labels)
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
        probs, dists, points, valid = self._candidates(
            prob_g, dist_g, orig_shape, prob_thresh)
        kept, labels = self._nms_render(probs, dists, points, valid,
                                        orig_shape, nms_thresh,
                                        return_labels)
        return kept, probs, dists, points, labels

    def _nms_render(self, probs, dists, points, valid, shape, nms_thresh,
                    return_labels):
        """Overlaps, greedy NMS and (when asked) the label render of a
        volume of ``shape``: ``(kept, labels or None)``."""
        centers = points.to(torch.float32)
        overlaps = overlap_matrix(centers, dists, self.rays, valid,
                                  prob=probs)
        kept = greedy_nms(probs, overlaps, valid, nms_thresh)
        labels = None
        if return_labels:
            labels = render_polyhedra_labels(
                centers, dists, self.rays, probs, kept, shape,
                self.render_box)
        return kept, labels

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

    # ---- tiled prediction (JAX engine/stardist.py:408-709) -----------------
    def predict_instances_tiled(self, x, tile_shape=(None, 256, 256),
                                shrink=None,
                                prob_thresh: Optional[float] = None,
                                nms_thresh: Optional[float] = None,
                                tile_candidates: int = 256,
                                return_labels: bool = True,
                                norm_minmax: Tuple[float, float] = (0., 1.),
                                tile_batch: int = 8):
        """Tile-and-stitch instance prediction of a (z, y, x) volume too
        large for one backbone pass (the reference raises for tiled sparse
        prediction, stardist3dcustom.py:188).

        The volume is normalized with ``norm_minmax`` and reflect-padded on
        the device, and covered by overlapping tiles whose ``shrink``
        margin defaults to the network's receptive field
        (``StarDist3DNet.receptive_field``, rounded up to ``div_by``), so
        the backbone's outputs in every tile centre equal the whole-volume
        pass's.  Candidates come from the tile centres only (they partition
        the volume), with the whole-volume border rule in global grid
        coordinates, ``tile_candidates`` per tile; then the
        ``max_candidates`` most probable go through a global NMS and
        render.  Within the receptive field of the volume's faces results
        may differ from the whole-volume pass (other padding context).

        ``tile_shape``: per-axis tile size, rounded down to ``div_by``;
        None (or a size that covers the axis) leaves an axis whole.
        ``tile_batch`` tiles go through the backbone as one batch.
        Returns ``((labels, details), prob_map)`` like
        :meth:`predict_instances`, the prob map in float32."""
        return self.finalize_instances(to_host(
            self.predict_instances_tiled_device(
                self._volume(x), norm_minmax, tile_shape=tile_shape,
                shrink=shrink, tile_candidates=tile_candidates,
                return_labels=return_labels, tile_batch=tile_batch,
                prob_thresh=prob_thresh, nms_thresh=nms_thresh),
            None, None))

    def plan_tiling(self, vol: Tuple[int, int, int], tile_shape,
                    shrink=None) -> TilePlan:
        """The tile plan of a volume of shape ``vol``: each tiled axis's
        shrink is ``shrink`` (default: the receptive field) rounded up to
        ``div_by`` so that tiles sit on the whole volume's pooling grid,
        its tile ``tile_shape`` rounded down to ``div_by``; an axis whose
        tile is None or covers it is one tile of the volume padded to
        ``div_by``.  Raises ``ValueError`` for a tile no wider than twice
        its shrink."""
        div = self.net.div_by
        rf = self.net.receptive_field()
        if shrink is None:
            shrink = rf
        tiles, shr = [], []
        for ax in range(3):
            t, v, d = tile_shape[ax], int(vol[ax]), div[ax]
            s = -(-int(shrink[ax]) // d) * d
            if t is None or int(t) - 2 * s >= v:
                tiles.append(-(-v // d) * d)
                shr.append(0)
            else:
                t = (int(t) // d) * d
                if t - 2 * s <= 0:
                    raise ValueError(
                        f"tile {t} too small for shrink {s} on axis {ax} "
                        f"(receptive field {rf})")
                tiles.append(t)
                shr.append(s)
        return plan_tiles(vol, tiles, shr)

    def predict_instances_tiled_device(
            self, x_raw: torch.Tensor, norm_minmax: Tuple[float, float],
            tile_shape=(None, 256, 256), shrink=None,
            tile_candidates: int = 256, return_labels: bool = True,
            tile_batch: int = 8, prob_thresh: Optional[float] = None,
            nms_thresh: Optional[float] = None):
        """The tiled instance program on one raw (z, y, x) volume (any
        dtype) on the device, with :meth:`predict_instances_device`'s
        outputs, the prob map in float32 (as JAX's tiled path writes it).

        The volume is normalized and reflect-padded once on the device
        (``ops.tiling.pad_for_tiles``, numpy's reflection at any pad
        width); each batch of ``tile_batch`` tiles is cut from it into one
        contiguous (B, z, y, x, 1) tensor and goes through the backbone in
        one call, so each conv layer is one kernel launch over B tiles.
        The last batch is filled with copies of its last tile, whose
        outputs are dropped."""
        if prob_thresh is None:
            prob_thresh = self.thresholds["prob"]
        if nms_thresh is None:
            nms_thresh = self.thresholds["nms"]
        vol = tuple(int(s) for s in x_raw.shape)
        plan = self.plan_tiling(vol, tile_shape, shrink)
        xn = pad_for_tiles(self._normalize(x_raw, norm_minmax), plan)
        origins = [tuple(int(v) for v in o) for o in plan.origins]
        outs = self._tile_batches(xn, origins, plan, vol, tile_candidates,
                                  prob_thresh, tile_batch)
        return self._merge_tiles(plan, vol, origins, *outs, nms_thresh,
                                 return_labels)

    def _tile_batches(self, xn: torch.Tensor, origins, plan: TilePlan,
                      vol: Tuple[int, int, int], k_tile: int,
                      prob_thresh: float, tile_batch: int):
        """:meth:`_tile_batch` over the tiles at ``origins`` in batches of
        ``tile_batch`` (the last filled with copies of its last tile,
        whose outputs are dropped), concatenated in origin order."""
        batch = max(1, min(int(tile_batch), len(origins)))
        parts = []
        for start in range(0, len(origins), batch):
            chunk = origins[start:start + batch]
            n_real = len(chunk)
            chunk = chunk + [chunk[-1]] * (batch - n_real)
            parts.append([t[:n_real] for t in self._tile_batch(
                xn, chunk, plan, vol, k_tile, prob_thresh)])
        return [torch.cat([p[i] for p in parts]) for i in range(5)]

    def _merge_tiles(self, plan: TilePlan, vol, origins, prob_c, probs,
                     dists, points, valid, nms_thresh: float,
                     return_labels: bool):
        """The tiled program's merge from every tile's :meth:`_tile_batch`
        outputs in origin order: each tile's centre prob map pasted into
        the grid map (cut at its end); the candidates by a stable sort on
        prob (ties keep tile order, as numpy's stable argsort does in JAX),
        cut to ``max_candidates``; then NMS and render.  The tiled
        program's outputs."""
        grid = tuple(self.config.grid)
        gshape = self._grid_shape(vol)
        c_g = tuple(c // g for c, g in zip(plan.center_shape, grid))
        prob_map = torch.zeros(gshape, dtype=torch.float32,
                               device=self.device)
        for i, o in enumerate(origins):
            og = [v // g for v, g in zip(o, grid)]
            ext = [min(c, gs - v) for c, gs, v in zip(c_g, gshape, og)]
            if all(e > 0 for e in ext):
                prob_map[og[0]:og[0] + ext[0], og[1]:og[1] + ext[1],
                         og[2]:og[2] + ext[2]] = \
                    prob_c[i, :ext[0], :ext[1], :ext[2]]
        probs, dists, points, valid = (t.flatten(0, 1) for t in
                                       (probs, dists, points, valid))
        order = torch.sort(torch.where(valid, probs, -torch.inf),
                           descending=True, stable=True
                           ).indices[:self.max_candidates]
        probs, dists, points, valid = (probs[order], dists[order],
                                       points[order], valid[order])
        kept, labels = self._nms_render(probs, dists, points, valid, vol,
                                        nms_thresh, return_labels)
        return kept, probs, dists, points, prob_map, labels

    def _tile_batch(self, xn: torch.Tensor, chunk, plan: TilePlan,
                    vol: Tuple[int, int, int], k_tile: int,
                    prob_thresh: float):
        """One backbone call over the tiles at padded origins ``chunk``,
        then per tile: the centre crop of prob and dist, the 3x3x3 peak
        test on the uncropped tile grid, the border and range masks in
        global grid coordinates and a top-``k_tile`` of the centre
        (``_make_tile_fn``, JAX engine/stardist.py:408-462).  Returns
        ``(prob_c (B, cz, cy, cx), probs (B, k), dists (B, k, n_rays),
        points (B, k, 3) int32 zyx, valid (B, k))``."""
        cfg, dev = self.config, self.device
        grid, n_rays = tuple(cfg.grid), cfg.n_rays
        tz, ty, tx = plan.tile_shape
        xb = torch.stack([xn[o0:o0 + tz, o1:o1 + ty, o2:o2 + tx]
                          for o0, o1, o2 in chunk])[..., None]
        prob_g, dist_g = self.net.apply(self.params, xb)
        prob_g = prob_g[..., 0]
        s_g = [s // g for s, g in zip(plan.shrink, grid)]
        c_g = [c // g for c, g in zip(plan.center_shape, grid)]
        crop = (slice(None),) + tuple(slice(s, s + c)
                                      for s, c in zip(s_g, c_g))
        prob_c = prob_g[crop]
        og = torch.tensor([[v // g for v, g in zip(o, grid)]
                           for o in chunk], dtype=torch.int64, device=dev)
        zz = og[:, 0, None, None, None] + torch.arange(
            c_g[0], device=dev)[None, :, None, None]
        yy = og[:, 1, None, None, None] + torch.arange(
            c_g[1], device=dev)[None, None, :, None]
        xx = og[:, 2, None, None, None] + torch.arange(
            c_g[2], device=dev)[None, None, None, :]
        # the whole-volume path's border rule, on its padded grid
        b = 2
        gdim = [(-(-v // d) * d) // g
                for v, d, g in zip(vol, self.net.div_by, grid)]
        keep = ((zz >= b) & (zz < gdim[0] - b) & (yy >= b)
                & (yy < gdim[1] - b) & (xx >= b) & (xx < gdim[2] - b)
                & (zz * grid[0] < vol[0]) & (yy * grid[1] < vol[1])
                & (xx * grid[2] < vol[2]))
        if self.lmax_prefilter:
            keep = keep & (prob_c >= neighborhood_max_3x3x3(prob_g)[crop])
        n_b = len(chunk)
        masked = torch.where(keep, prob_c, -torch.inf).reshape(n_b, -1)
        k = min(int(k_tile), masked.shape[1])
        top_p, idx = torch.sort(masked, dim=1, descending=True, stable=True)
        top_p, idx = top_p[:, :k], idx[:, :k]
        valid = top_p > prob_thresh
        dist_c = dist_g[crop].reshape(n_b, -1, n_rays)
        dists = torch.clamp_min(torch.gather(
            dist_c, 1, idx[..., None].expand(n_b, k, n_rays)), 1e-3)
        cy, cx = c_g[1], c_g[2]
        points = torch.stack(
            [og[:, 0, None] + idx // (cy * cx),
             og[:, 1, None] + (idx // cx) % cy,
             og[:, 2, None] + idx % cx], dim=-1) * torch.tensor(
                 grid, dtype=torch.int64, device=dev)
        return (prob_c, torch.where(valid, top_p, 0.0), dists,
                points.to(torch.int32), valid)

    def predict_instances_sharded(self, x, mesh=None,
                                  tile_shape=(None, 256, 256), shrink=None,
                                  prob_thresh: Optional[float] = None,
                                  nms_thresh: Optional[float] = None,
                                  tile_candidates: int = 256,
                                  return_labels: bool = True,
                                  norm_minmax: Tuple[float, float] = (0.,
                                                                      1.)):
        """Tile-and-stitch instance prediction with the tiles split over
        the ranks of a 1-axis mesh (JAX :711-776): every rank calls it
        with the same volume and arguments, runs the same per-tile program
        as :meth:`predict_instances_tiled_device` on its contiguous share
        of the tiles (in batches of 8; the last share filled with copies
        of the last tile, whose outputs are dropped), and gathers every
        tile's centre prob map and candidates; then every rank runs the
        global merge, NMS and render.  Returns what
        :meth:`predict_instances_tiled` returns, on every rank, and the
        same instances.  ``mesh``: a ``DeviceMesh`` whose first axis takes
        the tiles, or None for a world of every rank (JAX's default mesh of
        every device); the model must be on this rank's device."""
        from ..parallel.mesh import mesh_axis
        ax = mesh_axis(mesh)
        if not same_device(self.device, ax.device):
            raise ValueError(f"the model is on {self.device}, this rank on "
                             f"{ax.device}")
        if prob_thresh is None:
            prob_thresh = self.thresholds["prob"]
        if nms_thresh is None:
            nms_thresh = self.thresholds["nms"]
        return self.finalize_instances(to_host(
            self._sharded_device(ax, self._volume(x), norm_minmax,
                                 tile_shape, shrink, tile_candidates,
                                 return_labels, prob_thresh, nms_thresh),
            None, None))

    def _sharded_device(self, ax, x_raw: torch.Tensor, norm_minmax,
                        tile_shape, shrink, k_tile: int,
                        return_labels: bool, prob_thresh: float,
                        nms_thresh: float, tile_batch: int = 8):
        """:meth:`predict_instances_sharded`'s outputs on the device, as
        :meth:`predict_instances_tiled_device` gives them."""
        from ..parallel.comm import all_gather_tensors
        vol = tuple(int(s) for s in x_raw.shape)
        plan = self.plan_tiling(vol, tile_shape, shrink)
        xn = pad_for_tiles(self._normalize(x_raw, norm_minmax), plan)
        origins = [tuple(int(v) for v in o) for o in plan.origins]
        per = -(-len(origins) // ax.size)
        mine = [origins[min(i, len(origins) - 1)]
                for i in range(ax.index * per, (ax.index + 1) * per)]
        gathered = all_gather_tensors(ax, self._tile_batches(
            xn, mine, plan, vol, k_tile, prob_thresh, tile_batch))
        prob_c, probs, dists, points, valid = (
            torch.cat([g[i] for g in gathered])[:len(origins)]
            for i in range(5))
        return self._merge_tiles(plan, vol, origins, prob_c, probs, dists,
                                 points, valid, nms_thresh, return_labels)

def load_stardist_model(model_name: str = "stardist",
                        basedir: str = "stardist_models", *,
                        device=None) -> StarDist3D:
    """``stardistwrapper.load_stardist_model`` (:39-43): the model folder
    ``basedir/model_name`` in either format, as JAX's takes them: the JAX
    package's (``config.json`` + ``weights.npz`` [+ ``thresholds.json``],
    read with numpy alone) or the reference's stardist-0.8 Keras folder
    (:func:`load_stardist_keras_dir`, which needs ``h5py``).  ``device``:
    the card by default."""
    model_dir = Path(basedir) / model_name
    if (model_dir / "weights.npz").exists():
        model = StarDist3D.load(model_dir, device=device)
    else:
        model = load_stardist_keras_dir(model_dir, device=device)
    print(f"Load pretrained stardist model '{model_name}' "
          f"from folder '{basedir}'")
    return model


def load_stardist_keras_dir(model_dir: Union[str, Path], *,
                            device=None) -> StarDist3D:
    """A reference stardist-0.8 Keras model folder
    (``stardistwrapper.py:39-43``) as an ``arch="keras"`` model: the
    Config3D ``config.json``, the first of ``weights_best.h5``,
    ``weights_last.h5``, ``weights_now.h5`` (else the first ``*.h5`` by
    name) and, when there, ``thresholds.json``.  Reading the ``.h5`` needs
    ``h5py`` (``ImportError`` without it); ``StarDist3D.save`` of the
    result writes a folder that loads without it."""
    model_dir = Path(model_dir)
    config = stardist_config_from_json(model_dir / "config.json")
    weights = next((model_dir / name for name in (
        "weights_best.h5", "weights_last.h5", "weights_now.h5")
        if (model_dir / name).exists()), None)
    if weights is None:
        cands = sorted(model_dir.glob("*.h5"))
        if not cands:
            raise FileNotFoundError(f"no .h5 checkpoint in {model_dir}")
        weights = cands[0]
    dev = select_device(device)
    params = stardist_params_from_numpy(import_stardist3d(weights, config),
                                        dev)
    model = StarDist3D(config, params=params, arch="keras", device=dev)
    thresh_file = model_dir / "thresholds.json"
    if thresh_file.exists():
        with open(thresh_file) as fh:
            raw = json.load(fh)
        model.thresholds = dict(
            prob=float(raw.get("prob", config.prob_thresh)),
            nms=float(raw.get("nms", config.nms_thresh)))
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
            save_auto_seg_vol1(labels.transpose((1, 2, 0)),
                               self.results_folder)
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


class MeshSegStream:
    """The volumes of ``work`` segmented over the ranks of a mesh axis
    (``parallel.mesh.MeshAxis``), in groups of the axis size: rank i of
    the axis loads and segments the group's i-th volume with the
    single-volume program (:meth:`StarDist3D.predict_instances_device`)
    and sends its outputs to rank 0 of the axis, as bytes, by
    point-to-point sends.  Volume ``labels_t`` (the recording's first,
    whose labels are rendered) runs on rank 0 alone, as JAX runs vol 1's
    single-volume program (``engine/stardist.py:906-1043``).

    Iterating yields ``(t, seg_out)`` in t order on rank 0 of the axis
    and nothing on the others; every rank of the axis iterates it.
    Before each group the ranks exchange two flags each: whether its
    volume loaded, and ``should_stop()``.  A stop on any rank ends the
    sweep on all; the first volume that did not load ends it after the
    volumes before it (``truncated``, with ``done_t`` the last one
    segmented).  A consumer that leaves the loop early calls
    :meth:`close`, which takes the group's remaining sends and stops the
    other ranks at the next exchange."""

    def __init__(self, model: StarDist3D, ax, load_raw: Callable, work,
                 labels_t: int, should_stop: Optional[Callable[[], bool]]
                 = None, prefetch_depth: int = 2):
        self.model, self.ax = model, ax
        self.should_stop = should_stop
        self.truncated = False
        self.done_t = work[0] - 1 if work else labels_t - 1
        # the steps, in t order: (t,) for the labels volume, else groups
        # of up to the axis size
        self.steps: List[Tuple[int, ...]] = []
        group: List[int] = []
        for t in work:
            if t == labels_t:
                if group:
                    self.steps.append(tuple(group))
                    group = []
                self.steps.append((t,))
            else:
                group.append(t)
                if len(group) == ax.size:
                    self.steps.append(tuple(group))
                    group = []
        if group:
            self.steps.append(tuple(group))
        self.labels_t = labels_t
        mine = [ts[ax.index] for ts in self.steps
                if self._owner(ts) is not None
                and self._owner(ts) == ax.index]
        self.loader = VolumePrefetcher(load_raw, mine, depth=prefetch_depth,
                                       workers=2)
        self._abort = False
        self._gen = self._run()

    def _single(self, ts) -> bool:
        return ts == (self.labels_t,)

    def _owner(self, ts) -> Optional[int]:
        """The axis rank that segments this rank's volume of step ``ts``
        (this rank, or None where it has none)."""
        if self._single(ts):
            return 0 if self.ax.index == 0 else None
        return self.ax.index if self.ax.index < len(ts) else None

    def close(self) -> None:
        """End the sweep on every rank (the protocol drained), then stop
        the loads."""
        self._abort = True
        try:
            for _ in self._gen:
                pass
        finally:
            self.loader.close()

    def __iter__(self):
        return self._gen

    def _run(self):
        from ..parallel.comm import all_ints, recv_tensors, send_tensors, \
            spec_of
        ax, model = self.ax, self.model
        volumes = iter(self.loader)
        for ts in self.steps:
            stop = self._abort or bool(self.should_stop is not None
                                       and self.should_stop())
            item, status = None, 2              # 2: no volume of mine
            if self._owner(ts) is not None:
                try:
                    item = next(volumes)[1]
                    status = 0
                except FileNotFoundError:
                    status = 1
            flags = all_ints(ax, [status, int(stop)])
            if any(f[1] for f in flags):
                return
            owners = [0] if self._single(ts) else range(len(ts))
            n_ok = 0
            for i in owners:
                if flags[i][0] != 0:
                    break
                n_ok += 1
            out = None
            if item is not None and ax.index < n_ok:
                upload, mi, ma = item
                out = model.predict_instances_device(
                    upload.wait(), norm_minmax=(mi, ma),
                    return_labels=self._single(ts))
            if ax.index == 0:
                for i in range(n_ok):
                    if i > 0:
                        got = recv_tensors(ax, spec_of(base), i)
                        yield ts[i], (*got, None)
                    else:
                        base = out[:5]
                        yield ts[0], out
            elif out is not None:
                send_tensors(ax, out[:5], 0)
            if n_ok:
                self.done_t = ts[n_ok - 1]
            if n_ok < len(owners):
                self.truncated = True
                return


def predict_and_save(images_path, model: StarDist3D,
                     results_folder: Union[str, Path],
                     prefetch_depth: int = 2,
                     batch_size: int = 4,
                     volumes=None,
                     progress_cb: Optional[Callable[[int], None]] = None,
                     tile_shape=None,
                     tile_candidates: int = 256,
                     tile_batch: int = 8,
                     shrink=None,
                     should_stop: Optional[Callable[[], bool]] = None,
                     mesh=None,
                     data_axis: str = "data",
                     transport: str = "u16") -> None:
    """Segment every volume of a recording into ``results_folder/seg/``
    (``stardistwrapper.predict_and_save`` :75-111): ``seg/coords*.npy``, the
    kept centres in the pipeline's (x, y, z) frame, and ``seg/prob*.npy``,
    the grid-resolution probability map in (x, y, z) (float16 values, as
    the device ships them, stored in float32 as JAX stores them), and the
    recording's first volume rendered as ``auto_vol1/`` labels for the
    user to proofread into ``manual_vol1/``.  ``images_path``: a TIFF
    pattern over t, or an HDF5 recording ``{"h5_file", "channel"[,
    "dset"]}`` (``io.imageio``; it needs ``h5py``).

    ``volumes``: the time points to segment (default: the recording).
    ``progress_cb``: ``cb(t)``, called on a saver thread once volume t's
    artifacts are written.  ``should_stop``: ``fn() -> bool``, polled once
    per volume; the sweep ends when it turns true.  A recording whose
    images end early stops with JAX's warning; a write failure raises.

    ``tile_shape``: when set (e.g. ``(None, 256, 256)``), each volume is
    segmented by :meth:`StarDist3D.predict_instances_tiled_device`, tile
    by tile, for volumes too large for one backbone pass;
    ``tile_candidates``, ``tile_batch`` and ``shrink`` pass through to it,
    and its prob maps are float32.

    Pipelined as in JAX: two prefetch workers read the volumes, take the
    exact percentiles and start the upload on a side stream; one seg call
    per volume runs on the caller's current stream (``batch_size`` is
    accepted for JAX's signature: the card needs no dispatch batching);
    two saver threads copy the results back on the side stream and write
    them.  ``model.device`` is the device.

    ``mesh``: a ``DeviceMesh`` (``parallel.make_mesh``) whose
    ``data_axis`` takes the volumes: every rank of the mesh calls
    ``predict_and_save`` with the same arguments and its model on its own
    device, and the volumes are segmented in groups of the axis size, one
    a rank (:class:`MeshSegStream`; the recording's first volume on rank
    0 alone).  The mesh's first rank (0 on every axis) writes every
    artifact, with the bytes of the same call without a mesh, and calls
    ``progress_cb``; every rank returns once the tree is written.  With
    ``tile_shape`` it raises JAX's ``ValueError`` (shard tiles with
    :meth:`StarDist3D.predict_instances_sharded`).  ``data_axis`` is
    ignored without a mesh, as in JAX.

    ``transport``: the raw volume's wire format to the card
    (``io.imageio.transport_encode``): ``"u16"`` (default, lossless) or
    ``"u8"`` (quantized on the host against the volume's 1/99.8
    percentiles, half the upload bytes, lossy; normalized on the device
    with ``norm_minmax=(0, 255)``), over a mesh too: each rank loads and
    encodes its own volumes."""
    ax = None
    if mesh is not None:
        if tile_shape is not None:
            raise ValueError(
                "mesh= and tile_shape= are mutually exclusive; shard "
                "tiles of huge volumes via predict_instances_sharded")
        from ..parallel.mesh import mesh_axis
        ax = mesh_axis(mesh, data_axis, sole=True)
        if model is not None and not same_device(model.device, ax.device):
            raise ValueError(f"the model is on {model.device}, this rank "
                             f"on {ax.device}")
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

    def _segment(x, mi, ma, return_labels):
        if tile_shape is None:
            return model.predict_instances_device(
                x, norm_minmax=(mi, ma), return_labels=return_labels)
        return model.predict_instances_tiled_device(
            x, (mi, ma), tile_shape=tile_shape, shrink=shrink,
            tile_candidates=tile_candidates, return_labels=return_labels,
            tile_batch=tile_batch)

    if ax is not None:
        _predict_and_save_mesh(model, ax, _load_raw, work, t_min,
                               results_folder, side, prefetch_depth,
                               progress_cb, should_stop)
        return
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
            saver.put(t, _segment(upload.wait(), mi, ma, t == t_min))
            done_t = t
            if saver.errors:
                break
    finally:
        loader.close()
        saver.close()
    if saver.errors:
        raise saver.errors[0]
    print(f"All images from t={work[0]} to t={done_t} have been segmented")


def _predict_and_save_mesh(model: StarDist3D, ax, load_raw, work, t_min,
                           results_folder, side, prefetch_depth,
                           progress_cb, should_stop) -> None:
    """:func:`predict_and_save` over the ranks of mesh axis ``ax``: a
    :class:`MeshSegStream`, whose rank 0 writes when it is the mesh's
    first rank; a write failure stops every rank."""
    from ..parallel.comm import barrier
    saver = (SegArtifactSaver(model, results_folder, t_min, side,
                              progress_cb=progress_cb)
             if ax.lead else None)

    def stop():
        return bool((should_stop is not None and should_stop())
                    or (saver is not None and saver.errors))

    stream = MeshSegStream(model, ax, load_raw, work, t_min, stop,
                           prefetch_depth)
    try:
        for t, seg_out in stream:
            if saver is not None:
                saver.put(t, seg_out)
    finally:
        stream.close()
        if saver is not None:
            saver.close()
    barrier(ax)
    if saver is not None and saver.errors:
        raise saver.errors[0]
    if ax.lead:
        if stream.truncated:
            print(f"Warning: segmentation stopped; images at "
                  f"t={stream.done_t + 1} cannot be loaded!")
        print(f"All images from t={work[0]} to t={stream.done_t} have "
              f"been segmented")


def save_arrays_to_folder(arrays: List[np.ndarray],
                          folder_path: Union[str, Path]) -> None:
    """Save arrays as ``coords%04i.npy`` (1-based) into ``folder_path``
    (``stardistwrapper.save_arrays_to_folder`` :149-165)."""
    path = Path(folder_path)
    path.mkdir(parents=True, exist_ok=True)
    for i, arr in enumerate(arrays):
        np.save(path / f"coords{i + 1:04d}.npy", arr)


def save_auto_seg_vol1(labels_xyz: np.ndarray,
                       results_folder: Union[str, Path]) -> None:
    """Write the vol-1 auto segmentation as per-z TIFFs in
    ``results_folder/auto_vol1/`` (``stardistwrapper.save_auto_seg_vol1``
    :140-146); labels in the pipeline's (x, y, z) frame."""
    save_volume_slices(labels_xyz, Path(results_folder) / "auto_vol1",
                       "auto_vol1_z%04i.tif")


def print_dict(my_dict: dict) -> None:
    """``stardistwrapper.print_dict`` (:284-286)."""
    for key, value in my_dict.items():
        print(f"{key}: {value}")


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
    (``io.imageio.imread_volume``; a volume of (z, y, x, c) channels,
    each channel normalized on its own), per-volume 1/99.8 percentile
    normalization, label-hole filling, the single-volume duplication and
    the seeded 15% validation split.  ``plot=True`` (JAX's default) draws
    the first volume and its labels (``viz.plot_img_label_max_projection``,
    or ``plot_img_label_center_slice`` without ``max_projection``); it
    needs matplotlib.

    Returns (X, Y, X_trn, Y_trn, X_val, Y_val, n_channel)."""
    from glob import glob

    from ..io.imageio import imread_volume, percentile_normalize

    X_paths = sorted(glob(path_train_images))
    Y_paths = sorted(glob(path_train_labels))
    if not X_paths or not Y_paths:
        raise FileNotFoundError("Error: No images found in either X or Y.")
    if len(X_paths) != len(Y_paths) or not all(
            Path(x).name == Path(y).name for x, y in zip(X_paths, Y_paths)):
        raise ValueError("Error: Filenames in X and Y do not match.")
    X = [np.asarray(imread_volume(p)) for p in X_paths]
    Y = [np.asarray(imread_volume(p)) for p in Y_paths]
    n_channel = 1 if X[0].ndim == 3 else X[0].shape[-1]
    if n_channel > 1:
        print("Normalizing image channels independently.")
        sys.stdout.flush()
    # over (z, y, x); each channel of a (z, y, x, c) volume on its own
    X = [percentile_normalize(x.astype(np.float32), 1, 99.8,
                              axis=(0, 1, 2) if x.ndim == 4 else None)
         for x in X]
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
    if plot:
        img = X[0] if X[0].ndim == 3 else X[0][..., :3]
        if max_projection:
            plot_img_label_max_projection(img, Y[0])
        else:
            plot_img_label_center_slice(img, Y[0])
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
