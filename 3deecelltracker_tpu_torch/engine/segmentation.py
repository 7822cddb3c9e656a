"""U-Net segmentation engine of the legacy path: volume -> cell instances ->
centres (counterpart of ``3deecelltracker_tpu/engine/segmentation.py``:
``SegResult``, ``UNetSegmenter``).

Per volume: LCN (strided median), reflect-pad, the whole tile batch through
the U-Net in one forward, stitch; then the per-z 2-D watershed, the 3-D
watershed with size filtering, sequential relabelling and centres of mass.
Everything stays on the device; the host reads the probability maximum, the
adaptive ``min_size``/``cell_num`` and the cell count.  The U-Net computes in
``compute_dtype``, bfloat16 by default as JAX's (``engine/segmentation.py:
48``): bf16 conv operands, f32 products, sums and activations (``models.
layers.conv3d``); ``torch.float32`` computes in f32 throughout.  Over
several cards (``mesh``) the U-Net sweep splits its tile batch over the
ranks (``mesh_mode="tiles"``) or the volume along x with halo exchange
(``"halo"``), ``parallel.spatial``.  The probabilities may go through
the reference's on-disk cache (``unet_cache/t%06i.npy``, tracker.py:652-669)
in JAX's format: float16 ``.npy`` read back as float32, so a cache written
by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SegmentationConfig
from ..models.unet3d import UNet3D
from ..ops.connected import relabel_sequential
from ..ops.hopper_conv import check_compute_dtype
from ..ops.lcn import normalize_image
from ..ops.segment_reduce import center_of_mass
from ..ops.tiling import extract_tiles, pad_for_tiles, plan_tiles, stitch_tiles
from ..ops.watershed import watershed_2d, watershed_3d
from ..utils.device import select_device, to_device, upload_raw

MEDIAN_STRIDE = 61   # LCN background median from a 1-in-61 sample


class SegResult(NamedTuple):
    """Parity with the reference's ``SegResults`` (tracker.py:464-496);
    tensors on the segmenter's device."""
    image_cell_bg: torch.Tensor          # (x, y, z) f32 U-Net probability
    l_center_coordinates: torch.Tensor   # (n, 3) f32 centres, voxel units
    segmentation_auto: torch.Tensor      # (x, y, z) int32 instance labels
    image_gcn: torch.Tensor              # raw / 65536 (f64 for integer raw)
    r_coordinates_segment: torch.Tensor  # (n, 3) f64, z times z_xy_ratio


class UNetSegmenter:
    """U-Net + watershed segmentation for one (x, y, z) volume shape."""

    def __init__(self, model: UNet3D, params, state,
                 config: SegmentationConfig,
                 vol_shape: Tuple[int, int, int], max_cells: int = 1024,
                 compute_dtype=torch.bfloat16, mesh=None,
                 mesh_mode: str = "tiles", spatial_axis: Optional[str] = None,
                 halo: Optional[int] = None, *, device=None):
        """JAX's constructor (``engine/segmentation.py:49-135``).
        ``device=None`` is the card; with a ``mesh`` (a ``DeviceMesh``,
        ``parallel.make_mesh``) the device is this rank's, and every rank
        of the mesh axis builds the segmenter and calls it with the same
        volumes, each getting the whole result.

        ``mesh_mode="tiles"``: the tile batch is split over the ranks of
        ``spatial_axis`` (default: the mesh's first axis) and gathered;
        every tile's probabilities equal the one-card sweep's.

        ``mesh_mode="halo"``: the whole LCN-normalized volume, zero-padded
        to the pooling grid (x to a multiple of the axis size times the x
        pool factor), is split along x over ``spatial_axis`` (default
        ``"spatial"``) with halo exchange (``parallel.spatial.
        make_spatially_sharded_apply``) and swept in one un-tiled apply per
        rank.  ``halo`` defaults to the model's receptive radius in x
        rounded up to the total x pool factor, which keeps every interior
        voxel exact; a halo off that grid, or wider than a rank's x shard,
        raises ``ValueError``.  JAX's edge band: within ``halo`` voxels of
        the volume's x faces the sweep differs from SAME padding at every
        layer."""
        check_compute_dtype(compute_dtype)
        self.compute_dtype = compute_dtype
        if mesh is not None:
            from ..parallel.mesh import check_mesh, mesh_device
            check_mesh(mesh)
            if device is None:
                device = mesh_device(mesh.device_type)
        self.device = select_device(device)
        self.model = model
        self.params = to_device(params, self.device)
        self.state = to_device(state, self.device)
        self.config = config
        self.vol_shape = tuple(int(s) for s in vol_shape)
        self.max_cells = int(max_cells)
        self.plan = plan_tiles(self.vol_shape, model.tile_shape,
                               config.shrink)
        self.mesh = mesh
        self._predict = self._predict_impl
        if mesh is None:
            return
        from ..parallel import spatial
        if mesh_mode == "tiles":
            tile_fn = spatial.make_tile_parallel_predict(
                self._apply_probs, mesh, self.plan,
                axis=spatial_axis or mesh.mesh_dim_names[0])
            self._predict = lambda raw: tile_fn(
                self.params, self.state, self._normalize(raw))
        elif mesh_mode == "halo":
            self._predict = self._halo_predict(mesh, spatial_axis or
                                               "spatial", halo)
        else:
            raise ValueError(
                f"mesh_mode must be 'tiles' or 'halo', got {mesh_mode!r}")

    def _apply_probs(self, params, state, xb: torch.Tensor) -> torch.Tensor:
        return self.model.apply(params, state, xb,
                                compute_dtype=self.compute_dtype)

    def _normalize(self, image_raw: torch.Tensor) -> torch.Tensor:
        return normalize_image(image_raw, self.config.noise_level,
                               median_stride=MEDIAN_STRIDE)

    def _halo_predict(self, mesh, axis: str, halo: Optional[int]):
        """The halo mode's predict (JAX :86-127)."""
        from ..parallel.mesh import mesh_axis
        from ..parallel.spatial import make_spatially_sharded_apply
        model = self.model
        n_levels = len(model.down_filters)
        tp = model.pool[0] ** n_levels
        axis_size = mesh_axis(mesh, axis).size
        if halo is None:
            r = model.receptive_radius()[0]
            halo = -(-r // tp) * tp
        if halo % tp:
            raise ValueError(
                f"halo must be a multiple of the total x pool factor "
                f"{tp} (pooling-grid alignment), got {halo}")
        self.halo = int(halo)
        xl, yl, zl = self.vol_shape
        mult = axis_size * tp
        shard_x = (xl + ((-xl) % mult)) // axis_size
        if self.halo > shard_x:
            raise ValueError(
                f"halo ({self.halo}) exceeds the per-device x shard "
                f"({shard_x} = padded {xl} / {axis_size} devices): the "
                f"halo slices would clamp.  Use fewer devices on the "
                f"{axis!r} axis, a bigger volume, or a smaller "
                f"pool-aligned halo= (edge-band accuracy tradeoff, see "
                f"the docstring)")
        sharded = make_spatially_sharded_apply(self._apply_probs, mesh,
                                               self.halo, axis=axis)
        # zeros after each axis's end (F.pad takes the last axis first)
        pads = (0, (-zl) % model.pool[2] ** n_levels,
                0, (-yl) % model.pool[1] ** n_levels, 0, (-xl) % mult)

        def predict_halo(image_raw):
            padded = F.pad(self._normalize(image_raw), pads)
            probs = sharded(self.params, self.state, padded[None, ..., None])
            return probs[0, :xl, :yl, :zl, 0]
        return predict_halo

    # ---- stage 1: LCN + tiled U-Net (tracker.py:662-669) -------------------
    def _predict_impl(self, image_raw: torch.Tensor) -> torch.Tensor:
        norm = self._normalize(image_raw)
        tiles = extract_tiles(pad_for_tiles(norm, self.plan), self.plan)
        probs = self.model.apply(self.params, self.state, tiles[..., None],
                                 compute_dtype=self.compute_dtype)
        return stitch_tiles(probs[..., 0], self.plan)

    def predict_cellregions(self, image_raw,
                            cache_path: Optional[Union[str, Path]] = None
                            ) -> torch.Tensor:
        """U-Net probabilities (x, y, z) of a raw volume.  With
        ``cache_path``: read from it when the file exists (float16 as
        float32), else computed and written there as float16; the computed
        probabilities are returned unrounded, as JAX returns them."""
        if cache_path is not None and Path(cache_path).exists():
            return torch.from_numpy(np.load(cache_path).astype(
                np.float32)).to(self.device)
        probs = self._predict(upload_raw(image_raw, self.device))
        if cache_path is not None:
            Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
            np.save(str(cache_path), probs.cpu().numpy().astype(np.float16))
        return probs

    # ---- stage 2: watershed (tracker.py:671-684) ----------------------------
    def _watershed_impl(self, image_cell_bg: torch.Tensor, method: str):
        cfg = self.config
        ws2d, _ = watershed_2d(image_cell_bg,
                               min_distance=cfg.min_distance_2d)
        _, labels_clear, min_size, cell_num = watershed_3d(
            ws2d, samplingrate=(1.0, 1.0, cfg.z_xy_ratio), method=method,
            min_size=cfg.min_size, cell_num=cfg.cell_num,
            min_distance=cfg.min_distance_3d, max_labels=self.max_cells)
        # the reference keeps the WITH-border labels and relabels them
        # sequentially (tracker.py:677-680)
        seg = relabel_sequential(labels_clear)
        com = center_of_mass((seg > 0).to(torch.float32), seg,
                             self.max_cells)
        return seg, com, min_size, cell_num

    # ---- full per-volume segmentation (tracker.py:605-650) ------------------
    def segment(self, image_raw, method: str = "min_size",
                cache_path: Optional[Union[str, Path]] = None) -> SegResult:
        """Segment one raw (x, y, z) volume; ``cache_path``: the U-Net
        cache file of this volume (:meth:`predict_cellregions`)."""
        if method == "cell_num" and not self.config.cell_num:
            raise ValueError(
                "method='cell_num' requires a positive cell_num — "
                "segment volume 1 with method='min_size' first (it learns "
                "cell_num, tracker.py:682-683) or set it in the config")
        raw = upload_raw(image_raw, self.device)
        probs = self.predict_cellregions(raw, cache_path)
        if float(torch.max(probs)) <= 0.5:
            raise ValueError(
                "No cell was detected by 3D U-Net! Try to reduce the "
                "noise_level.")
        seg, com, min_size, cell_num = self._watershed_impl(probs, method)
        # adopt the adaptive values the watershed derived, as the reference
        # stores them (tracker.py:681-683): min_size always, cell_num only
        # when the min_size method counted the cells
        self.config = dataclasses.replace(
            self.config, min_size=int(min_size),
            cell_num=int(cell_num) if method == "min_size"
            else self.config.cell_num)
        n = int(seg.max())
        if n == 0:
            raise ValueError(
                "No cell was detected by watershed! Try to reduce the "
                "min_size.")
        centers = com[:n]
        zr = torch.tensor([1.0, 1.0, self.config.z_xy_ratio],
                          dtype=torch.float64, device=self.device)
        # numpy's raw / 65536.0: float64 for integer volumes
        gcn = raw.to(torch.float64 if not raw.is_floating_point()
                     else raw.dtype) / 65536.0
        return SegResult(image_cell_bg=probs, l_center_coordinates=centers,
                         segmentation_auto=seg, image_gcn=gcn,
                         r_coordinates_segment=centers.double() * zr)
