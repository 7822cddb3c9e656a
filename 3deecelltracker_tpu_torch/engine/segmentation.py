"""U-Net segmentation engine of the legacy path: volume -> cell instances ->
centres (counterpart of ``3deecelltracker_tpu/engine/segmentation.py``:
``SegResult``, ``UNetSegmenter``, single device).

Per volume: LCN (strided median), reflect-pad, the whole tile batch through
the U-Net in one forward, stitch; then the per-z 2-D watershed, the 3-D
watershed with size filtering, sequential relabelling and centres of mass.
Everything stays on the device; the host reads the probability maximum, the
adaptive ``min_size``/``cell_num`` and the cell count.  The U-Net computes in
float32 (the JAX default is bfloat16); the on-disk ``unet_cache`` is not
part of this array-level port.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..config import SegmentationConfig
from ..models.unet3d import UNet3D
from ..ops.connected import relabel_sequential
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
                 device=None):
        self.device = select_device(device)
        self.model = model
        self.params = to_device(params, self.device)
        self.state = to_device(state, self.device)
        self.config = config
        self.vol_shape = tuple(int(s) for s in vol_shape)
        self.max_cells = int(max_cells)
        self.plan = plan_tiles(self.vol_shape, model.tile_shape,
                               config.shrink)

    # ---- stage 1: LCN + tiled U-Net (tracker.py:662-669) -------------------
    def _predict_impl(self, image_raw: torch.Tensor) -> torch.Tensor:
        norm = normalize_image(image_raw, self.config.noise_level,
                               median_stride=MEDIAN_STRIDE)
        tiles = extract_tiles(pad_for_tiles(norm, self.plan), self.plan)
        probs = self.model.apply(self.params, self.state, tiles[..., None])
        return stitch_tiles(probs[..., 0], self.plan)

    def predict_cellregions(self, image_raw) -> torch.Tensor:
        """U-Net probabilities (x, y, z) of a raw volume."""
        return self._predict_impl(upload_raw(image_raw, self.device))

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
    def segment(self, image_raw, method: str = "min_size") -> SegResult:
        if method == "cell_num" and not self.config.cell_num:
            raise ValueError(
                "method='cell_num' requires a positive cell_num — "
                "segment volume 1 with method='min_size' first (it learns "
                "cell_num, tracker.py:682-683) or set it in the config")
        raw = upload_raw(image_raw, self.device)
        probs = self._predict_impl(raw)
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
