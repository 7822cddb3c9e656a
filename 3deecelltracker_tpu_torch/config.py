"""Typed configuration for the PyTorch port: the stage configs the
segment-and-track main path and the legacy U-Net path read, with the same
fields and defaults as ``3deecelltracker_tpu/config.py`` so one config
describes both packages."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """U-Net + watershed segmentation (reference ``tracker.py:854-887``)."""
    noise_level: float = 5.0
    min_size: int = 100
    cell_num: int = 0                      # 0 => use min_size criterion
    z_xy_ratio: float = 1.0                # anisotropy of the raw grid
    z_scaling: int = 10                    # interpolation factor along z
    shrink: Tuple[int, int, int] = (24, 24, 2)   # tiled-inference border
    min_distance_2d: int = 7
    min_distance_3d: int = 3
    probability_threshold: float = 0.5


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """TrackerLite-level knobs (reference ``trackerlite.py:29-30``,
    ``tracker.py:45-48``)."""
    beta: float = 3.0
    lambda_: float = 3.0
    max_iteration: int = 2000
    k_neighbors: int = 20
    ensemble: bool = False
    sampling_number: int = 20
    adjacent: bool = False
    trim_proportion: float = 0.1
    boundary_xy: int = 6
    max_correction_reps: int = 20
    correction_epsilon_voxels: float = 0.5
    m_step_refine: int = 0


@dataclasses.dataclass(frozen=True)
class StarDistConfig:
    """StarDist3D model config (reference ``stardistwrapper.py:213-259``)."""
    n_rays: int = 96
    grid: Tuple[int, int, int] = (2, 1, 1)
    anisotropy: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    unet_n_depth: int = 2
    unet_pool: Tuple[int, int, int] = (2, 2, 2)
    unet_n_filter_base: int = 32
    unet_n_conv_per_depth: int = 2
    unet_kernel_size: Tuple[int, int, int] = (3, 3, 3)
    net_conv_after_unet: int = 128
    n_channel_in: int = 1
    train_patch_size: Tuple[int, int, int] = (48, 96, 96)
    prob_thresh: float = 0.5
    nms_thresh: float = 0.3
    backbone: str = "unet"
