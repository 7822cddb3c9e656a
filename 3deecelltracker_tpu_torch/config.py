"""Typed configuration for the PyTorch port: the stage configs the
segment-and-track main path, the legacy U-Net path and the FFN trainer
read, with the same fields and defaults as ``3deecelltracker_tpu/config.py``
so one config describes both packages."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LcnConfig:
    """Local contrast normalization (reference ``preprocess.py:85-188``);
    ``padding`` 'zero' is the published GPU path's (Conv3D 'same'),
    'reflect' the CPU path's."""
    noise_level: float = 5.0
    filter_size: Tuple[int, int, int] = (27, 27, 1)
    padding: str = "zero"  # 'zero' | 'reflect'


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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The mesh's layout for work over several cards
    (``parallel.make_mesh_from_config``; the reference runs on one GPU)."""
    data_axis: str = "data"
    spatial_axis: str = "spatial"
    data_parallel: int = 1
    spatial_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class TrainUnetConfig:
    """U-Net trainer (reference ``unet3d.py:346-601``)."""
    batch_size: int = 8
    steps_per_epoch: int = 60
    learning_rate: float = 1e-3
    rotation_range: float = 90.0
    shift_range: float = 0.2
    shear_range: float = 0.2
    horizontal_flip: bool = True


@dataclasses.dataclass(frozen=True)
class TrainFfnConfig:
    """FFN trainer (reference ``ffn.py:17-26``, ``synthesize.py``)."""
    batch_size: int = 128
    iterations_per_epoch: int = 5000
    learning_rate: float = 1e-3
    affine_level: float = 0.2
    random_movement_level: float = 0.001
    ratio_seg_error: float = 0.15
    kde_bandwidth: float = 0.1
    num_sets: int = 20
