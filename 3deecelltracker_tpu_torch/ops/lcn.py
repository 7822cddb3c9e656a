"""Local contrast normalization (counterpart of
``3deecelltracker_tpu/ops/lcn.py``: ``lcn``, ``_lcn_impl``,
``normalize_image``), zero padding: the reference GPU path and the legacy
U-Net segmenter's setting."""

from __future__ import annotations

from typing import Tuple

import torch

from . import numerics
from .filters import box_mean


def lcn(img3d: torch.Tensor, noise_level: float = 5.0,
        filter_size: Tuple[int, int, int] = (27, 27, 1)) -> torch.Tensor:
    """(x - mean_w(x)) / (sqrt(mean_w((x - mean_w(x))^2)) + noise_level),
    mean_w a box average over ``filter_size`` that divides by the full
    window volume at the borders too (zero padding)."""
    return _lcn_impl(img3d, noise_level, filter_size)


def _lcn_impl(img3d: torch.Tensor, noise_level: float,
              filter_size: Tuple[int, int, int]) -> torch.Tensor:
    x = img3d.to(torch.float32)
    avg = box_mean(x, filter_size)
    diff = x - avg
    std = numerics.sqrt(box_mean(diff * diff, filter_size))
    noise = torch.tensor(noise_level, dtype=torch.float32, device=x.device)
    return diff / (std + noise)


def median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: for an even count the midpoint of
    the two middle values, ``(lo + hi) * 0.5`` in the input's type
    (``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def normalize_image(image: torch.Tensor, noise_level: float,
                    filter_size: Tuple[int, int, int] = (27, 27, 1),
                    median_stride: int = 1) -> torch.Tensor:
    """Median-subtract, clip at zero, then LCN (``preprocess.py:170-188``).
    ``median_stride`` > 1 takes the median of a strided 1-in-n sample of
    the flattened volume (the segmenter uses 61)."""
    x = image.to(torch.float32)
    med = median_midpoint(x.reshape(-1)[::median_stride])
    return lcn(torch.clamp_min(x - med, 0.0), noise_level, filter_size)
