"""Point-set normalisation (counterpart of
``3deecelltracker_tpu/ops/pointset.py``): centre at the mean, scale by 3x
the std of the first-principal-component projection."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import numerics


def normalize_points(points: torch.Tensor,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor,
                                Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (normalized points, (mean, scale))."""
    if mask is None:
        mask = torch.ones(points.shape[0], dtype=torch.bool,
                          device=points.device)
    w = mask.to(torch.float32)
    n = torch.sum(w)
    mean = torch.sum(points * w[:, None], dim=0) / n
    centered = (points - mean) * w[:, None]
    cov = (centered.T @ centered) / n
    eigvals = torch.linalg.eigvalsh(cov)
    std = numerics.sqrt(torch.clamp_min(eigvals[-1], 0.0))
    scale = 3.0 * std
    return (points - mean) / scale, (mean, scale)
