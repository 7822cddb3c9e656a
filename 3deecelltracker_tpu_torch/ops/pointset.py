"""Point-set normalisation (counterpart of
``3deecelltracker_tpu/ops/pointset.py``: ``normalize_points``,
``apply_normalization``, ``invert_normalization``): centre at the mean,
scale by 3x the std of the first-principal-component projection.  A
leading member axis ((E, n, 3) points) normalizes each member on its
own."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import numerics


def normalize_points(points: torch.Tensor,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor,
                                Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (normalized points, (mean, scale)): mean (..., 3) and
    scale (...) per member."""
    if mask is None:
        mask = torch.ones(points.shape[:-1], dtype=torch.bool,
                          device=points.device)
    w = mask.to(torch.float32)[..., None]
    n = torch.sum(w, dim=-2)
    # the sums in float64, rounded once: with a member axis the f32 sums'
    # order would differ from the member's own, and the EM after them
    # amplifies an ulp of the mean or scale to ~1e-3 real units
    mean = (torch.sum((points * w).double(), dim=-2) / n).to(points.dtype)
    centered = ((points - mean[..., None, :]) * w).double()
    cov = ((centered.mT @ centered) / n[..., None]).to(points.dtype)
    eigvals = torch.linalg.eigvalsh(cov)
    std = numerics.sqrt(torch.clamp_min(eigvals[..., -1], 0.0))
    scale = 3.0 * std
    return ((points - mean[..., None, :]) / scale[..., None, None],
            (mean, scale))


def apply_normalization(points: torch.Tensor, mean: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """``points`` in the frame of a :func:`normalize_points` result."""
    return (points - mean) / scale


def invert_normalization(points: torch.Tensor, mean: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """Normalized ``points`` back in the original frame."""
    return points * scale + mean
