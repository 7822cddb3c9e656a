"""Trimmed mean, the ensemble's combine (counterpart of
``3deecelltracker_tpu/ops/trim.py``): ``scipy.stats.trim_mean`` semantics,
one sort, slice and mean along the axis."""

from __future__ import annotations

import torch


def trim_mean(a: torch.Tensor, proportiontocut: float = 0.1,
              axis: int = 0) -> torch.Tensor:
    """Mean of ``a`` along ``axis`` after cutting ``int(proportiontocut *
    n)`` values from each end of the sorted axis (scipy floors the cut)."""
    n = a.shape[axis]
    lowercut = int(proportiontocut * n)
    uppercut = n - lowercut
    if lowercut >= uppercut:
        raise ValueError("proportiontocut too big")
    s, _ = torch.sort(a, dim=axis)
    return torch.mean(s.narrow(axis, lowercut, uppercut - lowercut),
                      dim=axis)
