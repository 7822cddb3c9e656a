"""Separable gaussian blur (counterpart of
``3deecelltracker_tpu/ops/filters.py::gaussian_filter``), as the subregion
atlas uses it: zero padding only."""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F


TRUNCATE = 4.0   # kernel radius in sigmas, scipy's default


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """The discrete gaussian kernel scipy.ndimage uses."""
    radius = int(TRUNCATE * float(sigma) + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv_1d_along_axis(x: torch.Tensor, kernel: np.ndarray,
                        axis: int) -> torch.Tensor:
    """Correlate with a symmetric kernel along ``axis``, zero padding."""
    k = kernel.shape[0]
    moved = x.movedim(axis, -1)
    shape = moved.shape
    flat = F.pad(moved.reshape(-1, shape[-1]), (k // 2, k // 2))
    filt = torch.from_numpy(kernel).to(x.device).reshape(1, 1, k)
    out = F.conv1d(flat[:, None, :], filt)[:, 0]
    return out.reshape(shape).movedim(-1, axis)


def gaussian_filter(x: torch.Tensor,
                    sigma: Union[float, Sequence[float]],
                    batch_ndim: int = 0) -> torch.Tensor:
    """Separable gaussian blur matching ``scipy.ndimage.gaussian_filter``
    with ``mode='constant'`` (the JAX package's ``mode="zero"``, the only
    mode the subregion atlas uses); the first ``batch_ndim`` axes are
    independent (not blurred)."""
    nd = x.dim() - batch_ndim
    if np.isscalar(sigma):
        sigmas = (float(sigma),) * nd
    else:
        sigmas = tuple(float(s) for s in sigma)
        if len(sigmas) != nd:
            raise ValueError("sigma must be scalar or one per axis")
    out = x.to(torch.float32)
    for i, s in enumerate(sigmas):
        if s <= 0:
            continue
        kern = gaussian_kernel_1d(s)
        if kern.shape[0] <= 1:
            continue
        out = _conv_1d_along_axis(out, kern, batch_ndim + i)
    return out
