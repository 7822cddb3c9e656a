"""Box means and separable gaussian blur (counterpart of
``3deecelltracker_tpu/ops/filters.py``: ``box_sum``, ``box_mean``,
``gaussian_filter``), with zero padding only: the mode the LCN, the
subregion atlas and the legacy watersheds use."""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F


TRUNCATE = 4.0   # kernel radius in sigmas, scipy's default


def box_sum(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Sliding-window sum with a centred ``size`` window per axis, zero
    padding (scipy ``convolve`` with an all-ones kernel; even sizes take the
    extra element on the right): a cumulative sum per axis and the
    difference of two of its entries, as in the JAX package.  The sums run
    in float64 and round once to float32 at the end: the JAX twin's float32
    running sum is sequential on the CPU, a CUDA scan sums in another order,
    and float64 keeps both within JAX's own float32 error of the exact
    window sum."""
    out = x.to(torch.float64)
    for axis, k in enumerate(size):
        k = int(k)
        if k <= 1:
            continue
        lo, hi = (k - 1) // 2, k // 2
        n = out.shape[axis]
        pad = [0, 0] * out.dim()
        pad[2 * (out.dim() - 1 - axis):2 * (out.dim() - axis)] = [lo + 1, hi]
        # one extra leading zero: csum[i + k] - csum[i] is the window at i
        csum = torch.cumsum(F.pad(out, pad), dim=axis)
        out = csum.narrow(axis, k, n) - csum.narrow(axis, 0, n)
    return out.to(torch.float32)


def box_mean(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``box_sum`` over the window volume (a true float32 division: a
    python-scalar divisor may become a reciprocal multiply on the card)."""
    vol = torch.tensor(float(math.prod(int(k) for k in size)),
                       dtype=torch.float32, device=x.device)
    return box_sum(x, size) / vol


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
