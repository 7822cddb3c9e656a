"""Box means and separable gaussian blur (counterpart of
``3deecelltracker_tpu/ops/filters.py``: ``box_sum``, ``box_mean``,
``uniform_filter``, ``gaussian_kernel_1d``, ``gaussian_filter``).  The box
filters take zero padding (the LCN's and the atlas's default) or scipy's
``"reflect"`` edges; the gaussian blur takes JAX's three modes, scipy's
``"reflect"`` by default, ``"zero"`` (what the subregion atlas and the
legacy watersheds pass) and ``"mirror"``."""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F


TRUNCATE = 4.0   # kernel radius in sigmas, scipy's default


def box_sum(x: torch.Tensor, size: Sequence[int],
            mode: str = "zero") -> torch.Tensor:
    """Sliding-window sum with a centred ``size`` window per axis (scipy
    ``convolve`` with an all-ones kernel; even sizes take the extra element
    on the right), past the edges ``mode``: ``"zero"``, or scipy's
    ``"reflect"`` (the edge value repeated).  A cumulative sum per axis and
    the difference of two of its entries, as in the JAX package.  The sums run
    in float64 and round once to float32 at the end: the JAX twin's float32
    running sum is sequential on the CPU, a CUDA scan sums in another order,
    and float64 keeps both within JAX's own float32 error of the exact
    window sum."""
    if mode not in ("zero", "reflect"):
        raise ValueError(f"unknown padding mode {mode!r}")
    out = x.to(torch.float64)
    for axis, k in enumerate(size):
        k = int(k)
        if k <= 1:
            continue
        lo, hi = (k - 1) // 2, k // 2
        n = out.shape[axis]
        if mode == "reflect":       # zeros below
            out = _pad_index(out, axis, lo, hi, mode)
            lo = hi = 0
        pad = [0, 0] * out.dim()
        pad[2 * (out.dim() - 1 - axis):2 * (out.dim() - axis)] = [lo + 1, hi]
        # one extra leading zero: csum[i + k] - csum[i] is the window at i
        csum = torch.cumsum(F.pad(out, pad), dim=axis)
        out = csum.narrow(axis, k, n) - csum.narrow(axis, 0, n)
    return out.to(torch.float32)


def box_mean(x: torch.Tensor, size: Sequence[int],
             mode: str = "zero") -> torch.Tensor:
    """``box_sum`` over the window volume (a true float32 division: a
    python-scalar divisor may become a reciprocal multiply on the card)."""
    vol = torch.tensor(float(math.prod(int(k) for k in size)),
                       dtype=torch.float32, device=x.device)
    return box_sum(x, size, mode) / vol


def uniform_filter(x: torch.Tensor, size: Sequence[int],
                   mode: str = "reflect") -> torch.Tensor:
    """Mean filter (``scipy.ndimage.uniform_filter`` semantics)."""
    return box_mean(x, size, mode)


def _pad_index(x: torch.Tensor, axis: int, lo: int, hi: int,
               mode: str) -> torch.Tensor:
    """``x`` extended by ``lo`` and ``hi`` entries along ``axis`` past its
    edges as JAX's ``_pad_1d`` does: scipy's ``"reflect"`` is numpy's
    ``"symmetric"`` (the edge value repeated), ``"mirror"`` numpy's
    ``"reflect"``; one gather of numpy's index padding, so pads longer than
    the axis fold back as numpy folds them."""
    np_mode = {"reflect": "symmetric", "mirror": "reflect"}[mode]
    idx = np.pad(np.arange(x.shape[axis]), (lo, hi), mode=np_mode)
    return torch.index_select(x, axis, torch.from_numpy(idx).to(x.device))


def gaussian_kernel_1d(sigma: float, truncate: float = TRUNCATE
                       ) -> np.ndarray:
    """The discrete gaussian kernel scipy.ndimage uses, of radius
    ``int(truncate * sigma + 0.5)``."""
    radius = int(truncate * float(sigma) + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv_1d_along_axis(x: torch.Tensor, kernel: np.ndarray, axis: int,
                        mode: str) -> torch.Tensor:
    """Correlate with a symmetric kernel along ``axis``, padded by
    ``mode``."""
    k = kernel.shape[0]
    r = k // 2
    if mode != "zero":
        x = _pad_index(x, axis, r, r, mode)
    moved = x.movedim(axis, -1)
    shape = moved.shape
    flat = moved.reshape(-1, shape[-1])
    if mode == "zero":
        flat = F.pad(flat, (r, r))
    filt = torch.from_numpy(kernel).to(x.device).reshape(1, 1, k)
    out = F.conv1d(flat[:, None, :], filt)[:, 0]
    return out.reshape(shape[:-1] + (out.shape[-1],)).movedim(-1, axis)


def gaussian_filter(x: torch.Tensor,
                    sigma: Union[float, Sequence[float]],
                    mode: str = "reflect", truncate: float = TRUNCATE, *,
                    batch_ndim: int = 0) -> torch.Tensor:
    """Separable gaussian blur matching ``scipy.ndimage.gaussian_filter``
    (JAX ``ops/filters.py:103-126``).  ``mode``: ``"reflect"`` (scipy's
    default), ``"zero"`` (scipy's ``"constant"``) or ``"mirror"``;
    ``truncate``: the kernel radius in sigmas.  The first ``batch_ndim``
    axes are independent (not blurred; the JAX package vmaps instead)."""
    if mode not in ("zero", "reflect", "mirror"):
        raise ValueError(f"unknown padding mode {mode!r}")
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
        kern = gaussian_kernel_1d(s, truncate)
        if kern.shape[0] <= 1:
            continue
        out = _conv_1d_along_axis(out, kern, batch_ndim + i, mode)
    return out
