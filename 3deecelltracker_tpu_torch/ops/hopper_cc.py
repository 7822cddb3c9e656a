"""Connected components with full box connectivity: the CUDA kernel wrapper
and its plain version.

``cc_label`` replaces ``3deecelltracker_tpu/ops/pallas_kernels.py::
cc_propagate`` (body ``_cc_kernel``), whose math is ``ops/connected.py::
label_components_raw`` with full connectivity: every foreground voxel gets
the 1-based flat index of its component's smallest voxel, background 0.
Two modes on an (x, y, z) volume: the whole volume with 26-connectivity, or
each z-slice alone with 8-connectivity and slice-local indices
(``per_slice=True``, the JAX ``vmap`` over z of ``watershed_2d``).  On a
CUDA tensor it launches ``csrc/cc.cu`` (an atomic union-find; design and
bound in that file); on a CPU tensor it runs
:func:`label_components_raw_plain`, the JAX loop.  There is no fallback
between the two.  Both run to the fixed point, so the two devices give one
answer; the JAX loop stops after ``max_iters`` = 256 hook rounds, which the
masks of the legacy path never reach.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..utils import cuda_build
from .neighborhood import neighbor_offsets, shift

_BIG = torch.iinfo(torch.int32).max
CHECK_EVERY = 4   # loop bodies between host convergence checks


def _box_min(labels: torch.Tensor, axes) -> torch.Tensor:
    """Min over the 3-wide box along ``axes`` (fill int32 max outside), one
    axis at a time: the JAX ``reduce_window`` min, exact for integers."""
    out = labels
    for axis in axes:
        plus = [0] * labels.dim()
        minus = [0] * labels.dim()
        plus[axis], minus[axis] = 1, -1
        out = torch.minimum(out, torch.minimum(shift(out, plus, _BIG),
                                               shift(out, minus, _BIG)))
    return out


def label_components_raw_plain(mask: torch.Tensor,
                               connectivity: Optional[int] = None,
                               per_slice: bool = False) -> torch.Tensor:
    """The JAX loop (``ops/connected.py:30-83``) in PyTorch: 1-based flat
    indices, min-propagated by four hook rounds per pointer jump until
    nothing changes (no round cap, unlike the JAX loop's 256).
    ``per_slice``: the last axis is a batch axis and each slice is labeled
    alone (slice-local indices, connectivity counted over the slice's
    axes)."""
    m = mask.movedim(-1, 0) if per_slice else mask[None]
    spatial = m.shape[1:]
    ndim = len(spatial)
    conn = ndim if connectivity is None else int(connectivity)
    fg = m != 0
    n = math.prod(spatial)
    init = torch.arange(1, n + 1, dtype=torch.int32,
                        device=m.device).reshape((1,) + tuple(spatial))
    labels = torch.where(fg, init, _BIG)
    axes = range(1, ndim + 1)
    if conn == ndim:
        def hook(lab):
            return torch.where(fg, _box_min(lab, axes), _BIG)
    else:
        offsets = [(0,) + o for o in neighbor_offsets(ndim, conn)]

        def hook(lab):
            best = lab
            for off in offsets:
                best = torch.minimum(best, shift(lab, off, _BIG))
            return torch.where(fg, torch.minimum(lab, best), _BIG)

    def jump(lab):
        flat = lab.reshape(lab.shape[0], -1)
        idx = torch.clamp(flat.long() - 1, 0, n - 1)
        parent = torch.where(flat == _BIG, _BIG, torch.gather(flat, 1, idx))
        return parent.reshape(lab.shape)

    while True:
        changed = []
        for _ in range(CHECK_EVERY):
            new = jump(hook(hook(hook(hook(labels)))))
            changed.append((new != labels).any())
            labels = new
        if not bool(torch.stack(changed).all()):
            break
    out = torch.where(fg, labels, 0).to(torch.int32)
    return out.movedim(0, -1) if per_slice else out[0]


def _check(mask: torch.Tensor, per_slice: bool) -> None:
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if per_slice and mask.dim() != 3:
        raise ValueError(f"per-slice mode needs an (x, y, z) volume, got "
                         f"{tuple(mask.shape)}")
    if not 1 <= mask.dim() <= 3:
        raise ValueError(f"cc_label takes 1 to 3 axes, got "
                         f"{tuple(mask.shape)}")
    if mask.numel() >= 2 ** 31:
        raise ValueError("cc_label indexes voxels with int32")


def _launch(mask: torch.Tensor, per_slice: bool) -> torch.Tensor:
    lib = cuda_build.load("cc")
    fn = lib.cc_label_u8
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shape3 = tuple(mask.shape) + (1,) * (3 - mask.dim())
    m = mask.contiguous().view(torch.uint8)
    parent = torch.empty(shape3, dtype=torch.int32, device=mask.device)
    out = torch.empty(shape3, dtype=torch.int32, device=mask.device)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    err = fn(m.data_ptr(), parent.data_ptr(), out.data_ptr(), *shape3,
             int(per_slice), stream)
    cuda_build.check(err, "cc_label")
    cc_label.launches += 1
    return out.reshape(mask.shape)


def cc_label(mask: torch.Tensor, per_slice: bool = False) -> torch.Tensor:
    """Full-connectivity component labels of a bool volume (1 to 3 axes;
    ``per_slice`` needs (x, y, z)), to the fixed point.  CUDA tensors
    launch the kernel (counted in ``cc_label.launches``); CPU tensors take
    :func:`label_components_raw_plain`."""
    _check(mask, per_slice)
    if mask.device.type == "cpu":
        return label_components_raw_plain(mask, None, per_slice)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    return _launch(mask, per_slice)


cc_label.launches = 0
