"""Connected components with full box connectivity: the CUDA kernel wrapper
and its plain version.

``cc_label`` replaces ``3deecelltracker_tpu/ops/pallas_kernels.py::
cc_propagate`` (body ``_cc_kernel``), whose math is ``ops/connected.py::
label_components_raw`` with full connectivity: every foreground voxel gets
the 1-based flat index of its component's smallest voxel, background 0.
Two modes on an (x, y, z) volume: the whole volume with 26-connectivity, or
each z-slice alone with 8-connectivity and slice-local indices
(``per_slice=True``, the JAX ``vmap`` over z of ``watershed_2d``).  On a
CUDA tensor it launches ``csrc/cc.cu`` once per call (a union-find in one
cooperative launch, tiles of :func:`tile_plan` labeled in shared memory;
design and bound in that file); on a CPU tensor it runs
:func:`label_components_raw_plain`, the JAX loop.  There is no fallback
between the two.  Both run to the fixed point, so the two devices give one
answer; the JAX loop stops after ``max_iters`` = 256 hook rounds, which the
masks of the legacy path never reach.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ..utils import cuda_build
from .neighborhood import neighbor_offsets, shift

_BIG = torch.iinfo(torch.int32).max
CHECK_EVERY = 4   # loop bodies between host convergence checks
# csrc/cc.cu's tiles: the most voxels its shared arrays hold, the fewest a
# tile gets (one a thread of a block), and the longest run of z it takes
TILE_MAX = 4096
TILE_MIN = 256
TILE_Z_MAX = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_LABEL_ARGS = [_P, _P] + [_I] * 9 + [_P]


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


def tile_box(shape: Tuple[int, int, int], voxels: int
             ) -> Tuple[int, int, int]:
    """The tile box ``(tx, ty, tz)`` of at most ``voxels`` voxels for an
    (x, y, z) volume: all of z up to ``TILE_Z_MAX`` (the contiguous axis,
    so a tile's rows are whole), then a patch of (x, y) near a square, ty a
    power of two."""
    x, y, z = shape
    tz = max(1, min(z, TILE_Z_MAX, voxels))
    area = max(1, voxels // tz)
    ty = min(y, 1 << (math.isqrt(area).bit_length() - 1))
    tx = min(x, area // ty)
    return tx, min(y, area // tx), tz


@functools.lru_cache(maxsize=64)
def tile_plan(shape: Tuple[int, int, int], resident: int,
              tile_max: int = TILE_MAX
              ) -> Tuple[Tuple[int, int, int], int]:
    """``((tx, ty, tz), n_tiles)``: the tiles of ``csrc/cc.cu`` for an (x,
    y, z) volume, the same in both modes, and how many cover it (those at
    the far faces cut to the volume).  The smallest tiles of at least
    ``TILE_MIN`` voxels that ``resident`` blocks (the card's, at once) can
    take one each, so every block keeps its tile in shared memory through
    the launch; where even ``tile_max``-voxel tiles outnumber them, those,
    several a block."""
    n = math.prod(shape)
    voxels = min(tile_max, max(TILE_MIN, -(-n // resident)))
    while True:
        tx, ty, tz = tile_box(shape, voxels)
        n_tiles = -(-shape[0] // tx) * -(-shape[1] // ty) * -(-shape[2] // tz)
        if n_tiles <= resident or voxels == tile_max:
            return (tx, ty, tz), n_tiles
        voxels = min(tile_max, voxels + max(1, voxels // 16))


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


@functools.lru_cache(maxsize=64)
def _launch_args(shape3: Tuple[int, int, int], per_slice: bool,
                 device_index: int, tile_max: int) -> Tuple[int, ...]:
    """The kernel's size arguments for one volume shape, worked out once:
    (X, Y, Z, tx, ty, tz, per_slice, blocks)."""
    resident = cuda_build.resident_blocks(
        "cc", "cc_blocks_per_sm", torch.device("cuda", device_index))
    box, n_tiles = tile_plan(shape3, resident, tile_max)
    return shape3 + box + (int(per_slice), min(n_tiles, resident))


def _launch(mask: torch.Tensor, per_slice: bool,
            phases: int = 3) -> torch.Tensor:
    """One launch of the kernel; ``phases`` < 3 stops it early (its output
    is then no labeling: ``chip_smoke.py`` times the phases with it)."""
    shape3 = tuple(mask.shape) + (1,) * (3 - mask.dim())
    out = torch.empty(shape3, dtype=torch.int32, device=mask.device)
    if out.numel() == 0:
        return out.reshape(mask.shape)
    m = mask if mask.is_contiguous() else mask.contiguous()
    err = cuda_build.function("cc", "cc_label_u8", _LABEL_ARGS)(
        m.data_ptr(), out.data_ptr(),
        *_launch_args(shape3, per_slice, mask.device.index, TILE_MAX),
        phases, cuda_build.raw_stream(mask))
    cuda_build.check(err, "cc_label")
    cc_label.launches += 1
    return out.reshape(mask.shape)


def cc_label(mask: torch.Tensor, per_slice: bool = False) -> torch.Tensor:
    """Full-connectivity component labels of a bool volume (1 to 3 axes;
    ``per_slice`` needs (x, y, z)), to the fixed point.  CUDA tensors
    launch the kernel once per call (counted in ``cc_label.launches``; an
    empty mask launches nothing); CPU tensors take
    :func:`label_components_raw_plain`."""
    _check(mask, per_slice)
    if mask.device.type == "cpu":
        return label_components_raw_plain(mask, None, per_slice)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    return _launch(mask, per_slice)


cc_label.launches = 0
