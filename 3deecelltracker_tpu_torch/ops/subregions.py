"""Cell subregion atlas and label synthesis (counterpart of
``3deecelltracker_tpu/ops/subregions.py``: ``SubregionAtlas``,
``build_subregion_atlas``, ``move_cells_full``, ``move_cells_sampled``).

Every cell gets one fixed-size box, zero outside its true bbox; boxes are
z-repeated by the interpolation factor, gaussian-blurred and thresholded at
the cell's occupancy percentile.  Moving cells pastes only the box planes
that land on the original z slices, all cells in one scatter: a sum of ids
where cells overlap (``overlap_mode="add"``, the default) or the reference's
id-order last write (``"last"``), with cells pushed past the canvas clamped
into it (``out_of_range="clip"``) or dropped as the reference drops them
(``"drop"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .filters import gaussian_filter
from .segment_reduce import find_objects_bounds


@dataclasses.dataclass(frozen=True)
class SubregionAtlas:
    """boxes (n, BX, BY, BZ*f) bool; origins (n, 3) int32 interp-frame box
    corners (x, y, z*f); valid (n,) bool; image_shape is the original
    (x, y, z)."""
    boxes: torch.Tensor
    origins: torch.Tensor
    valid: torch.Tensor
    interpolation_factor: int
    image_shape: Tuple[int, int, int]

    @property
    def n_cells(self) -> int:
        return self.boxes.shape[0]

    @property
    def box_shape(self) -> Tuple[int, int, int]:
        return tuple(self.boxes.shape[1:])


def _percentile_threshold(values: torch.Tensor, n_real: torch.Tensor,
                          q: torch.Tensor) -> torch.Tensor:
    """Per row: np.percentile(values[:n_real], q), linear interpolation;
    entries beyond n_real must be +inf.  values (n, V); n_real, q (n,)."""
    v = torch.sort(values, dim=1).values
    rank = q / 100.0 * (n_real.to(torch.float32) - 1.0)
    lo = torch.floor(rank).long()
    hi = torch.ceil(rank).long()
    frac = rank - lo.to(torch.float32)
    v_lo = v.gather(1, lo[:, None])[:, 0]
    v_hi = v.gather(1, hi[:, None])[:, 0]
    return v_lo * (1.0 - frac) + v_hi * frac


def build_subregion_atlas(label_image: torch.Tensor, n_cells: int,
                          box_shape: Tuple[int, int, int],
                          interpolation_factor: int = 10,
                          smooth_sigma: float = 2.5) -> SubregionAtlas:
    """Atlas of a labeled (x, y, z) volume; ``box_shape`` in original z
    units (stored boxes are ``box_shape[2] * f`` deep)."""
    dev = label_image.device
    f = int(interpolation_factor)
    box = torch.tensor(box_shape, dtype=torch.int32, device=dev)
    shape = torch.tensor(label_image.shape, dtype=torch.int32, device=dev)
    mins, maxs = find_objects_bounds(label_image, n_cells)
    valid = maxs[:, 0] >= mins[:, 0]
    origins_raw = torch.where(valid[:, None], mins, 0)
    starts = torch.clamp_min(torch.minimum(origins_raw, shape - box), 0)
    deltas = origins_raw - starts
    # crop each cell's box at the clamped start, rolled back so the cell
    # sits at box offset 0
    idx = [(starts[:, a, None] + (torch.arange(box_shape[a], device=dev)
                                  [None, :] + deltas[:, a, None])
            % box_shape[a]).long() for a in range(3)]
    crop = label_image[idx[0][:, :, None, None], idx[1][:, None, :, None],
                       idx[2][:, None, None, :]]
    cell_ids = torch.arange(1, n_cells + 1, device=dev)[:, None, None, None]
    sub = (crop == cell_ids).to(torch.float32)
    ext = torch.minimum(maxs - mins + 1, box)                    # (n, 3)
    grids = [torch.arange(box_shape[a], device=dev) for a in range(3)]
    in_ext = ((grids[0][None, :, None, None] < ext[:, 0, None, None, None])
              & (grids[1][None, None, :, None] < ext[:, 1, None, None, None])
              & (grids[2][None, None, None, :] < ext[:, 2, None, None, None]))
    sub = sub * in_ext
    n_real_orig = ext[:, 0] * ext[:, 1] * ext[:, 2]
    nnz = torch.sum(sub, dim=(1, 2, 3))
    percentage = 1.0 - nnz / n_real_orig.to(torch.float32)

    sub_rep = torch.repeat_interleave(sub, f, dim=3)
    smooth = gaussian_filter(sub_rep, smooth_sigma, mode="zero",
                             batch_ndim=1)
    zf = torch.arange(box_shape[2] * f, device=dev)
    inside = ((grids[0][None, :, None, None] < ext[:, 0, None, None, None])
              & (grids[1][None, None, :, None] < ext[:, 1, None, None, None])
              & (zf[None, None, None, :] < ext[:, 2, None, None, None] * f))
    vals = torch.where(inside, smooth, torch.inf).reshape(n_cells, -1)
    thr = _percentile_threshold(vals, n_real_orig * f, percentage * 100.0)
    boxes = (smooth > thr[:, None, None, None]) & inside
    origins = torch.stack([origins_raw[:, 0], origins_raw[:, 1],
                           origins_raw[:, 2] * f], dim=1).to(torch.int32)
    boxes = boxes & valid[:, None, None, None]
    return SubregionAtlas(boxes, origins, valid, f,
                          tuple(int(s) for s in label_image.shape))


def _box_extents(boxes: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per cell and axis, the tight start offset and width of its box's
    occupied voxels (the reference's ``region_xyz_min`` relative to the
    box origin and ``region_width``, track.py:520-534); (0, 0) for an
    empty box."""
    starts, widths = [], []
    for other in ((2, 3), (1, 3), (1, 2)):
        line = torch.any(torch.any(boxes, dim=other[1]), dim=other[0])
        length = line.shape[1]
        idx = torch.arange(length, device=boxes.device)[None, :]
        first = torch.min(torch.where(line, idx, length), dim=1).values
        last1 = torch.max(torch.where(line, idx + 1, 0), dim=1).values
        nonempty = last1 > 0
        starts.append(torch.where(nonempty, first, 0))
        widths.append(torch.where(nonempty, last1 - first, 0))
    return (torch.stack(starts, dim=1).to(torch.int32),
            torch.stack(widths, dim=1).to(torch.int32))


def _reference_in_bounds(atlas: SubregionAtlas, movements: torch.Tensor,
                         full_shape) -> torch.Tensor:
    """Which moved cells the reference's paste keeps (tracker.py:1370-1376):
    a cell whose tight extent leaves the canvas padded by the largest cell
    width is skipped, per axis ``-pad <= min + move`` and ``min + move +
    width <= size + pad``, in the full interpolated frame."""
    starts, w = _box_extents(atlas.boxes)
    pad = torch.max(torch.where(atlas.valid[:, None], w, 0), dim=0).values
    base = atlas.origins + starts + movements.to(torch.int32)
    lim = torch.tensor(full_shape, dtype=torch.int32,
                       device=base.device)[None, :] + pad[None, :]
    return torch.all((base >= -pad[None, :]) & (base + w <= lim), dim=1)


def _paste_scatter(canvas_shape, boxes: torch.Tensor,
                   positions: torch.Tensor, include: torch.Tensor,
                   overlap_mode: str = "add"):
    """Scatter every cell's box at its position: (labels, overlap count)
    int32 canvases.  ``overlap_mode="add"``: labels hold the SUM of ids
    where cells overlap; ``"last"``: the id pasted last in ascending id
    order, i.e. the largest (a scatter-max)."""
    if overlap_mode not in ("add", "last"):
        raise ValueError(f"overlap_mode {overlap_mode!r}")
    dev = boxes.device
    n, bx, by, bz = boxes.shape
    cx, cy, cz = canvas_shape
    ii = torch.arange(bx, device=dev)[None, :, None, None]
    jj = torch.arange(by, device=dev)[None, None, :, None]
    kk = torch.arange(bz, device=dev)[None, None, None, :]
    pos = positions.long()
    flat_idx = (((pos[:, 0, None, None, None] + ii) * cy
                 + pos[:, 1, None, None, None] + jj) * cz
                + pos[:, 2, None, None, None] + kk).reshape(-1)
    vals_i = (boxes & include[:, None, None, None]).to(torch.int32)
    cell_ids = torch.arange(1, n + 1, dtype=torch.int32,
                            device=dev)[:, None, None, None]
    ids = (vals_i * cell_ids).reshape(-1)
    labels = torch.zeros((cx * cy * cz,), dtype=torch.int32, device=dev)
    if overlap_mode == "last":
        labels.scatter_reduce_(0, flat_idx, ids, "amax")
    else:
        labels.index_add_(0, flat_idx, ids)
    overlap = torch.zeros((cx * cy * cz,), dtype=torch.int32, device=dev)
    overlap.index_add_(0, flat_idx, vals_i.reshape(-1))
    return labels.reshape(canvas_shape), overlap.reshape(canvas_shape)


def _moved_cells(atlas: SubregionAtlas, movements: Optional[torch.Tensor],
                 include: Optional[torch.Tensor], out_of_range: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The movements (zeros by default) and the cells to paste: the
    valid ones of ``include`` (all by default), less with
    ``out_of_range="drop"`` the cells the reference's paste skips (bounds
    in the full interpolated frame; ``"clip"`` keeps them)."""
    if out_of_range not in ("clip", "drop"):
        raise ValueError(f"out_of_range {out_of_range!r}")
    dev = atlas.boxes.device
    n = atlas.n_cells
    if movements is None:
        movements = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    if include is None:
        include = torch.ones((n,), dtype=torch.bool, device=dev)
    include = include & atlas.valid
    if out_of_range == "drop":
        x, y, z = atlas.image_shape
        include = include & _reference_in_bounds(
            atlas, movements, (x, y, z * atlas.interpolation_factor))
    return movements, include


def move_cells_sampled(atlas: SubregionAtlas,
                       movements: Optional[torch.Tensor] = None,
                       include: Optional[torch.Tensor] = None,
                       overlap_mode: str = "add",
                       out_of_range: str = "clip"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paste every included cell at origin + movement (interp frame) and
    sample the original z slices ``f//2, f//2 + f, ...``.  Returns
    (labels, overlap count) of shape (x, y, z); overlapping voxels hold the
    sum of ids, or with ``overlap_mode="last"`` the largest (callers zero
    them where overlap > 1).  ``out_of_range="drop"`` skips the cells the
    reference's paste skips (bounds in the full interpolated frame);
    ``"clip"`` clamps them into the canvas."""
    movements, include = _moved_cells(atlas, movements, include,
                                      out_of_range)
    dev = atlas.boxes.device
    n = atlas.n_cells
    f = atlas.interpolation_factor
    off = f // 2
    x, y, z = atlas.image_shape
    bx, by, bzf = atlas.box_shape
    bz = bzf // f
    pad = (bx, by, bz + 1)
    canvas_shape = (x + 2 * pad[0], y + 2 * pad[1], z + 2 * pad[2])

    pos_interp = atlas.origins + movements.to(torch.int32)
    boxes_r = atlas.boxes.reshape(n, bx, by, bz, f)
    z0 = pos_interp[:, 2]
    r = torch.remainder(off - z0, f)
    planes = torch.gather(boxes_r, 4, r.long()[:, None, None, None, None]
                          .expand(n, bx, by, bz, 1))[..., 0]
    s0 = torch.div(z0 + r - off, f, rounding_mode="floor")
    pos = torch.stack([pos_interp[:, 0] + pad[0], pos_interp[:, 1] + pad[1],
                       s0 + pad[2]], dim=1)
    hi = torch.tensor([canvas_shape[0] - bx, canvas_shape[1] - by,
                       canvas_shape[2] - bz], dtype=torch.int32, device=dev)
    pos = torch.minimum(torch.clamp_min(pos, 0), hi)
    cl, cm = _paste_scatter(canvas_shape, planes, pos, include,
                            overlap_mode)
    return (cl[pad[0]:pad[0] + x, pad[1]:pad[1] + y, pad[2]:pad[2] + z],
            cm[pad[0]:pad[0] + x, pad[1]:pad[1] + y, pad[2]:pad[2] + z])


def move_cells_full(atlas: SubregionAtlas,
                    movements: Optional[torch.Tensor] = None,
                    include: Optional[torch.Tensor] = None,
                    overlap_mode: str = "add",
                    out_of_range: str = "clip"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``move_cells`` on the whole interpolated canvas
    (x, y, z * f): every included cell pasted at origin + movement
    (``movements`` (n, 3) int, interp frame; ``include`` (n,) bool, False
    for a missed cell).  Returns (labels, overlap count); overlapping
    voxels hold the sum of ids, or with ``overlap_mode="last"`` the
    largest.  ``out_of_range``: a cell pushed past the padded canvas is
    clamped into it (``"clip"``) or skipped as the reference skips it
    (``"drop"``); ``"last"`` with ``"drop"`` is the reference's paste
    byte for byte."""
    movements, include = _moved_cells(atlas, movements, include,
                                      out_of_range)
    dev = atlas.boxes.device
    f = atlas.interpolation_factor
    x, y, z = atlas.image_shape
    full_shape = (x, y, z * f)
    pad = atlas.box_shape
    canvas_shape = tuple(s + 2 * p for s, p in zip(full_shape, pad))
    pos = atlas.origins + movements.to(torch.int32) + torch.tensor(
        pad, dtype=torch.int32, device=dev)
    hi = torch.tensor([c - b for c, b in zip(canvas_shape, atlas.box_shape)],
                      dtype=torch.int32, device=dev)
    pos = torch.minimum(torch.clamp_min(pos, 0), hi)
    cl, cm = _paste_scatter(canvas_shape, atlas.boxes, pos, include,
                            overlap_mode)
    sl = tuple(slice(p, p + s) for p, s in zip(pad, full_shape))
    return cl[sl], cm[sl]
