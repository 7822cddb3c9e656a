"""Tile- and space-parallel segmentation inference over the ranks of a mesh
axis (counterpart of ``3deecelltracker_tpu/parallel/spatial.py``).

- :func:`make_tile_parallel_predict`: the tile batch of a volume is split
  over the ranks; each applies the model to its share, an ``all_gather``
  gives every rank every tile, and each stitches the volume.  No halo
  traffic; every tile's output is the one-card sweep's.
- :func:`make_spatially_sharded_apply`: a (b, x, y, z, c) batch is split
  along x; each rank sends its ``halo`` edge planes to its neighbours by
  isend/irecv, applies the model to its extended shard and crops the
  halos, and an ``all_gather`` gives every rank the whole output.

Every rank of the axis calls the returned function with the same
arguments and gets the same result.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.tiling import (TilePlan, extract_tiles, pad_for_tiles,
                          stitch_tiles)
from .comm import all_gather_tensors, halo_exchange
from .mesh import MeshAxis, mesh_axis


def split_apply(ax: MeshAxis, fn: Callable[[torch.Tensor], torch.Tensor],
                batch: torch.Tensor) -> torch.Tensor:
    """``fn`` over a batch split in contiguous shares over the ranks of
    ``ax`` (the last shares filled with copies of the last item, whose
    outputs are dropped), gathered on every rank in batch order."""
    n = int(batch.shape[0])
    per = -(-n // ax.size)
    idx = [min(i, n - 1) for i in range(ax.index * per,
                                         (ax.index + 1) * per)]
    out = fn(batch[idx])
    return torch.cat([o[0] for o in all_gather_tensors(ax, [out])])[:n]


def make_tile_parallel_predict(model_apply: Callable, mesh, plan: TilePlan,
                               axis: str = "data"):
    """``fn(params, state, volume) -> probs``: the (x, y, z) volume
    reflect-padded and cut into ``plan``'s tiles, the tile batch split over
    the mesh's ``axis``, ``model_apply(params, state, tiles)`` ((b, x, y,
    z, 1) -> probabilities of that shape) on each rank's share, gathered
    and stitched on every rank."""
    ax = mesh_axis(mesh, axis)

    def fn(params, state, volume):
        tiles = extract_tiles(pad_for_tiles(volume, plan), plan)[..., None]
        probs = split_apply(ax, lambda t: model_apply(params, state, t),
                            tiles)
        return stitch_tiles(probs[..., 0], plan)
    return fn


def sharded_apply(ax: MeshAxis, model_apply: Callable, params, state,
                  x: torch.Tensor, halo: int) -> torch.Tensor:
    """The body of :func:`make_spatially_sharded_apply` on axis ``ax``:
    ``x`` (b, X, y, z, c) with X a multiple of the axis size and its shard
    at least ``halo`` wide."""
    n = ax.size
    xl = int(x.shape[1])
    if xl % n:
        raise ValueError(f"x extent {xl} does not split over {n} ranks")
    shard = xl // n
    if halo > shard:
        raise ValueError(f"halo {halo} exceeds the x shard {shard}")
    local = x[:, ax.index * shard:(ax.index + 1) * shard].contiguous()
    from_left, from_right = halo_exchange(ax, local, halo)
    y_ext = model_apply(params, state,
                        torch.cat([from_left, local, from_right], dim=1))
    y = y_ext[:, halo:halo + shard].contiguous()
    return torch.cat([o[0] for o in all_gather_tensors(ax, [y])], dim=1)


def make_spatially_sharded_apply(model_apply: Callable, mesh, halo: int,
                                 axis: str = "spatial"):
    """``fn(params, state, x)``: a (b, x, y, z, c) batch split along x over
    the mesh's ``axis``, each shard extended by its neighbours' ``halo``
    edge planes (isend/irecv; zeros at the global x edges), the model
    applied per shard, the halos cropped, and the shards gathered on every
    rank.

    Valid when ``model_apply`` is translation-equivariant with receptive
    radius <= ``halo`` (conv nets).  Boundary semantics, JAX's: interior
    shard seams are exact; within ``halo`` voxels of the GLOBAL x edges the
    result can differ from a stack of SAME convs (which zero-pads every
    layer; here zeros pad the input once).  In the segmentation pipeline
    that band lies inside the tile-and-stitch ``shrink`` margin."""
    ax = mesh_axis(mesh, axis)

    def fn(params, state, x):
        return sharded_apply(ax, model_apply, params, state, x, int(halo))
    return fn
