"""Data-parallel training steps over the ranks of a mesh (counterpart of
``3deecelltracker_tpu/parallel/training.py``).

JAX jits the U-Net step over a (data, spatial) mesh: the batch (b, x, y,
z, c) is sharded on b over ``data`` and on x over ``spatial``, parameters
are replicated, and XLA SPMD inserts the gradient all-reduce and every
conv's halo exchange.  Here each rank of a ``torch.distributed`` mesh holds
its block of the batch and computes, with a few collectives, what one card
computes on the whole batch:

- each 3x3x3 conv extends the local x shard by one plane from each spatial
  neighbour (``parallel.comm.halo_extend``; its gradient goes back the same
  way) and crops the two extra output planes (``models.layers.conv3d``);
- train-mode BatchNorm sums the batch's statistics over every rank that
  holds a part of the batch (``models.layers.batchnorm(group=)``);
- each rank's loss is its term of the whole batch's mean: its local sum
  over the global count (:func:`bce_from_probs` with ``axis``);
- the gradients and the loss go through one ``all_reduce`` of one flat
  float32 bucket (``parallel.comm.all_reduce_grads``), and every rank takes
  the same Adam step (``utils.optim.Adam``), so the parameters stay the same
  bits on every rank.

The helpers after the steps are what the trainers (``models.train_unet``,
``models.train_stardist``, ``models.train_ffn``) do over a mesh: the lead
rank's parameters broadcast, files written by the lead alone, and the
values that decide the workflow (validation losses) taken from the lead.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..utils.checkpoint import leaves_with_paths
from .comm import (_picklable, all_reduce_grads, barrier, broadcast_object,
                   broadcast_tensors_, lead_value)
from .mesh import MeshAxis, mesh_all, mesh_axis


def bce_from_probs(probs: torch.Tensor, labels: torch.Tensor,
                   eps: float = 1e-7, *, axis: Optional[MeshAxis] = None
                   ) -> torch.Tensor:
    """Binary cross entropy on sigmoid outputs (Keras
    ``binary_crossentropy``, the reference's loss at ``unet3d.py:415``): the
    mean over every element.  ``axis``: the batch is split over its ranks,
    each block of this shape; this rank's term of the whole batch's mean
    (its sum over the whole count), which the ranks' terms sum to."""
    from ..models.train_ffn import bce_loss, clip_prob
    if axis is None:
        return bce_loss(probs, labels, eps)
    p = clip_prob(probs, eps)
    y = labels.to(p.dtype)
    return -torch.sum(y * torch.log(p) + (1 - y) * torch.log(1 - p)) \
        / (p.numel() * axis.size)


def _detached(state):
    return {k: {s: v.detach() for s, v in d.items()}
            for k, d in state.items()}


def make_unet_train_step(model, optimizer) -> Callable:
    """``step(params, bn_state, x, y) -> (loss, new_bn_state)`` on one
    device: the train-mode forward, BCE, the gradient of
    ``optimizer.params`` (the leaves of ``params``) and one step of
    ``optimizer`` (``utils.optim.Adam``) on them in place."""

    def step(params, bn_state, x, y):
        probs, new_bn = model.apply(params, bn_state, x, train=True)
        loss = bce_from_probs(probs, y)
        grads = torch.autograd.grad(loss, optimizer.params)
        optimizer.step(grads)
        return loss.detach(), _detached(new_bn)
    return step


def local_block(x) -> torch.Tensor:
    """A ``DTensor``'s local shard; a tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def make_sharded_unet_train_step(model, optimizer, mesh,
                                 data_axis: str = "data",
                                 spatial_axis: str = "spatial"
                                 ) -> Tuple[Callable, Callable]:
    """``(step, shard)`` over ``mesh`` (a ``DeviceMesh``,
    ``parallel.make_mesh``), JAX's ``(jitted, batch_sharding)`` pair.
    ``shard(batch)``: this rank's block of a global (b, x, y, z, c) batch,
    b split over ``data_axis`` and x over ``spatial_axis`` (``ValueError``
    where they do not divide, or where the x shard does not pool without a
    halo, ``UNet3D.check_x_shard``).  ``step(params, bn_state, x, y) ->
    (loss, new_bn_state)``: :func:`make_unet_train_step`'s step on this
    rank's blocks (tensors as ``shard`` gives them, or ``DTensor``s from
    ``multihost.global_batch_from_local``), the result the one-card step's
    on the whole batch: the whole batch's loss and BatchNorm statistics,
    the same parameters on every rank.  Every rank of the mesh calls both
    with the same arguments."""
    data = mesh_axis(mesh, data_axis)
    spatial = mesh_axis(mesh, spatial_axis)
    whole = mesh_all(mesh)

    def shard(batch):
        rows = mesh_rows(data, int(batch.shape[0]))
        cols = mesh_rows(spatial, int(batch.shape[1]), "tile x")
        model.check_x_shard(cols.stop - cols.start, spatial.size)
        return batch[rows, cols]

    def step(params, bn_state, x, y):
        x, y = local_block(x), local_block(y)
        probs, new_bn = model.apply(params, bn_state, x, train=True,
                                    mesh_axes=(whole, spatial))
        loss = bce_from_probs(probs, y, axis=whole)
        grads = torch.autograd.grad(loss, optimizer.params)
        *grads, total = all_reduce_grads(
            whole, [*grads, loss.detach().reshape(1)])
        optimizer.step(grads)
        return total[0], _detached(new_bn)
    return step, shard


# ---- what a trainer does over a mesh ------------------------------------

def mesh_rows(ax: MeshAxis, n: int, what: str = "batch") -> slice:
    """This rank's contiguous rows of ``n`` split over ``ax``
    (``ValueError`` unless they divide)."""
    if n % ax.size:
        raise ValueError(f"the {what} size {n} must divide by the mesh "
                         f"axis's {ax.size} ranks")
    per = n // ax.size
    return slice(ax.index * per, (ax.index + 1) * per)


def broadcast_trees_(ax: Optional[MeshAxis], *trees) -> None:
    """Every tensor leaf of ``trees`` overwritten in place with the lead
    rank's bits (one broadcast); nothing without a mesh."""
    if ax is not None:
        broadcast_tensors_(ax, [v for tree in trees
                                for _, v in leaves_with_paths(tree)])


def lead_write(ax: Optional[MeshAxis], write: Callable[[], None]) -> None:
    """``write()`` on the lead rank alone (every call without a mesh),
    then a barrier, so that no rank reads before the file is there."""
    if ax is None or ax.lead:
        write()
    if ax is not None:
        barrier(ax)


def lead_read(ax: Optional[MeshAxis], read: Callable, template):
    """``read()`` on the lead rank (every call without a mesh), and
    ``template`` on the others, which take the lead's values from the
    broadcast that follows (:func:`broadcast_trees_`).  The lead's
    exception is raised on every rank."""
    if ax is None:
        return read()
    if ax.lead:
        try:
            out = read()
        except BaseException as e:
            broadcast_object(ax, _picklable(e))
            raise
        broadcast_object(ax, None)
        return out
    err = broadcast_object(ax)
    if err is not None:
        raise err
    return template


def agreed(ax: Optional[MeshAxis], value: float) -> float:
    """The lead rank's ``value`` on every rank (``value`` without a
    mesh): a number that decides the workflow, the same everywhere."""
    return value if ax is None else lead_value(ax, value)


def check_trainer_mesh(mesh, device: torch.device, axes: Sequence[str]
                       ) -> Tuple[MeshAxis, ...]:
    """``(whole, *axes)`` of a trainer's mesh (``mesh_all`` and
    ``mesh_axis`` of each name); ``ValueError`` where ``device`` is not
    this rank's device on the mesh."""
    from ..utils.device import same_device
    whole = mesh_all(mesh)
    if not same_device(device, whole.device):
        raise ValueError(f"device {device} is not this rank's device on "
                         f"the mesh, {whole.device}")
    return (whole,) + tuple(mesh_axis(mesh, a) for a in axes)
