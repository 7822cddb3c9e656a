"""Several processes, one card each (counterpart of
``3deecelltracker_tpu/parallel/multihost.py``).

``torchrun --nproc-per-node N`` starts one process a card and sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address;
:func:`initialize` joins them into one process group (``nccl`` on the
cards, ``gloo`` when the caller asks for the CPU) and puts each process on
``cuda:<local rank>``.  A single process needs no group: ``initialize``
does nothing there unless a ``store`` asks for a world of one.
``local_shard`` splits a work list over the processes as JAX's does, and
``global_batch_from_local`` makes a sharded batch of each process's
block.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: Optional[str] = None,
               store: Optional[str] = None) -> None:
    """Join this process to the job's process group; a no-op when the
    group exists already.

    - ``store``: a ``FileStore`` path that every process of the job
      passes (a world of ``num_processes``, 1 by default, rank
      ``process_id``, 0 by default);
    - else, under ``torchrun`` (``WORLD_SIZE`` in the environment) with no
      ``num_processes``: ``env://``;
    - else a single process (``num_processes`` None or 1): nothing, as
      in JAX;
    - else ``tcp://<coordinator_address>`` (``"host:port"``) with
      ``num_processes`` and ``process_id``.

    ``device``: ``"cpu"`` makes a ``gloo`` group; otherwise ``nccl``, and
    this process takes card ``LOCAL_RANK`` (else ``process_id`` modulo
    the cards), raising without a card."""
    if dist.is_available() and dist.is_initialized():
        return
    cpu = device == "cpu"
    if store is not None:
        world = int(num_processes or 1)
        rank = int(process_id or 0)
        kwargs = dict(store=dist.FileStore(str(store), world),
                      world_size=world, rank=rank)
    elif num_processes is None and "WORLD_SIZE" in os.environ:
        rank = int(os.environ.get("RANK", 0))
        kwargs = dict(init_method="env://")
    elif num_processes is None or int(num_processes) <= 1:
        return
    else:
        if coordinator_address is None or process_id is None:
            raise ValueError("several processes need coordinator_address "
                             "and process_id")
        rank = int(process_id)
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=rank)
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA card (pass "
                               "device='cpu' for gloo ranks)")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        torch.cuda.init()       # select_device(None) reads the card now
    dist.init_process_group("gloo" if cpu else "nccl", timeout=TIMEOUT,
                            **kwargs)


def process_count() -> int:
    """The processes of the job (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_shard(items: Sequence, pid: Optional[int] = None,
                n: Optional[int] = None) -> List:
    """This process's contiguous share of a work list (volumes, time
    points): ``ceil(len / n)`` items a process, the last ones shorter."""
    pid = process_index() if pid is None else pid
    n = process_count() if n is None else n
    items = list(items)
    per = -(-len(items) // n)
    return items[pid * per:(pid + 1) * per]


def global_batch_from_local(mesh, local_batch, pspec):
    """A global batch assembled from every process's local block (the
    training input pipeline; ``jax.make_array_from_process_local_data``'s
    counterpart): a ``DTensor`` on ``mesh`` whose local shard is
    ``local_batch`` (a tensor or an array, moved to this rank's device).
    ``pspec``: one entry per leading dim of the batch, a mesh axis name
    (the dim is split over that axis, ``Shard(dim)``) or None; mesh axes
    that it names nowhere replicate (``Replicate()``).  Every process
    passes a block of the same shape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from .mesh import check_mesh, mesh_device
    check_mesh(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    if isinstance(pspec, str) or pspec is None:
        pspec = (pspec,)
    placements = [Replicate()] * len(names)
    for dim, name in enumerate(pspec):
        if name is None:
            continue
        if name not in names:
            raise ValueError(f"pspec {tuple(pspec)} names {name!r}, not an "
                             f"axis of the mesh {names}")
        if not isinstance(placements[names.index(name)], Replicate):
            raise ValueError(f"pspec {tuple(pspec)} names {name!r} twice")
        placements[names.index(name)] = Shard(dim)
    local = torch.as_tensor(local_batch).to(mesh_device(mesh.device_type))
    return DTensor.from_local(local, mesh, placements, run_check=False)
