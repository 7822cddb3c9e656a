"""Device meshes over ``torch.distributed`` (counterpart of
``3deecelltracker_tpu/parallel/mesh.py``).

The port's mesh is ``torch.distributed.device_mesh.DeviceMesh``, the
counterpart of ``jax.sharding.Mesh``: one process per card, as ``torchrun``
launches them, each on ``cuda:<local rank>`` (``parallel.multihost.
initialize`` sets it), or ``gloo`` ranks on the CPU when the caller asks
for ``"cpu"``.  The process group must be initialized first
(``multihost.initialize``); nothing here falls back to one process.

:func:`mesh_axis` is what the mesh entry points (``engine.stardist``,
``engine.pipeline``, ``engine.segmentation``, ``parallel.ensemble`` and
``parallel.spatial``) read of a mesh: the process group of one axis, its
ranks, this rank's place on it and its device.
"""

from __future__ import annotations

import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def auto_mesh_shape(n_devices: int,
                    max_spatial: int = 4) -> Tuple[int, int]:
    """A (data, spatial) factorization of ``n_devices``: the spatial axis
    takes the largest power of two up to ``max_spatial`` that divides it,
    the data axis the rest (8 -> (2, 4)); ``max_spatial=1`` is all data."""
    spatial = 1
    for cand in (2, 4):
        if cand <= max_spatial and n_devices % cand == 0:
            spatial = cand
    return n_devices // spatial, spatial


def require_group() -> None:
    """Raise unless the default process group is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "parallel.multihost.initialize (or init_process_group) on "
            "every rank first")


def make_mesh(n_data: int, n_spatial: int = 1,
              devices: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, str] = ("data", "spatial"), *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (``n_data``, ``n_spatial``) mesh of the first ``n_data *
    n_spatial`` of ``devices``, named ``axis_names``.  ``devices``: global
    ranks, JAX's device list (default: the world's ranks in order).
    ``device_type``: ``"cuda"`` (the default: each rank's card) or
    ``"cpu"`` (a ``gloo`` group).

    Every rank of the world calls it (the mesh's groups are made
    collectively).  Fewer ranks than that raise ``ValueError``, as JAX's
    does with too few devices; the ranks left out are outside the mesh
    (``get_coordinate()`` is None there) and the mesh entry points raise
    on them."""
    require_group()
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') needs a CUDA "
                           "card; pass device_type='cpu' for gloo ranks")
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else \
        [int(r) for r in devices]
    if any(not 0 <= r < world for r in ranks) or len(set(ranks)) < \
            len(ranks):
        raise ValueError(f"devices must be distinct ranks below {world}, "
                         f"got {ranks}")
    need = int(n_data) * int(n_spatial)
    if len(ranks) < need:
        raise ValueError(f"need {need} devices, have {len(ranks)}")
    grid = torch.tensor(ranks[:need]).reshape(int(n_data), int(n_spatial))
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))


def make_mesh_from_config(config, devices: Optional[Sequence[int]] = None,
                          *, device_type: Optional[str] = None
                          ) -> DeviceMesh:
    """The mesh a :class:`t3dct_torch.MeshConfig` describes, over
    ``devices`` (global ranks; default: the world's)."""
    return make_mesh(config.data_parallel, config.spatial_parallel,
                     devices=devices,
                     axis_names=(config.data_axis, config.spatial_axis),
                     device_type=device_type)


class MeshAxis(NamedTuple):
    """One axis of a mesh as this rank sees it."""
    group: "dist.ProcessGroup"
    ranks: List[int]            # the axis's global ranks, in axis order
    index: int                  # this rank's place on the axis
    lead: bool                  # first on every axis of the mesh
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself; ``TypeError`` for anything but a ``DeviceMesh``,
    ``RuntimeError`` where the process group is not initialized,
    ``ValueError`` on a rank outside the mesh."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh (parallel.make_mesh), got "
                        f"{type(mesh).__name__}")
    require_group()
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return mesh


def mesh_device(device_type: str) -> torch.device:
    """This rank's device: its current card, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device(device_type, torch.cuda.current_device())


def mesh_axis(mesh, axis: Optional[str] = None,
              sole: bool = False) -> MeshAxis:
    """Axis ``axis`` (default: the mesh's first) of a checked mesh; None
    (a world of every rank, as JAX's default mesh of every device) needs
    the default group, whose backend gives the device (``gloo``: the
    CPU).  ``sole``: raise ``ValueError`` unless the mesh's other axes are
    of size 1 (the StarDist workflow's paths split over one axis and keep
    no replicas).  A ``MeshAxis`` is returned as it is (the drivers hand
    one on to the entry points they call)."""
    if isinstance(mesh, MeshAxis):
        return mesh
    if mesh is None:
        require_group()
        world = dist.group.WORLD
        cpu = dist.get_backend(world) == "gloo"
        return MeshAxis(world, list(range(dist.get_world_size())),
                        dist.get_rank(), dist.get_rank() == 0,
                        mesh_device("cpu" if cpu else "cuda"))
    check_mesh(mesh)
    names = mesh.mesh_dim_names or ()
    axis = axis or names[0]
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                         f"{names}")
    if sole and mesh.size() != mesh.size(names.index(axis)):
        raise ValueError(f"the mesh's axes other than {axis!r} must be of "
                         f"size 1, got {dict(zip(names, mesh.shape))}")
    group = mesh.get_group(axis)
    return MeshAxis(group, dist.get_process_group_ranks(group),
                    mesh.get_local_rank(axis),
                    all(c == 0 for c in mesh.get_coordinate()),
                    mesh_device(mesh.device_type))


_WHOLE = weakref.WeakKeyDictionary()    # mesh -> its ranks' own group


def mesh_all(mesh) -> MeshAxis:
    """Every rank of a checked mesh as one axis, in the mesh's row-major
    order (rank 0 of it is the mesh's lead): the group that the sharded
    trainers reduce their gradients and batch statistics over and
    broadcast the lead's parameters on.  A mesh of one axis gives that
    axis's group, a mesh of every rank of the world in rank order the
    world's; otherwise the mesh's ranks make a group of their own once
    (each of them calls this)."""
    check_mesh(mesh)
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    coord = mesh.get_coordinate()
    index = ranks.index(dist.get_rank())
    if mesh.ndim == 1:
        group = mesh.get_group(0)
    elif ranks == list(range(dist.get_world_size())):
        group = dist.group.WORLD
    else:
        group = _WHOLE.get(mesh)
        if group is None:
            group = dist.new_group(ranks, use_local_synchronization=True)
            _WHOLE[mesh] = group
    return MeshAxis(group, ranks, index, all(c == 0 for c in coord),
                    mesh_device(mesh.device_type))

