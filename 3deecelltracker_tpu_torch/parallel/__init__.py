"""Work over several cards with ``torch.distributed`` (counterpart of
``3deecelltracker_tpu/parallel/``): meshes (``mesh``), processes
(``multihost``), the ensemble's member fan-out (``ensemble``) and tile- or
space-parallel inference (``spatial``).  Data-parallel training
(``make_unet_train_step``, ``make_sharded_unet_train_step``) is not ported
yet (``ROADMAP.md`` A.5b)."""

from .mesh import make_mesh, make_mesh_from_config, auto_mesh_shape
from . import multihost

__all__ = [
    "multihost",
    "make_mesh",
    "make_mesh_from_config",
    "auto_mesh_shape",
]
