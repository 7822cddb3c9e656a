"""Work over several cards with ``torch.distributed`` (counterpart of
``3deecelltracker_tpu/parallel/``): meshes (``mesh``), processes
(``multihost``), the ensemble's member fan-out (``ensemble``), tile- or
space-parallel inference (``spatial``) and data-parallel training over a
(data, spatial) mesh (``training``: ``make_unet_train_step``,
``make_sharded_unet_train_step``; the trainers' ``mesh=``)."""

from .mesh import make_mesh, make_mesh_from_config, auto_mesh_shape
from . import multihost
from .training import make_unet_train_step, make_sharded_unet_train_step

__all__ = [
    "multihost",
    "make_mesh",
    "make_mesh_from_config",
    "auto_mesh_shape",
    "make_unet_train_step",
    "make_sharded_unet_train_step",
]
