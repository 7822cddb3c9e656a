"""Utilities: checkpoints, profiling, the kernels' build, devices.
Exported here as the JAX package's ``utils/__init__.py`` exports them
(its ``enable_compilation_cache``, XLA's compile cache, has no
counterpart: the port's kernels are built by ``utils.cuda_build``)."""

from .checkpoint import save_pytree, load_pytree
from .profiling import StageTimer, timer

__all__ = ["save_pytree", "load_pytree", "StageTimer", "timer"]
