"""Utilities: checkpoints, profiling, the kernels' build and its cache,
devices.  Exported here as the JAX package's ``utils/__init__.py`` exports
them (``enable_compilation_cache`` chooses where ``utils.cuda_build``
keeps the kernels it compiles, as JAX's chooses XLA's cache)."""

from .cache import enable_compilation_cache
from .checkpoint import save_pytree, load_pytree
from .profiling import StageTimer, timer

__all__ = ["enable_compilation_cache", "save_pytree", "load_pytree",
           "StageTimer", "timer"]
