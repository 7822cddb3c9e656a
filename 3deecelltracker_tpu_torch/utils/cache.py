"""Where the port's built kernels are kept (counterpart of
``3deecelltracker_tpu/utils/cache.py``, which points JAX at a persistent
XLA compilation cache).

The port's kernels are compiled from ``csrc/`` by ``utils.cuda_build`` at
their first call and cached on disk by a digest of their sources and
flags, so a later process with the same sources loads them at once.
:func:`enable_compilation_cache` chooses that directory, as JAX's chooses
its cache's.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

from . import cuda_build


def enable_compilation_cache(path: Optional[Union[str, Path]] = None,
                             min_compile_seconds: float = 0.5) -> str:
    """Keep the kernels that ``utils.cuda_build`` compiles in ``path``, by
    default ``$T3DCT_CACHE_DIR`` or else the package's ``_build/`` (listed
    in ``.gitignore``); returns the directory.  Call it before the first
    kernel call: a kernel already loaded stays loaded.
    ``min_compile_seconds`` is JAX's threshold for what its cache keeps;
    every ``nvcc`` build here takes seconds, so every build is kept and
    the value is accepted and unused."""
    if path is None:
        path = os.environ.get("T3DCT_CACHE_DIR",
                              str(cuda_build.PKG_DIR / "_build"))
    Path(path).mkdir(parents=True, exist_ok=True)
    cuda_build.BUILD_DIR = Path(path)
    return str(path)
