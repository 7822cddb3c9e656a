"""PyTorch + CUDA port of 3DeeCellTracker-TPU's v1.0 segment-and-track
main path, for NVIDIA Hopper (H100).

It sits beside the JAX package ``3deecelltracker_tpu``, which stays the
reference: every module here mirrors a module there, keeps its array
layouts, and is held against it by the ``tests/test_torch_*.py`` parity
tests.  The two TPU kernels on the path are hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use; on CPU tensors their plain
PyTorch versions run.  This package imports ``torch`` and numpy, never
``jax``.

The directory name starts with a digit, so ``import t3dct_torch`` (the
alias module at the repository root) is the import path; the alias also
covers every submodule, e.g. ``t3dct_torch.engine.pipeline``.

Entry point: ``engine.pipeline.segment_and_track_arrays``.
"""

import sys as _sys

from . import config, coordinates  # noqa: F401
from .engine import correction, pipeline, stardist, tracker  # noqa: F401
from .engine import transformer  # noqa: F401
from .models import ffn, layers, stardist3d  # noqa: F401
from .ops import (connected, edt, filters, hopper_conv,  # noqa: F401
                  hopper_flood, knn, matching, neighborhood, nms, numerics,
                  pointset, prgls, rays, segment_reduce, subregions,
                  watershed)
from .utils import convert, cuda_build, device, synthetic  # noqa: F401

__version__ = "0.1.0"

_ALIAS = "t3dct_torch"


def _register_alias() -> None:
    """Register the package and every loaded submodule under ``t3dct_torch``
    so both names resolve to the SAME module objects (one set of kernel
    launch counters)."""
    for name, mod in list(_sys.modules.items()):
        if name == __name__ or name.startswith(__name__ + "."):
            _sys.modules.setdefault(_ALIAS + name[len(__name__):], mod)


_register_alias()
