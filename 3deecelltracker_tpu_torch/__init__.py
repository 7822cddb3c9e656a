"""PyTorch + CUDA port of 3DeeCellTracker-TPU for NVIDIA Hopper (H100):
the v1.0 StarDist segment-and-track main path (from a TIFF recording to a
results tree, or on arrays), the legacy v0.4 U-Net path on arrays, single
mode, and the conv probe.

It sits beside the JAX package ``3deecelltracker_tpu``, which stays the
reference: every module here mirrors a module there, keeps its array
layouts, and is held against it by the ``tests/test_torch_*.py`` parity
tests.  The TPU kernels on these paths (3x3x3 conv, per-slice flood,
connected components, the conv probe's ladder) are hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` at first use; on CPU tensors their
plain PyTorch versions run.  Entry points run on the first CUDA card unless
the caller passes ``device="cpu"``; without a card they raise.  This
package imports ``torch`` and numpy, never ``jax``.

The directory name starts with a digit, so ``import t3dct_torch`` (the
alias module at the repository root) is the import path; the alias also
covers every submodule, e.g. ``t3dct_torch.engine.pipeline``.

Entry points: ``engine.pipeline.segment_and_track`` (v1.0 over a TIFF
recording, ``handoff="device"``), ``engine.pipeline.segment_and_track_arrays``
(v1.0 on arrays),
``engine.legacy.legacy_segment_and_track_arrays`` (v0.4 U-Net) and
``scripts.probe_conv_fast.run`` (the conv probe).
"""

import sys as _sys

from . import config, coordinates  # noqa: F401
from .engine import correction, legacy, metrics, pipeline  # noqa: F401
from .engine import segmentation, stardist, tracker, transformer  # noqa: F401
from .io import artifacts, imageio, prefetch, tiff  # noqa: F401
from .models import ffn, layers, stardist3d, unet3d  # noqa: F401
from .ops import (connected, edt, filters, hopper_cc,  # noqa: F401
                  hopper_conv, hopper_flood, knn, ladder, lcn, matching,
                  neighborhood, nms, numerics, peaks, pointset, prgls, rays,
                  segment_reduce, subregions, tiling, watershed)
from .utils import (convert, cuda_build, device, roofline,  # noqa: F401
                    synthetic, timing)

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
