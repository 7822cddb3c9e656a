"""PyTorch + CUDA port of 3DeeCellTracker-TPU for NVIDIA Hopper (H100):
the v1.0 StarDist workflow (segment a TIFF or HDF5 recording into a
results tree, track it in single or ensemble mode, read activities), its
two trainers (StarDist3D and the FFN matcher), the legacy v0.4 U-Net
workflow and its trainer, the reference's Keras checkpoints
(``utils.keras_import``, ``StarDist3DNet(arch="keras")``) and the conv
probe.

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

Entry points:

- the v1.0 workflow of the examples: ``engine.stardist.load_stardist_model``
  and ``predict_and_save`` (step 1, ``seg/`` and ``auto_vol1/``), then
  ``engine.pipeline.track_timelapse`` (step 2, single or ensemble mode),
  ``engine.tracker.TrackerLite`` (``match_by_ffn``, ``activities``),
  ``io.artifacts.ResultsTree.export_coordinates_csv`` /
  ``export_activities_csv`` and ``engine.analyses.get_activities``;
- ``engine.pipeline.segment_and_track``: both steps at once over a TIFF
  recording, ``handoff="disk"`` (default) or ``"device"``;
- ``engine.pipeline.segment_and_track_arrays`` (v1.0 on arrays);
- ``engine.legacy.Tracker``, the v0.4 U-Net workflow of a folder (as
  ``scripts.use_unet_legacy`` runs it; ``models.train_unet`` retrains the
  U-Net), and ``legacy_segment_and_track_arrays`` on arrays;
- training: ``models.train_stardist.TrainStarDist3D`` (with
  ``engine.stardist.load_training_images`` / ``configure`` and
  ``engine.metrics.optimize_thresholds``) and ``models.train_ffn.TrainFFN``,
  as ``scripts.train_stardist`` and ``scripts.train_ffn`` run them;
- the reference's files: ``engine.stardist.load_stardist_model`` on a
  stardist Keras folder (``load_stardist_keras_dir``), the importers of
  ``utils.keras_import``, HDF5 recordings (``io.imageio.
  save_recording_h5``) and ``scripts.track_stardist_h5``; reading HDF5
  needs ``h5py``;
- several cards: ``parallel.multihost.initialize`` (one process a card,
  as ``torchrun`` starts them) and ``parallel.make_mesh``, whose mesh the
  ``mesh=`` of ``predict_and_save``, ``segment_and_track``,
  ``track_timelapse`` and ``UNetSegmenter`` take, with
  ``StarDist3D.predict_instances_sharded`` for the tiles of one volume;
- ``scripts.synthetic_demo`` (train, segment and track a synthetic
  recording) and the examples' other twins under ``scripts``;
- ``scripts.probe_conv_fast.run`` (the conv probe).
"""

import sys as _sys

from . import config, coordinates  # noqa: F401
from .config import (  # noqa: F401
    LcnConfig,
    MeshConfig,
    SegmentationConfig,
    StarDistConfig,
    TrackingConfig,
    TrainFfnConfig,
    TrainUnetConfig,
)
from .coordinates import Coordinates  # noqa: F401
from .engine import analyses, correction, legacy, metrics  # noqa: F401
from .engine import pipeline, segmentation, stardist  # noqa: F401
from .engine import tracker, transformer  # noqa: F401
from .io import artifacts, imageio, prefetch, tiff  # noqa: F401
from .models import ffn, layers, stardist3d, synthesize  # noqa: F401
from .models import train_ffn, train_stardist, train_unet  # noqa: F401
from .models import unet3d  # noqa: F401
# ops.lcn is the function, as in JAX; its module loads with ops
from .ops import (connected, edt, filters, hopper_cc,  # noqa: F401
                  hopper_conv, hopper_flood, knn, ladder, matching,
                  neighborhood, nms, numerics, peaks, pointset, prgls, rays,
                  segment_reduce, stardist_gt, subregions, tiling, trim,
                  watershed)
from .parallel import comm, ensemble, mesh, multihost  # noqa: F401
from .parallel import spatial, training  # noqa: F401
from .utils import (checkpoint, convert, cuda_build, device,  # noqa: F401
                    keras_import, optim, profiling, roofline, synthetic,
                    timing)

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
