"""The workflow's drivers: segmentation, the coordinate/image transformer,
tracking, the legacy folder workflow, activities and metrics.  Exported
here as the JAX package's ``engine/__init__.py`` exports them."""

from .correction import accurate_correction_loop, get_cells_on_boundary
from .segmentation import SegResult, UNetSegmenter
from .transformer import CoordsToImageTransformer
from .tracker import (TrackerLite, track_step, match_step,
                      get_volumes_list, evenly_distributed_volumes)
from .stardist import (StarDist3D, configure, load_stardist_model,
                       predict_and_save)
from .legacy import Tracker, Paths, History, get_reference_vols
from .pipeline import track_timelapse
from .analyses import get_activities, get_activities_quick
from .metrics import (instance_matching, tracking_accuracy,
                      optimize_thresholds)

__all__ = [
    "accurate_correction_loop", "get_cells_on_boundary",
    "SegResult", "UNetSegmenter",
    "CoordsToImageTransformer",
    "TrackerLite", "track_step", "match_step", "get_volumes_list",
    "evenly_distributed_volumes",
    "StarDist3D", "configure", "load_stardist_model", "predict_and_save",
    "Tracker", "Paths", "History", "get_reference_vols",
    "track_timelapse",
    "get_activities", "get_activities_quick",
    "instance_matching", "tracking_accuracy", "optimize_thresholds",
]
