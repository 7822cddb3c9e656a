"""Host I/O of the v1.0 driver: the TIFF codec, recordings and label
TIFFs, the results tree, and the volume prefetcher.  Exported here as the
JAX package's ``io/__init__.py`` exports them."""

from .imageio import (load_image, load_2d_slices_at_time, get_t_range,
                      percentile_normalize, save_label_slices,
                      read_image_ts)
from .artifacts import ResultsTree
from .prefetch import VolumePrefetcher

__all__ = [
    "load_image", "load_2d_slices_at_time", "get_t_range",
    "percentile_normalize", "save_label_slices", "read_image_ts",
    "ResultsTree", "VolumePrefetcher",
]
