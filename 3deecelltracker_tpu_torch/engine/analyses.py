"""Activities from tracked labels (counterpart of
``3deecelltracker_tpu/engine/analyses.py``, reference ``analyses.py``).

Two readouts, as in the reference:

- ``get_activities`` / ``get_activities_quick`` (analyses.py:15-99): per
  cell, the mean of its voxels after dropping the dimmest
  ``discard_ratio`` of them by count (:func:`mean_excluding_bottom`);
- ``engine.tracker.TrackerLite.activities`` (trackerlite.py:152-201): the
  mean of the voxels strictly above the ``1 - discard_ratio`` percentile
  (``ops.segment_reduce.topq_mean_intensity``).

Each volume is one pass on the device: a sort by (label, intensity) and
two per-label sums.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.imageio import read_image_ts
from ..ops.segment_reduce import masked_label_mean, sort_by_label
from ..utils.device import select_device


def mean_excluding_bottom(raw: torch.Tensor, labels: torch.Tensor,
                          max_labels: int, discard_ratio: float = 0.1
                          ) -> torch.Tensor:
    """Per-label mean of the top ``1 - discard_ratio`` of its voxels BY
    COUNT (analyses.py:48-52: ``sorted[floor(n * ratio):]``), labels
    1..max_labels, (max_labels,) f32; NaN for absent labels."""
    sorted_lab, sorted_raw, counts, starts = sort_by_label(raw, labels,
                                                           max_labels)
    rank = torch.arange(sorted_raw.shape[0], device=sorted_raw.device) \
        - starts[sorted_lab]
    thresh = torch.floor(counts[sorted_lab].to(torch.float32)
                         * discard_ratio)
    keep = (rank.to(torch.float32) >= thresh) & (sorted_lab > 0)
    return masked_label_mean(sorted_lab, sorted_raw, keep, max_labels)


def get_activities(raw_path: str, tracked_labels_path: str,
                   volume_num: int, layer_num: int,
                   discard_ratio: float = 0.1, *,
                   device=None) -> np.ndarray:
    """(volume_num, cells) activities from per-(t, z) TIFF patterns of the
    raw recording and the tracked labels (analyses.py:15-99); the cells
    are vol 1's labels, and a cell absent from a volume reads 0.0, as in
    the reference's quick variant.  ``device``: the card by default."""
    dev = select_device(device)
    labels0 = read_image_ts(1, tracked_labels_path, (1, layer_num + 1))
    cell_num = int(labels0.max())
    activities = np.zeros((volume_num, cell_num))
    for frame in range(1, volume_num + 1):
        raw = read_image_ts(frame, raw_path, (1, layer_num + 1))
        labels = labels0 if frame == 1 else read_image_ts(
            frame, tracked_labels_path, (1, layer_num + 1))
        act = mean_excluding_bottom(
            torch.from_numpy(raw.astype(np.float32)).to(dev),
            torch.from_numpy(labels.astype(np.int32)).to(dev), cell_num,
            discard_ratio=discard_ratio).cpu().numpy()
        activities[frame - 1] = np.nan_to_num(act, nan=0.0)
    return activities


# the reference's bbox-accelerated variant is the same device pass (the
# reduction touches each voxel once); kept as an alias for API parity
get_activities_quick = get_activities
