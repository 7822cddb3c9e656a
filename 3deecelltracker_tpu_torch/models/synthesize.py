"""Training-data synthesis for the FFN matcher (the port's copy of
``3deecelltracker_tpu/models/synthesize.py``; reference ``synthesize.py``).

Host numpy, drawing from the caller's ``np.random.RandomState`` in the
same order as the JAX package, so that one seed gives the same clouds:

- ``affine_transform``: a random affine (+-affine_level) plus jitter
  (synthesize.py:75-85);
- ``add_seg_errors``: a ratio of the points replaced by KDE samples; a
  gaussian KDE sample is a random data point plus N(0, bandwidth^2) noise,
  as sklearn's ``KernelDensity(bandwidth).sample`` (synthesize.py:52-72);
- ``no_match_points``: partner points that are never the point itself
  (synthesize.py:39-49).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

RATIO_SEG_ERROR = 0.15
K_NEIGHBORS = 20


def affine_transform(points: np.ndarray, affine_level: float,
                     rand_move_level: float,
                     rng: np.random.RandomState) -> np.ndarray:
    random_transform = (rng.rand(3, 3) - 0.5) * affine_level
    random_movements = (rng.rand(*points.shape) - 0.5) * 4 * rand_move_level
    return points @ (np.eye(3) + random_transform) + random_movements


def add_seg_errors(points_normalized: np.ndarray,
                   ratio: float = RATIO_SEG_ERROR,
                   bandwidth: float = 0.1,
                   rng: np.random.RandomState = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Replace ``ratio`` of the points with KDE samples of the cloud;
    returns the new cloud and the replaced rows."""
    if not 0 < ratio < 1:
        raise ValueError(f"ratio should be in (0, 1) but = {ratio}")
    rng = rng or np.random.RandomState()
    n = points_normalized.shape[0]
    new_points = points_normalized.copy()
    k = int(np.ceil(n * ratio))
    replaced = rng.permutation(n)[:k]
    src = rng.randint(0, n, size=k)
    new_points[replaced] = points_normalized[src] + \
        rng.randn(k, 3) * bandwidth
    return new_points, replaced


def no_match_points(n: int, points_wi_errors: np.ndarray,
                    rng: np.random.RandomState) -> np.ndarray:
    """Partner points guaranteed != self (synthesize.py:39-49)."""
    idx = rng.permutation(n)
    own = np.arange(n)
    partner = np.where(idx == own, idx[own - 1], idx)
    return points_wi_errors[partner]
