"""The scene's truth as the reference for what the program finds and tracks.

The recording is made by the benchmark, so every cell's true centre in
every volume is known (``harness.scene``).  Two of the program's answers
are held to it: the instances its segmentation keeps (each true cell found
once, nothing found where no cell is) and the coordinates its tracker
gives vol 1's cells in every later volume.  The identity rules are a
frozen copy of the port's ``engine/metrics.py::tracking_accuracy`` and
``tracking_id_metrics`` (themselves ``bench.py::tracking_id_metrics``):
identities assigned one to one at t = 1 by greedy nearest pairs, at a gate
of half the median nearest-neighbour spacing of the true t = 1 cloud.

Coordinates are in real units: (z, y, x) voxels scaled by ``zyx_scale``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def gate(centres_real: np.ndarray) -> float:
    """Half the median nearest-neighbour spacing of a true cloud."""
    d = np.linalg.norm(centres_real[:, None] - centres_real[None], axis=2)
    np.fill_diagonal(d, np.inf)
    return 0.5 * float(np.median(d.min(axis=1)))


def greedy_pairs(a: np.ndarray, b: np.ndarray, radius: float
                 ) -> np.ndarray:
    """(len(a),) index into ``b`` of each row of ``a`` paired one to one by
    ascending distance, -1 where no partner lies within ``radius``."""
    out = np.full(len(a), -1, np.int64)
    if len(a) == 0 or len(b) == 0:
        return out
    d = np.linalg.norm(a[:, None] - b[None], axis=2)
    used = np.zeros(len(b), bool)
    for flat in np.argsort(d, axis=None):
        i, j = divmod(int(flat), len(b))
        if d[i, j] > radius:
            break
        if out[i] >= 0 or used[j]:
            continue
        out[i] = j
        used[j] = True
    return out


def instances_against_truth(points_real: np.ndarray, truth_real: np.ndarray,
                            radius: float) -> Tuple[int, int]:
    """(true cells with no kept instance within ``radius``, kept instances
    with no true cell), pairs one to one."""
    pair = greedy_pairs(truth_real, points_real, radius)
    missed = int((pair < 0).sum())
    extra = int(len(points_real) - (pair >= 0).sum())
    return missed, extra


def tracking_errors(coords: Dict[int, np.ndarray],
                    truth: Dict[int, np.ndarray], radius: float,
                    axes=(0, 1, 2)
                    ) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """({t: (n,) distance of each tracked vol-1 cell from the true centre
    of the cell it was given at t = 1}, {t: (n,) distance, over ``axes``,
    between the cell's tracked move since t = 1 and its true move}).  The
    second leaves out where a cell's vol-1 centre sits against its true
    centre, which the proofread labels fix once.  A tracked row with no
    true cell within ``radius`` at t = 1 is given none and reads infinity
    in both."""
    ident = greedy_pairs(coords[1], truth[1], radius)
    j = np.maximum(ident, 0)
    ax = list(axes)
    pos, move = {}, {}
    for t in sorted(coords):
        d = np.linalg.norm(coords[t] - truth[t][j], axis=1)
        e = (coords[t] - coords[1]) - (truth[t][j] - truth[1][j])
        pos[t] = np.where(ident >= 0, d, np.inf)
        move[t] = np.where(ident >= 0, np.linalg.norm(e[:, ax], axis=1),
                           np.inf)
    return pos, move
