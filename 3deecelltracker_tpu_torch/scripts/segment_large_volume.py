"""Segment a volume too large for one backbone pass, tile by tile, on the
card (the port's counterpart of ``examples/segment_large_volume.py``).

    python -m 3deecelltracker_tpu_torch.scripts.segment_large_volume
    python -m 3deecelltracker_tpu_torch.scripts.segment_large_volume \\
        --shape 32 256 256 --device cpu

The example's zebrafish-class (64, 512, 512) volume of uniform noise
(``np.random.default_rng(0)``), its StarDist3D config with a seeded
random init, and its tiled settings: tiles of (None, 192, 192) with a
shrink of (0, 48, 48) (below the receptive field, for speed; drop
``shrink`` for centres equal to the whole-volume pass) and 128 candidates
a tile, through ``StarDist3D.predict_instances_tiled``.  ``--repeat``
runs it again and prints each call's seconds (the first includes the
kernels' build).  ``--sharded`` (tiles over several cards) is not ported
yet (ROADMAP.md A.5).  ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from ..config import StarDistConfig
from ..engine.stardist import StarDist3D

# examples/segment_large_volume.py:58-64, 72-73
CONFIG = dict(n_rays=32, grid=(2, 4, 4), anisotropy=(2.0, 1.0, 1.0),
              unet_n_depth=1, unet_n_filter_base=8, net_conv_after_unet=16,
              train_patch_size=(16, 32, 32), prob_thresh=0.8,
              nms_thresh=0.3)
TILED = dict(shrink=(0, 48, 48), tile_candidates=128)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the example; returns ``{"shape", "labels_shape", "instances",
    "prob_map_shape", "seconds"}`` (``seconds``: one entry per call)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=(64, 512, 512),
                    help="(z, y, x) volume shape")
    ap.add_argument("--tile", type=int, nargs=2, default=(192, 192),
                    help="(y, x) tile size (z untiled)")
    ap.add_argument("--sharded", action="store_true",
                    help="fan tiles out over several cards (not ported)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="calls to time (the first builds the kernels)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    if args.sharded:
        raise NotImplementedError(
            "--sharded (tiles over several cards) is not ported yet "
            "(ROADMAP.md A.5)")

    model = StarDist3D(StarDistConfig(**CONFIG), max_candidates=512,
                       render_box=(9, 17, 17), device=args.device)
    x = np.random.default_rng(0).random(tuple(args.shape), np.float32)
    tile_shape = (None, args.tile[0], args.tile[1])
    seconds = []
    for _ in range(max(1, args.repeat)):
        t0 = time.perf_counter()
        (labels, details), prob_map = model.predict_instances_tiled(
            x, tile_shape=tile_shape, **TILED)
        seconds.append(time.perf_counter() - t0)
    print(f"volume {x.shape} -> labels {labels.shape}, "
          f"{len(details['prob'])} instances, prob_map {prob_map.shape}")
    print(f"sequential tiles on {model.device}: "
          + ", ".join(f"{s:.3f} s" for s in seconds)
          + " (the first call builds the kernels)")
    return dict(shape=x.shape, labels_shape=labels.shape,
                instances=len(details["prob"]),
                prob_map_shape=prob_map.shape, seconds=seconds)


if __name__ == "__main__":
    main()
