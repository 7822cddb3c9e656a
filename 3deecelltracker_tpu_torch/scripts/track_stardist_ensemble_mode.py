"""v1.0 ensemble-mode tracking on the card (the port's counterpart of
``examples/track_stardist_ensemble_mode.py``; reference
Examples/use_stardist/track_stardist_ensemble_mode.ipynb): each volume is
predicted from up to ``--ensemble`` earlier reference volumes, combined
by a 10% trimmed mean.

    python -m 3deecelltracker_tpu_torch.scripts.track_stardist_ensemble_mode \\
        --images "raw/worm1_t%03i_z*.tif" --ffn-weights ffn.npz
    # proofread results/auto_vol1/ into results/manual_vol1/, then
    python -m 3deecelltracker_tpu_torch.scripts.track_stardist_ensemble_mode \\
        --images "raw/worm1_t%03i_z*.tif" --ffn-weights ffn.npz \\
        --skip-segmentation

On one card the members run as one batch (``parallel.ensemble``); over
several, ``track_timelapse(mesh=)`` splits them over the ranks.  The
example's matching figures (``save_figures=True``) are not ported yet
(ROADMAP.md A.9), so none is drawn.  ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..config import TrackingConfig
from ..engine import load_stardist_model, predict_and_save, track_timelapse
from ..io.artifacts import ResultsTree
from ..io.imageio import get_t_range


def main(argv: Optional[Sequence[str]] = None):
    """Runs the example's step; returns the tracked ``{t: (n, 3) real
    coordinates}``, or None after the segmentation step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True)
    ap.add_argument("--results", default="results")
    ap.add_argument("--stardist-model", default="stardist")
    ap.add_argument("--stardist-basedir", default="stardist_models")
    ap.add_argument("--ffn-weights", required=True)
    ap.add_argument("--voxel-size", nargs=3, type=float,
                    default=[1, 1, 9.2])
    ap.add_argument("--interpolation-factor", type=int, default=10)
    ap.add_argument("--ensemble", type=int, default=20)
    ap.add_argument("--adjacent", action="store_true")
    ap.add_argument("--skip-segmentation", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    model = load_stardist_model(args.stardist_model, args.stardist_basedir,
                                device=args.device)
    if not args.skip_segmentation:
        predict_and_save(args.images, model, args.results)
        print("Correct auto_vol1 -> manual_vol1, then re-run with "
              "--skip-segmentation.")
        return None

    t_max, t_min = get_t_range(args.images)
    coords = track_timelapse(
        args.results, f"{args.results}/manual_vol1/*.tif",
        args.ffn_weights,
        voxel_size=tuple(args.voxel_size),
        interpolation_factor=args.interpolation_factor,
        t_range=(t_min, t_max), grid=model.config.grid,
        config=TrackingConfig(ensemble=True,
                              sampling_number=args.ensemble,
                              adjacent=args.adjacent),
        images_path=args.images, device=model.device)
    ResultsTree(args.results).export_coordinates_csv(coords)
    return coords


if __name__ == "__main__":
    main()
