"""v1.0 single-mode tracking on the card (the port's counterpart of
``examples/track_stardist_single_mode.py``; reference
Examples/use_stardist/track_stardist_single_mode.ipynb).

    python -m 3deecelltracker_tpu_torch.scripts.track_stardist_single_mode \\
        --images "raw/worm1_t%03i_z*.tif" --ffn-weights ffn.npz
    # proofread results/auto_vol1/ into results/manual_vol1/, then
    python -m 3deecelltracker_tpu_torch.scripts.track_stardist_single_mode \\
        --images "raw/worm1_t%03i_z*.tif" --ffn-weights ffn.npz \\
        --skip-segmentation

Data contract: all 3-D images in one directory, each volume a stack of
2-D TIFF slices, the file names embedding time through a printf pattern
(``"worm1_t%03i_z*.tif"``); or an HDF5 recording ``{"h5_file", "channel",
"dset"}`` (``scripts.track_stardist_h5``).  The first run segments every
volume into ``seg/`` and ``auto_vol1/``; the second tracks them and
writes ``track_results/`` with the matching figures under its
``figure/`` (as the example, ``save_figures=True``; they need matplotlib,
and ``--no-figures`` leaves them out) and the coordinates CSV.
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..config import TrackingConfig
from ..engine import load_stardist_model, predict_and_save, track_timelapse
from ..io.artifacts import ResultsTree
from ..io.imageio import get_t_range
from ..utils.cache import enable_compilation_cache


def main(argv: Optional[Sequence[str]] = None):
    """Runs the example's step; returns the tracked ``{t: (n, 3) real
    coordinates}``, or None after the segmentation step."""
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True,
                    help='e.g. "raw/worm1_t%%03i_z*.tif"')
    ap.add_argument("--results", default="results")
    ap.add_argument("--stardist-model", default="stardist")
    ap.add_argument("--stardist-basedir", default="stardist_models")
    ap.add_argument("--ffn-weights", required=True,
                    help=".npz from TrainFFN")
    ap.add_argument("--voxel-size", nargs=3, type=float,
                    default=[1, 1, 9.2])
    ap.add_argument("--interpolation-factor", type=int, default=10)
    ap.add_argument("--beta", type=float, default=3.0)
    ap.add_argument("--lambda", dest="lambda_", type=float, default=3.0)
    ap.add_argument("--skip-segmentation", action="store_true",
                    help="seg/ artifacts already exist")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--no-figures", action="store_true",
                    help="draw no matching figures (they need matplotlib)")
    args = ap.parse_args(argv)

    model = load_stardist_model(args.stardist_model, args.stardist_basedir,
                                device=args.device)
    if not args.skip_segmentation:
        predict_and_save(args.images, model, args.results)
        print("Now manually correct results/auto_vol1 into "
              "results/manual_vol1 (e.g. with ITK-SNAP), then re-run "
              "with --skip-segmentation.")
        return None

    t_max, t_min = get_t_range(args.images)
    coords = track_timelapse(
        args.results, f"{args.results}/manual_vol1/*.tif",
        args.ffn_weights,
        voxel_size=tuple(args.voxel_size),
        interpolation_factor=args.interpolation_factor,
        t_range=(t_min, t_max), grid=model.config.grid,
        config=TrackingConfig(beta=args.beta, lambda_=args.lambda_),
        images_path=args.images, save_figures=not args.no_figures,
        device=model.device)
    ResultsTree(args.results).export_coordinates_csv(coords)
    print(f"Tracked {len(coords)} volumes.")
    return coords


if __name__ == "__main__":
    main()
