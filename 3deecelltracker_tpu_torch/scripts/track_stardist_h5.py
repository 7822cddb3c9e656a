"""v1.0 tracking from an HDF5 recording on the card (the port's counterpart
of ``examples/track_stardist_h5.py``; reference
Examples/use_stardist/track_stardist_single_mode-h5.ipynb).

    python -m 3deecelltracker_tpu_torch.scripts.track_stardist_h5 \\
        --h5 recording.h5 --channel 0 \\
        --stardist-model stardist_worm4 --ffn-weights ffn.npz \\
        --results ./results
    # proofread results/auto_vol1/ into results/manual_vol1/, then
    python -m 3deecelltracker_tpu_torch.scripts.track_stardist_h5 \\
        --h5 recording.h5 --channel 0 \\
        --stardist-model stardist_worm4 --ffn-weights ffn.npz \\
        --results ./results --skip-segmentation

Data contract (``stardistwrapper.py:50-72``): one HDF5 dataset of shape
(Time, Channel, Depth, Height, Width), addressed by ``{"h5_file": path,
"channel": c, "dset": "default"}``; ``io.imageio.save_recording_h5``
writes it from a TIFF series.  Reading it needs ``h5py``.  The StarDist
model folder is either format ``engine.stardist.load_stardist_model``
takes (the port's ``weights.npz`` folder, or the reference's Keras folder,
which also needs ``h5py``); ``--ffn-weights`` an ``.npz`` or a Keras
``.h5``.  The first run segments every volume into ``seg/`` and
``auto_vol1/``; the second (``--skip-segmentation``) tracks them and
writes ``track_results/`` with the matching figures under its
``figure/`` (as the example, ``save_figures=True``; they need matplotlib,
and ``--no-figures`` leaves them out) and the coordinates CSV.
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..config import TrackingConfig
from ..engine.pipeline import track_timelapse
from ..engine.stardist import load_stardist_model, predict_and_save
from ..io.artifacts import ResultsTree
from ..io.imageio import get_t_range
from ..utils.cache import enable_compilation_cache


def main(argv: Optional[Sequence[str]] = None):
    """Runs the example's step; returns the tracked ``{t: (n, 3) real
    coordinates}``, or None after the segmentation step."""
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--h5", required=True, help="HDF5 recording (TCZYX)")
    ap.add_argument("--channel", type=int, default=0)
    ap.add_argument("--dset", default="default")
    ap.add_argument("--results", default="results")
    ap.add_argument("--stardist-model", default="stardist")
    ap.add_argument("--stardist-basedir", default="stardist_models")
    ap.add_argument("--ffn-weights", required=True)
    ap.add_argument("--voxel-size", nargs=3, type=float,
                    default=[1, 1, 1])
    ap.add_argument("--interpolation-factor", type=int, default=1)
    ap.add_argument("--beta", type=float, default=3.0)
    ap.add_argument("--lambda", dest="lambda_", type=float, default=3.0)
    ap.add_argument("--ensemble", type=int, default=0,
                    help="ensemble member count (0 = single mode)")
    ap.add_argument("--skip-segmentation", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--no-figures", action="store_true",
                    help="draw no matching figures (they need matplotlib)")
    args = ap.parse_args(argv)

    images_path = {"h5_file": args.h5, "channel": args.channel,
                   "dset": args.dset}
    model = load_stardist_model(args.stardist_model, args.stardist_basedir,
                                device=args.device)

    if not args.skip_segmentation:
        predict_and_save(images_path, model, args.results)
        print("Now manually correct results/auto_vol1 into "
              "results/manual_vol1 (e.g. with ITK-SNAP), then re-run "
              "with --skip-segmentation.")
        return None

    t_max, t_min = get_t_range(images_path)
    cfg = TrackingConfig(beta=args.beta, lambda_=args.lambda_,
                         ensemble=bool(args.ensemble),
                         sampling_number=args.ensemble or 20)
    coords = track_timelapse(
        args.results, f"{args.results}/manual_vol1/*.tif",
        args.ffn_weights,
        voxel_size=tuple(args.voxel_size),
        interpolation_factor=args.interpolation_factor,
        t_range=(t_min, t_max), grid=model.config.grid,
        config=cfg, images_path=images_path,
        save_figures=not args.no_figures, device=model.device)
    ResultsTree(args.results).export_coordinates_csv(coords)
    print(f"Tracked {len(coords)} volumes from {args.h5}.")
    return coords


if __name__ == "__main__":
    main()
