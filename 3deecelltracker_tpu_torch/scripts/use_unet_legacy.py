"""The legacy v0.4 U-Net workflow on the card (the port's counterpart of
``examples/use_unet_legacy.py``; reference Examples/use_unet
single_mode_worm1-clear.ipynb / ensemble_mode_worm4-clear.ipynb).

    python -m 3deecelltracker_tpu_torch.scripts.use_unet_legacy \\
        --folder F --volume-num 21 --siz-xyz 401 168 24
    # proofread F/auto_vol1/ into F/manual_vol1/, then
    python -m 3deecelltracker_tpu_torch.scripts.use_unet_legacy \\
        --folder F --volume-num 21 --siz-xyz 401 168 24 --skip-segmentation

Folder layout (made by the tracker, tracker.py:738-753): ``data/`` the raw
per-(t, z) TIFFs named by ``--image-name``, ``models/`` the U-Net and FFN
``.npz`` checkpoints, ``manual_vol1/`` the proofread vol-1 labels.  The
first run segments vol 1 into ``auto_vol1/`` for proofreading; the second
(``--skip-segmentation``) optionally retrains the U-Net on the proofread
vol 1 (``--retrain N`` epochs, then the epoch with the least validation
loss), tracks every volume and writes the labels and
``track_information/tracked_coordinates.csv``.  ``--device cpu`` runs on
the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..engine.legacy import Tracker
from ..utils.cache import enable_compilation_cache


def main(argv: Optional[Sequence[str]] = None) -> Tracker:
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--folder", required=True)
    ap.add_argument("--image-name", default="raw_t%04i_z%04i.tif")
    ap.add_argument("--volume-num", type=int, required=True)
    ap.add_argument("--siz-xyz", nargs=3, type=int, required=True)
    ap.add_argument("--z-xy-ratio", type=float, default=9.2)
    ap.add_argument("--z-scaling", type=int, default=10)
    ap.add_argument("--noise-level", type=float, default=200)
    ap.add_argument("--min-size", type=int, default=100)
    ap.add_argument("--beta", type=float, default=300)
    ap.add_argument("--lambda", dest="lambda_", type=float, default=0.1)
    ap.add_argument("--maxiter", type=int, default=20)
    ap.add_argument("--unet-model", default="unet3_pretrained.npz")
    ap.add_argument("--ffn-model", default="ffn_model.npz")
    ap.add_argument("--ensemble", type=int, default=0,
                    help="0 = single mode; N = N-member ensemble")
    ap.add_argument("--adjacent", action="store_true")
    ap.add_argument("--retrain", type=int, default=0,
                    help="retrain U-Net for N epochs on manual vol 1")
    ap.add_argument("--skip-segmentation", action="store_true",
                    help="manual_vol1/ proofread labels already exist")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    tracker = Tracker(
        volume_num=args.volume_num, siz_xyz=tuple(args.siz_xyz),
        z_xy_ratio=args.z_xy_ratio, z_scaling=args.z_scaling,
        noise_level=args.noise_level, min_size=args.min_size,
        beta_tk=args.beta, lambda_tk=args.lambda_, maxiter_tk=args.maxiter,
        folder_path=args.folder, image_name=args.image_name,
        unet_model_file=args.unet_model, ffn_model_file=args.ffn_model,
        ensemble=args.ensemble or False, adjacent=args.adjacent,
        device=args.device)
    tracker.load_unet()
    tracker.load_ffn()
    # two phases, as in the reference notebooks: segmentation first, then
    # the user proofreads auto_vol1/ into manual_vol1/
    if not args.skip_segmentation:
        tracker.segment_vol1()
        print("Now manually correct auto_vol1/ into manual_vol1/ (e.g. "
              "with ITK-SNAP), then re-run with --skip-segmentation.")
        return tracker
    tracker.load_manual_seg()
    if args.retrain:
        val_losses = tracker.retrain_unet(iteration=args.retrain)
        # checkpoints exist only at improvements; step 0 restores the
        # initial weights when no epoch beat the loss before retraining
        tracker.select_unet_weights(int(np.argmin(val_losses)))
        # the cached probabilities are the old weights'
        tracker.set_segmentation(del_cache=True)
    # initiate_tracking starts from vol 1's segmented centres, which only
    # segment_vol1 sets: the example's second phase omits this call and
    # stops with an AttributeError there.  Without retraining, the U-Net
    # cache of the first phase makes it cheap.
    tracker.segment_vol1()
    tracker.interpolate_seg()
    tracker.cal_subregions()
    tracker.initiate_tracking()
    tracker.track(from_volume=2)
    tracker.save_coordinates()
    return tracker


if __name__ == "__main__":
    main()
