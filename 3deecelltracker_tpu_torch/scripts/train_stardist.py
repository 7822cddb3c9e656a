"""Train StarDist3D on the card (the port's counterpart of
``examples/train_stardist.py``; reference Examples/use_stardist training
notebook).

    python -m 3deecelltracker_tpu_torch.scripts.train_stardist \\
        --train-images "train/images/*.tif" --train-labels "train/masks/*.tif"

Takes pairs of multi-page 3-D TIFF volumes with matching file names (the
``load_training_images`` contract; every page of each file is read), sizes
the config from the labels (``configure``), trains with validation,
ReduceLROnPlateau and best-val weights, then tunes the prob/nms thresholds
on the validation volumes and saves the model folder ``basedir/model_name``
in the JAX package's format.  ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from ..engine.metrics import optimize_thresholds
from ..engine.stardist import StarDist3D, configure, load_training_images
from ..models.train_stardist import TrainStarDist3D
from ..utils.cache import enable_compilation_cache


def main(argv: Optional[Sequence[str]] = None) -> Path:
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-images", required=True)
    ap.add_argument("--train-labels", required=True)
    ap.add_argument("--basedir", default="stardist_models")
    ap.add_argument("--model-name", default="stardist")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--steps-per-epoch", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    (X, Y, X_trn, Y_trn, X_val, Y_val,
     n_channel) = load_training_images(args.train_images,
                                       args.train_labels, plot=False)
    cfg = configure(Y, n_channel=n_channel)
    print("config:", cfg)
    trainer = TrainStarDist3D(cfg, basedir=args.basedir,
                              model_name=args.model_name,
                              device=args.device)
    trainer.train(X_trn, Y_trn, epochs=args.epochs,
                  steps_per_epoch=args.steps_per_epoch,
                  X_val=X_val, Y_val=Y_val)

    model_dir = Path(args.basedir) / args.model_name
    model = StarDist3D.load(model_dir, device=args.device)
    optimize_thresholds(model, X_val, Y_val)
    model.save(model_dir)
    print(f"saved model (with optimized thresholds) to {model_dir}")
    return model_dir


if __name__ == "__main__":
    main()
