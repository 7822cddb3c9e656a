"""Train the FFN matcher on the card (the port's counterpart of
``examples/train_ffn.py``; reference FFN training notebook,
``ffn.py:148-222``) from a txt/CSV point cloud or a proofed label volume.

    python -m 3deecelltracker_tpu_torch.scripts.train_ffn \\
        --segmentation "results/manual_vol1/*.tif" --voxel-size 1 1 9.2

Writes ``basedir/weights/weights_training__epoch<n>.npz`` per epoch and
``basedir/<model-name>.npz`` in the JAX package's layout.  ``--device
cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..models.train_ffn import TrainFFN
from ..utils.cache import enable_compilation_cache


def main(argv: Optional[Sequence[str]] = None) -> list:
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-name", default="ffn_model")
    ap.add_argument("--points", help="txt/CSV of (n, 3) cell positions")
    ap.add_argument("--segmentation",
                    help='glob of proofed vol-1 label slices, e.g. '
                         '"results/manual_vol1/*.tif"')
    ap.add_argument("--voxel-size", nargs=3, type=float, default=[1, 1, 1])
    ap.add_argument("--basedir", default="ffn_models")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--iterations", type=int, default=5000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    trainer = TrainFFN(args.model_name, points1_path=args.points,
                       segmentation1_path=args.segmentation,
                       voxel_size=tuple(args.voxel_size),
                       basedir=args.basedir, device=args.device)
    return trainer.train(num_epochs=args.epochs, iteration=args.iterations)


if __name__ == "__main__":
    main()
