"""The self-contained end-to-end demo on the card, no download (the port's
counterpart of ``examples/synthetic_demo.py``): it makes a synthetic
3-D + T recording of drifting cells, trains a small StarDist3D and the
FFN, segments, tracks and reads the activities.

    python -m 3deecelltracker_tpu_torch.scripts.synthetic_demo \\
        --out /tmp/t3dct_demo
    python -m 3deecelltracker_tpu_torch.scripts.synthetic_demo \\
        --out /tmp/t3dct_demo --device cpu

The recording is the example's, bit for bit (:func:`make_volume`, the
same seeds), and so are the recipe's settings (``SD_EPOCHS`` x
``SD_STEPS`` StarDist steps, ``FFN_ITERATIONS`` FFN iterations).  The
example tracks with ``save_figures=True``; the matching figures are not
ported yet (ROADMAP.md A.9), so the demo passes ``save_figures=False``
and draws none.  ``--h5`` drives the same recording through one HDF5
file (it needs ``h5py``).  Prints each stage's seconds and the median
tracking error at the last volume, as the example prints it.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..config import StarDistConfig, TrackingConfig
from ..coordinates import Coordinates
from ..engine import StarDist3D, predict_and_save, track_timelapse
from ..engine.tracker import TrackerLite
from ..io.artifacts import ResultsTree
from ..io.imageio import save_label_slices, save_recording_h5
from ..models.train_ffn import TrainFFN
from ..models.train_stardist import TrainStarDist3D

SHAPE_ZYX = (16, 64, 64)
Z_RATIO = 2.0
N_VOLS = 6
N_CELLS = 8
# the example's recipe (examples/synthetic_demo.py:99-103, :120)
SD_EPOCHS = 8
SD_STEPS = 30
FFN_ITERATIONS = 200


def make_volume(t, centers0, drift, rng):
    """Volume t of the recording and its labels (the example's
    ``make_volume``)."""
    centers = centers0 + (t - 1) * drift
    zz, yy, xx = np.mgrid[:SHAPE_ZYX[0], :SHAPE_ZYX[1], :SHAPE_ZYX[2]]
    img = rng.rand(*SHAPE_ZYX) * 0.1
    lab = np.zeros(SHAPE_ZYX, np.int32)
    for i, (cz, cy, cx) in enumerate(centers):
        d2 = ((zz - cz) * Z_RATIO) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2
        img += np.exp(-d2 / 18.0)
        lab[d2 < 16] = i + 1
    return img.astype(np.float32), lab


def cells():
    """The cells' first centres (z, y, x) and drift per volume."""
    rng = np.random.RandomState(0)
    centers0 = np.stack([np.full(N_CELLS, 8.0),
                         rng.uniform(10, 54, N_CELLS),
                         rng.uniform(10, 54, N_CELLS)], 1).astype(np.float32)
    drift = np.stack([np.zeros(N_CELLS),
                      rng.uniform(-0.7, 0.7, N_CELLS),
                      rng.uniform(-0.7, 0.7, N_CELLS)], 1).astype(np.float32)
    return centers0, drift


def recording_volume(t, centers0, drift) -> np.ndarray:
    """Volume t as the recording stores it: uint16, (z, y, x)."""
    img, _ = make_volume(t, centers0, drift, np.random.RandomState(t))
    return (img / img.max() * 40000).astype(np.uint16)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the demo; returns ``{"seconds": {stage: s}, "median_error",
    "results"}``, the error in real units at t = ``N_VOLS``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/t3dct_demo")
    ap.add_argument("--h5", action="store_true",
                    help="pack the recording into one (T, C, Z, Y, X) h5 "
                         "and drive the pipeline through it")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    raw_dir = out / "raw"
    results = out / "results"
    images_path = str(raw_dir / "raw_t%03i_z*.tif")
    seconds = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        print(f"   {name}: {seconds[name]:.2f} s")
        clock[0] = now

    centers0, drift = cells()
    print("== generating synthetic recording")
    vols = [recording_volume(t, centers0, drift)
            for t in range(1, N_VOLS + 1)]
    if args.h5:
        save_recording_h5(out / "recording.h5", vols)
        images_path = {"h5_file": str(out / "recording.h5"), "channel": 0}
    else:
        for t, img16 in enumerate(vols, start=1):
            save_label_slices(img16.transpose(1, 2, 0), raw_dir,
                              "raw_t%03i_z%04i.tif", t, use_8_bit=False,
                              compression=None)
    img1, lab1 = make_volume(1, centers0, drift, np.random.RandomState(1))
    img1n = (img1 - np.percentile(img1, 1)) / \
        (np.percentile(img1, 99.8) - np.percentile(img1, 1))
    lap("recording")

    print("== training StarDist3D")
    cfg = StarDistConfig(n_rays=16, grid=(1, 2, 2),
                         anisotropy=(Z_RATIO, 1, 1),
                         unet_n_filter_base=8, net_conv_after_unet=16,
                         train_patch_size=SHAPE_ZYX, prob_thresh=0.2)
    TrainStarDist3D(cfg, basedir=out / "sd_models", max_dist=10,
                    learning_rate=3e-3, device=args.device).train(
        [img1n], [lab1], epochs=SD_EPOCHS, steps_per_epoch=SD_STEPS)
    model = StarDist3D.load(out / "sd_models" / "stardist",
                            device=args.device)
    model.max_candidates = 64
    model.render_box = (9, 17, 17)
    lap("train_stardist")

    print("== segmenting all volumes")
    predict_and_save(images_path, model, results)
    lap("segment")

    print("== 'manual' correction (using ground truth labels)")
    save_label_slices(lab1.transpose(1, 2, 0), results / "manual_vol1",
                      "manual_vol1_t%04i_z%04i.tif", 0, use_8_bit=True,
                      compression=None)

    print("== training FFN")
    cloud = np.concatenate([
        centers0[:, [1, 2, 0]] * np.array([1, 1, Z_RATIO])
        + np.random.RandomState(k).randn(N_CELLS, 3) * 2
        for k in range(8)])
    np.savetxt(out / "pts.txt", cloud)
    ffn = TrainFFN("ffn", points1_path=str(out / "pts.txt"),
                   basedir=out / "ffn", device=args.device)
    ffn.train(num_epochs=1, iteration=FFN_ITERATIONS, verbose=False)
    lap("train_ffn")

    print("== tracking")
    coords = track_timelapse(
        results, str(results / "manual_vol1" / "*.tif"),
        (ffn.params, ffn.bn_state),
        voxel_size=(1, 1, Z_RATIO), interpolation_factor=2,
        t_range=(1, N_VOLS), grid=cfg.grid,
        config=TrackingConfig(beta=10.0, lambda_=3.0),
        images_path=images_path, save_figures=False, device=model.device)
    ResultsTree(results).export_coordinates_csv(coords)
    lap("track")

    print("== activities")
    vol1 = Coordinates.from_real(coords[1], 2, (1, 1, Z_RATIO),
                                 device=model.device)
    tracker = TrackerLite(results, (ffn.params, ffn.bn_state), vol1)
    acts = tracker.activities(images_path, do_normalize=False)
    ResultsTree(results).export_activities_csv(acts)
    lap("activities")

    # cell ids get relabeled in raster order during interpolation; recover
    # the id permutation by nearest-neighbour assignment at t=1
    true1 = centers0[:, [1, 2, 0]] * np.array([1, 1, Z_RATIO])
    d1 = np.linalg.norm(coords[1][:, None, :] - true1[None, :, :], axis=2)
    assign = d1.argmin(axis=1)           # tracked id -> true id
    true_t = (centers0 + (N_VOLS - 1) * drift)[:, [1, 2, 0]] * \
        np.array([1, 1, Z_RATIO])
    err = float(np.median(np.linalg.norm(coords[N_VOLS] - true_t[assign],
                                         axis=1)))
    print(f"median tracking error at t={N_VOLS}: {err:.2f} (real units)")
    print(f"artifacts under {results}")
    return dict(seconds=seconds, median_error=err, results=results)


if __name__ == "__main__":
    main()
