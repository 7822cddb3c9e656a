"""The committed legacy assets (``3deecelltracker_tpu_torch/assets/
legacy/``): U-Net a weights trained by JAX's ``TrainingUNet3D`` on the
bench scene, and JAX's records of the legacy v0.4 workflow over that scene,
which ``chip_smoke.py`` phases 18-20 hold the card to.

The weights (``unet3_a.npz``, JAX's ``save_pytree`` of ``(params,
bn_state)``): JAX's ``TrainingUNet3D(noise_level=200, model=unet3_a(),
seed=0, batch_size=8)`` (learning rate 1e-3) on vol 1 of the bench scene
(``utils/synthetic.make_recording``: 150 cells, (z, y, x) = (24, 401,
168), seed 0) in the legacy (x, y, z) frame (401, 168, 24), its
ground-truth labels > 0 as the cell mask, the same volume for training and
validation; ``train(iteration=WEIGHTS_EPOCHS, steps_per_epoch=
WEIGHTS_STEPS)`` (about 30 minutes on an 8-core CPU: ~33 s a step and ~50 s
a validation pass), then ``select_weights`` of the epoch with the least
validation loss.

The records, each JAX's folder ``Tracker`` over the 21 volumes written as
``raw_t%04i_z%04i.tif`` slices, with ``manual_vol1/`` set to the ground
truth and ``examples/use_unet_legacy.py``'s defaults (z_xy_ratio 9.2,
z_scaling 10, noise_level 200, min_size 100, beta 300, lambda 0.1,
maxiter 20), ``max_cells`` 512, through the example's flow
(``load_unet``, ``load_ffn``, ``segment_vol1``, ``load_manual_seg``,
``interpolate_seg``, ``cal_subregions``, ``initiate_tracking``,
``track(2)``, ``save_coordinates``), the FFN the committed
``assets/bench/ffn.npz``:

- ``jax_legacy_record.npz``: single mode;
- ``jax_legacy_record_ensemble.npz``: ``ensemble=20`` (distributed) in
  the same folder afterwards, its ``unet_cache/`` cleared first
  (``set_segmentation(del_cache=True)``) so that the U-Net runs again;
- ``jax_unet_train_record.npz``: JAX's first ``TRAIN_STEPS`` steps of
  ``retrain_unet`` from the trained weights (epoch 1, ``np.random.
  RandomState(1)``): each step's patch start and the eight affine draws
  (matrix, offset) of its augmented batch, its loss, and the update norm
  ``|theta_t - theta_0|`` of every parameter leaf; the same steps from the
  weights nudged by one ulp (a random sign per element from each seed of
  ``NUDGE_SEEDS``), their losses and norms, for JAX's own spread.

These two are written through ``Float32Tracker``, which builds JAX's
segmenter in float32 (``chip_smoke.py`` phases 18-19 hold the port's
float32 segmenter to them).  JAX's ``Tracker`` itself builds a bfloat16
segmenter (JAX ``engine/segmentation.py:48``), and three more records keep
what it computes, each written by JAX's own ``Tracker`` (no subclass) with
vol 1's cached probabilities (float16, ``prob_1``):

- ``jax_legacy_record_bf16.npz``: single mode;
- ``jax_legacy_record_ensemble_bf16.npz``: ``ensemble=20``;
- ``jax_legacy_record_bf16_nudged.npz`` (seed 1, with ``prob_1``) and
  ``_nudged_s{2..12}.npz``: single mode with every U-Net
  weight nudged by one ulp (a random sign per element from each seed of
  ``NUDGE_SEEDS_BF16``), JAX's own spread at that precision: a bf16
  network rounds each layer's input again, so a change below an f32 ulp
  moves its result as far as the port's summation order does.

Regenerate (JAX on the CPU) with

    python tests/test_torch_legacy_record.py --write-weights   # ~30 min
    python tests/test_torch_legacy_record.py --write           # records
    python tests/test_torch_legacy_record.py --write-train     # retrain
    python tests/test_torch_legacy_record.py --write-bf16 single ensemble
    python tests/test_torch_legacy_record.py --nudged-bf16 1 2 3 4 5 6 \
        7 8 9 10 11 12

(each bf16 mode, or a few seeds, may run in a process of its own, in
parallel), and print the port's bf16 runs on the CPU against them with
``--port-bf16 ensemble`` (phase 23 holds the card to twice the nudged
runs' spread).  ``--cross-track NPZ`` tracks the cell sets of a port
run's cached bf16 probabilities with JAX's ``Tracker`` and the port's:
whether a departure from the record comes from the cell sets or from the
tracker.

and, for the legacy EM's parting from JAX (``ROADMAP.md`` C.9),
``--nudged unet`` / ``--nudged beta`` (JAX's run with one input nudged by
one ulp against the record, ~25 min) and ``--em-parting`` (the fits on the
record's own inputs, ~2 min).
"""

import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import t3dct_torch  # noqa: E402,F401
from t3dct.models.train_unet import TrainingUNet3D as JTrainingUNet3D  # noqa
from t3dct.models.train_unet import augment_batch, divide_img  # noqa: E402
from t3dct.models.unet3d import unet3_a as junet3_a  # noqa: E402
from t3dct.utils.checkpoint import save_pytree as jsave  # noqa: E402
from t3dct_torch.utils.synthetic import make_recording  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ASSETS = REPO / "3deecelltracker_tpu_torch" / "assets" / "legacy"
BENCH = REPO / "3deecelltracker_tpu_torch" / "assets" / "bench"
WEIGHTS = ASSETS / "unet3_a.npz"
RECORD = ASSETS / "jax_legacy_record.npz"
RECORD_ENSEMBLE = ASSETS / "jax_legacy_record_ensemble.npz"
TRAIN_RECORD = ASSETS / "jax_unet_train_record.npz"
# JAX's default precision: its own Tracker's bfloat16 segmenter
RECORD_BF16 = ASSETS / "jax_legacy_record_bf16.npz"
RECORD_ENSEMBLE_BF16 = ASSETS / "jax_legacy_record_ensemble_bf16.npz"
RECORD_NUDGED_BF16 = ASSETS / "jax_legacy_record_bf16_nudged.npz"
# the seeds of JAX's nudged bf16 runs: the first keeps vol 1's
# probabilities, the others the tracking (the assets stay under 16 MB)
NUDGE_SEEDS_BF16 = tuple(range(1, 13))


def nudged_bf16_path(seed: int) -> Path:
    return RECORD_NUDGED_BF16 if seed == 1 else \
        ASSETS / f"jax_legacy_record_bf16_nudged_s{seed}.npz"
# the bench scene (bench.py:55-74): (z, y, x) volumes, 150 cells, seed 0
SHAPE, N_CELLS, N_VOLS = (24, 401, 168), 150, 21
SHAPE_XYZ = (401, 168, 24)
VOXEL_SIZE = (1.0, 1.0, 9.2)
# the weights' recipe
NOISE_LEVEL, WEIGHTS_SEED, BATCH = 200.0, 0, 8
WEIGHTS_EPOCHS, WEIGHTS_STEPS = 2, 22
# examples/use_unet_legacy.py's defaults
EXAMPLE = dict(z_xy_ratio=9.2, z_scaling=10, noise_level=200.0,
               min_size=100, beta_tk=300.0, lambda_tk=0.1, maxiter_tk=20)
MAX_CELLS = 512
ENSEMBLE = 20
IMAGE_NAME = "raw_t%04i_z%04i.tif"
TRAIN_STEPS = 30
NUDGE_SEEDS = (1,)


def scene():
    """(raw (x, y, z) uint16 volumes for t = 1..21, {t: true centres zyx},
    vol-1 ground truth (x, y, z) int32)."""
    vols, centers, lab1 = make_recording(N_VOLS, N_CELLS, SHAPE)
    return ([v.transpose(1, 2, 0) for v in vols], centers,
            lab1.transpose(1, 2, 0))


def write_folder(folder: Path, vols, lab1, n_vols=N_VOLS) -> Path:
    """The example's folder: raw slices, ``manual_vol1/`` the ground truth,
    ``models/`` the trained U-Net and the bench FFN (JAX's writers)."""
    from t3dct.io.imageio import save_label_slices as jsave_slices
    for t in range(1, n_vols + 1):
        jsave_slices(vols[t - 1], folder / "data", IMAGE_NAME, t,
                     use_8_bit=False, compression=None)
    jsave_slices(lab1, folder / "manual_vol1", "manual_t%04i_z%04i.tif", 1,
                 use_8_bit=False, compression=None)
    (folder / "models").mkdir(parents=True, exist_ok=True)
    shutil.copy(WEIGHTS, folder / "models" / WEIGHTS.name)
    shutil.copy(BENCH / "ffn.npz", folder / "models" / "ffn.npz")
    return folder


def example_tracker(make, folder: Path, **kw):
    """``make`` (a ``Tracker`` class) with the example's settings."""
    return make(volume_num=N_VOLS, siz_xyz=SHAPE_XYZ, **EXAMPLE,
                folder_path=str(folder), image_name=IMAGE_NAME,
                unet_model_file=WEIGHTS.name, ffn_model_file="ffn.npz",
                max_cells=MAX_CELLS, **kw)


def run_example(tracker):
    """``examples/use_unet_legacy.py``'s flow after proofreading, from an
    empty U-Net cache."""
    tracker.load_unet()
    tracker.set_segmentation(del_cache=True)
    tracker.load_ffn()
    tracker.segment_vol1()
    tracker.load_manual_seg()
    tracker.interpolate_seg()
    tracker.cal_subregions()
    tracker.initiate_tracking()
    tracker.track(from_volume=2)
    tracker.save_coordinates()
    return tracker


def read_labels(folder, pattern):
    """The label slices ``pattern % z`` of one volume, (x, y, z)."""
    from t3dct.io.imageio import imread_stack
    paths = [str(Path(folder) / (pattern % z))
             for z in range(1, SHAPE[0] + 1)]
    return imread_stack(paths).transpose(1, 2, 0)


def tracker_record(tracker, centers, lab1) -> dict:
    """What a run's record keeps: the cells each volume's segmentation
    found and their coordinates, ``auto_vol1``, the tracked coordinates
    and labels per volume, the accuracy against the true centres, and the
    GT cells matched at IoU 0.5 by ``auto_vol1``."""
    from t3dct_torch.engine.metrics import (instance_matching,
                                            tracking_id_metrics)
    h = tracker.history
    coords = {t: np.asarray(c) for t, c in
              enumerate(h.r_tracked_coordinates, start=1)}
    auto = read_labels(tracker.paths.auto_segmentation_vol1,
                       "auto_R_t0001_z%04i.tif")
    metrics = tracking_id_metrics(coords, centers, VOXEL_SIZE, N_VOLS)
    metrics["matched_t1"] = instance_matching(lab1, auto, 0.5)["tp"]
    out = dict(auto_vol1=auto, metrics=json.dumps(metrics),
               cells=np.array([len(c) for c in h.r_segmented_coordinates]))
    for t in range(1, N_VOLS + 1):
        out[f"coords_{t}"] = coords[t]
        out[f"seg_coords_{t}"] = np.asarray(h.r_segmented_coordinates[t - 1])
        out[f"labels_{t}"] = read_labels(
            tracker.paths.track_results,
            "track_results_t%06i" % t + "_z%04i.tif")
    return out


def weights_recipe() -> dict:
    return dict(noise_level=NOISE_LEVEL, seed=WEIGHTS_SEED,
                batch_size=BATCH, iteration=WEIGHTS_EPOCHS,
                steps_per_epoch=WEIGHTS_STEPS)


def write_records(work: Path, make=None, runs=None, **extra) -> dict:
    """JAX's single-mode run of the example over the bench scene, then the
    ensemble run in the same folder: through ``make`` (a ``Tracker``
    class, ``Float32Tracker`` by default) into the ``runs`` ``(path,
    kwargs)`` (the float32 records by default).  ``extra`` goes into each
    record as it is (the bfloat16 records' vol-1 probabilities)."""
    if make is None:
        from test_torch_legacy_folder import Float32Tracker as make
    vols, centers, lab1 = scene()
    folder = write_folder(work / "legacy", vols, lab1)
    recipe = dict(example=EXAMPLE, max_cells=MAX_CELLS,
                  image_name=IMAGE_NAME, n_vols=N_VOLS,
                  weights=weights_recipe())
    out = {}
    for path, kw in runs or ((RECORD, {}), (RECORD_ENSEMBLE,
                                            dict(ensemble=ENSEMBLE))):
        t0 = time.time()
        tr = run_example(example_tracker(make, folder, **kw))
        rec = dict(tracker_record(tr, centers, lab1),
                   **{k: f(tr) for k, f in extra.items()})
        np.savez_compressed(path, recipe=json.dumps(dict(recipe, **kw)),
                            **rec)
        out[path.name] = dict(json.loads(rec["metrics"]),
                              cells=rec["cells"].tolist(),
                              seconds=round(time.time() - t0, 1))
        print(json.dumps(out), flush=True)
    return out


def cached_probs(tracker, t=1):
    """Volume t's U-Net probabilities as the run cached them: JAX's
    float16 ``unet_cache/t%06i.npy``, (x, y, z)."""
    return np.load(Path(tracker.paths.unet_cache) / ("t%06i.npy" % t))


def write_records_bf16(work: Path, modes=("single", "ensemble")) -> dict:
    """The bfloat16 records: JAX's own ``Tracker`` (no subclass, its
    default bfloat16 segmenter) through the example's flow, single mode
    and ``ensemble=20``, each in a folder of its own (``work/<mode>``);
    the single record with vol 1's cached probabilities (``prob_1``; the
    ensemble's are the same U-Net on the same volume, equal to them)."""
    from t3dct.engine.legacy import Tracker as JTracker
    runs = {"single": (RECORD_BF16, {}),
            "ensemble": (RECORD_ENSEMBLE_BF16, dict(ensemble=ENSEMBLE))}
    out = {}
    for mode in modes:
        extra = dict(prob_1=cached_probs) if mode == "single" else {}
        out.update(write_records(work / mode, JTracker, [runs[mode]],
                                 compute_dtype=lambda tr: "bfloat16",
                                 **extra))
    return out


def nudge_weights(path: Path, seed: int = 1) -> None:
    """Move every U-Net weight in the ``save_pytree`` file ``path`` by one
    ulp, up or down (a random sign per element from ``seed``)."""
    from t3dct.utils.checkpoint import load_pytree as jload
    rng = np.random.RandomState(seed)

    def nudge(a):
        a = np.asarray(a)
        to = np.where(rng.rand(*a.shape) < 0.5, np.float32(-np.inf),
                      np.float32(np.inf))
        return np.nextafter(a, to).astype(np.float32)
    params, state = jload(junet3_a().init(jax.random.PRNGKey(0)), path)
    jsave((jax.tree_util.tree_map(nudge, params), state), path)


def write_nudged_bf16(work: Path, seed: int = 1) -> dict:
    """JAX's own spread at its default precision: the bfloat16 single-mode
    record's run with every U-Net weight nudged by one ulp (a random sign
    per element from ``seed``), kept whole as ``nudged_bf16_path(seed)``
    so that a port run and these runs are held to ``RECORD_BF16`` by one
    statistic; vol 1's probabilities (``prob_1``) with seed 1 only."""
    from t3dct.engine.legacy import Tracker as JTracker
    vols, centers, lab1 = scene()
    folder = write_folder(work / f"nudged_bf16_{seed}", vols, lab1)
    nudge_weights(folder / "models" / WEIGHTS.name, seed)
    t0 = time.time()
    tr = run_example(example_tracker(JTracker, folder))
    rec = tracker_record(tr, centers, lab1)
    if seed == 1:
        rec["prob_1"] = cached_probs(tr)
    path = nudged_bf16_path(seed)
    np.savez_compressed(
        path, compute_dtype="bfloat16",
        recipe=json.dumps(dict(example=EXAMPLE, max_cells=MAX_CELLS,
                               image_name=IMAGE_NAME, n_vols=N_VOLS,
                               weights=weights_recipe(), nudge_seed=seed)),
        **rec)
    return {path.name: dict(
        json.loads(rec["metrics"]), cells=rec["cells"].tolist(),
        seconds=round(time.time() - t0, 1))}


def write_train_record(work: Path) -> dict:
    """JAX's first ``TRAIN_STEPS`` steps of ``retrain_unet`` from the
    trained weights (epoch 1 of ``steps_per_epoch=TRAIN_STEPS``): each
    step's patch start and affine draws, loss and update norms; then the
    same from the weights nudged by one ulp."""
    from t3dct.models import train_unet as jtu
    from t3dct_torch.utils.checkpoint import leaves_with_paths
    from t3dct_torch.utils.optim import update_norms
    from test_torch_legacy_folder import Float32Tracker
    vols, _, lab1 = scene()
    folder = write_folder(work / "retrain", vols, lab1, n_vols=1)
    runs = []
    for seed in (None,) + NUDGE_SEEDS:
        steps = dict(start=[], m=[], off=[], loss=[], norms=[])
        orig_batch, orig_init = jtu.TrainingUNet3D._train_batch, \
            jtu.TrainingUNet3D.__init__

        def train_batch(self, rng_np):
            state = rng_np.get_state()
            n = self.train_subimage.shape[0]
            start = rng_np.randint(0, max(n - self.batch_size, 1))
            rng_np.set_state(state)
            b = len(self.train_subimage[start:start + self.batch_size])
            _, sub = jax.random.split(self._key)
            ms, offs = jax.vmap(lambda k: jtu._affine_matrix(
                k, hw=self.train_subimage.shape[1:3]))(
                jax.random.split(sub, b))
            steps["start"].append(start)
            steps["m"].append(np.asarray(ms))
            steps["off"].append(np.asarray(offs))
            return orig_batch(self, rng_np)

        def init(self, *a, **k):
            orig_init(self, *a, **k)
            step = self._step

            def recorded(params, bn, opt, x, y):
                if not steps["norms"]:
                    self._theta0 = jax.tree_util.tree_map(np.asarray,
                                                          params)
                out = step(params, bn, opt, x, y)
                steps["loss"].append(float(out[3]))
                steps["norms"].append(update_norms(
                    jax.device_get(out[0]), self._theta0))
                return out
            self._step = recorded

        tr = example_tracker(Float32Tracker, folder)
        tr.load_unet()
        if seed is not None:
            rng = np.random.RandomState(seed)

            def nudge(a):
                a = np.asarray(a)
                to = np.where(rng.rand(*a.shape) < 0.5,
                              np.float32(-np.inf), np.float32(np.inf))
                return np.nextafter(a, to).astype(np.float32)
            params = jax.tree_util.tree_map(nudge, tr.unet_params)
            jsave((params, tr.unet_bn_state), Path(tr.paths.unet_weights) /
                  "weights_initial.npz")
        tr.load_manual_seg()
        jtu.TrainingUNet3D._train_batch = train_batch
        jtu.TrainingUNet3D.__init__ = init
        try:
            val = tr.retrain_unet(iteration=1, steps_per_epoch=TRAIN_STEPS,
                                  verbose=False)
        finally:
            jtu.TrainingUNet3D._train_batch = orig_batch
            jtu.TrainingUNet3D.__init__ = orig_init
        leaves = [k for k, _ in leaves_with_paths(tr.unet_params)]
        runs.append(dict(steps, val=val))
        print(json.dumps(dict(seed=seed, losses=steps["loss"], val=val)),
              flush=True)
    base, nudged = runs[0], runs[1:]
    np.savez_compressed(
        TRAIN_RECORD, starts=np.asarray(base["start"]),
        affine_m=np.asarray(base["m"], np.float32),
        affine_offset=np.asarray(base["off"], np.float32),
        losses=np.asarray(base["loss"]),
        update_norms=np.asarray(base["norms"]),
        val_losses=np.asarray(base["val"]),
        losses_nudged=np.asarray([r["loss"] for r in nudged]),
        update_norms_nudged=np.asarray([r["norms"] for r in nudged]),
        leaves=json.dumps(leaves), nudge_seeds=json.dumps(NUDGE_SEEDS),
        recipe=json.dumps(dict(example=EXAMPLE, steps=TRAIN_STEPS,
                               epoch=1)))
    return dict(losses=base["loss"], val=base["val"],
                losses_nudged=[r["loss"] for r in nudged])


def write_weights(work: Path) -> dict:
    """Train U-Net a with JAX's trainer by the recipe above and save the
    chosen weights to ``WEIGHTS``."""
    vols, _, lab1 = scene()
    img, lab = vols[0], (lab1 > 0).astype(np.int32)
    tr = JTrainingUNet3D(NOISE_LEVEL, work / "unet", junet3_a(),
                         seed=WEIGHTS_SEED, batch_size=BATCH)
    tr.load_dataset_arrays(img, lab, img, lab)
    tr.preprocess()
    t0 = time.time()
    val = tr.train(iteration=WEIGHTS_EPOCHS, steps_per_epoch=WEIGHTS_STEPS)
    best = int(np.argmin(val)) + 1
    tr.select_weights(best)
    ASSETS.mkdir(parents=True, exist_ok=True)
    shutil.copy(tr.models_path / "unet3_pretrained.npz", WEIGHTS)
    return dict(val_losses=[float(v) for v in val], best_epoch=best,
                seconds=round(time.time() - t0, 1))


def nudged_run(work: Path, what: str) -> dict:
    """JAX's single-mode run of the record with one input nudged by one
    ulp: ``"unet"`` every U-Net weight up or down (a random sign per
    element, seed 1), ``"beta"`` beta_tk up.  Per volume the median and
    largest distance of its tracked cells from the record's, the cells
    farther than 0.5 and the labels equal; its metrics and cell counts."""
    from test_torch_legacy_folder import Float32Tracker
    vols, centers, lab1 = scene()
    folder = write_folder(work / "nudged", vols, lab1)
    example = dict(EXAMPLE)
    if what == "beta":
        example["beta_tk"] = float(np.nextafter(np.float32(300.0),
                                                np.float32(400.0)))
    else:
        nudge_weights(folder / "models" / WEIGHTS.name)
    tr = run_example(Float32Tracker(
        volume_num=N_VOLS, siz_xyz=SHAPE_XYZ, **example,
        folder_path=str(folder), image_name=IMAGE_NAME,
        unet_model_file=WEIGHTS.name, ffn_model_file="ffn.npz",
        max_cells=MAX_CELLS))
    rec, want = tracker_record(tr, centers, lab1), np.load(RECORD)
    out = dict(metrics=json.loads(rec["metrics"]),
               cells=rec["cells"].tolist())
    for t in range(1, N_VOLS + 1):
        d = np.linalg.norm(rec[f"coords_{t}"] - want[f"coords_{t}"], axis=1)
        out[t] = [float(np.median(d)), float(d.max()), int((d > 0.5).sum()),
                  float((rec[f"labels_{t}"] == want[f"labels_{t}"]).mean())]
    return out


def em_parting(ts=(5, 7, 9, 11, 13, 15, 17, 19)) -> dict:
    """``ROADMAP.md`` C.9.  The legacy fit (``legacy_fit_and_predict``) of
    volume t of JAX's single-mode record from the record's own inputs (the
    segmented centres of t - 1 and t, the tracked cells of t - 1): JAX's
    against JAX's with beta one ulp up, and the port's against JAX's, the
    median and largest distance of the predictions (real units); then the
    outlier share gamma of the first EM of t = 5 in both, by iteration."""
    import torch
    from t3dct.engine import legacy as jl
    from t3dct.models.ffn import init_ffn as jinit_ffn
    from t3dct.ops.prgls import pr_gls_quick as jprgls
    from t3dct.utils.checkpoint import load_pytree as jload
    from t3dct_torch.engine import legacy as pl
    from t3dct_torch.models.ffn import init_ffn
    from t3dct_torch.ops.prgls import pr_gls_quick
    from t3dct_torch.utils.checkpoint import load_pytree
    jffn = jload(jinit_ffn(jax.random.PRNGKey(0)), BENCH / "ffn.npz")
    ffn = load_pytree(init_ffn(torch.Generator().manual_seed(0), device="cpu"),
                      BENCH / "ffn.npz")
    rec = np.load(RECORD)
    beta_up = float(np.nextafter(np.float32(300.0), np.float32(400.0)))

    def padded(t):
        pts = np.full((MAX_CELLS, 3), 1e6, np.float32)
        n = len(rec[f"seg_coords_{t}"])
        pts[:n] = rec[f"seg_coords_{t}"]
        return pts, np.arange(MAX_CELLS) < n

    def dist(a, b):
        d = np.linalg.norm(np.asarray(a) - np.asarray(b), axis=1)
        return [float(np.median(d)), float(d.max())]
    out = {}
    for t in ts:
        (ref, rm), (tgt, tm) = padded(t - 1), padded(t)
        tracked = rec[f"coords_{t - 1}"].astype(np.float32)
        want, nudged = (jl.legacy_fit_and_predict(
            *jffn, ref, rm, tgt, tm, tracked, beta, 0.1)[0]
            for beta in (300.0, beta_up))
        got = pl.legacy_fit_and_predict(
            *ffn, *(torch.from_numpy(a) for a in (ref, rm, tgt, tm,
                                                  tracked)),
            300.0, 0.1)[0].numpy()
        out[t] = dict(jax_nudged=dist(nudged, want), port=dist(got, want))
        print(t, out[t], flush=True)
    (ref, rm), (tgt, tm) = padded(4), padded(5)
    corr = np.full((MAX_CELLS, MAX_CELLS), 1e-28, np.float32)
    gammas = {"jax": [], "port": []}
    for it in range(10, 21):
        j = jprgls(*(jnp.asarray(a) for a in (ref, tgt, corr)), beta=300.0,
                   max_iteration=it, lambda_=0.1, ref_mask=jnp.asarray(rm),
                   tgt_mask=jnp.asarray(tm))
        p = pr_gls_quick(*(torch.from_numpy(a) for a in (ref, tgt, corr)),
                         beta=300.0, max_iteration=it, lambda_=0.1,
                         ref_mask=torch.from_numpy(rm),
                         tgt_mask=torch.from_numpy(tm))
        for name, post in (("jax", np.asarray(j.posterior)),
                           ("port", p.posterior.numpy())):
            gammas[name].append(float(1 - post.astype(np.float64).sum()
                                      / tm.sum()))
    out["gamma_t5_iterations_10_20"] = gammas
    return out


def cells_flow(tracker):
    """``run_example``'s flow over a folder whose ``unet_cache/`` already
    holds every volume's probabilities: the tracker segments from them."""
    tracker.load_unet()
    tracker.load_ffn()
    tracker.segment_vol1()
    tracker.load_manual_seg()
    tracker.interpolate_seg()
    tracker.cal_subregions()
    tracker.initiate_tracking()
    tracker.track(from_volume=2)
    tracker.save_coordinates()
    return tracker


def cross_track(work: Path, source: str) -> dict:
    """The two trackers on the same cell sets: ``source`` an ``.npz`` of
    ``t%06i`` float16 (x, y, z) bf16 U-Net probabilities of the 21 volumes
    (a port run's ``unet_cache/``) in the cache of a fresh folder, tracked
    by JAX's ``Tracker`` and by the port's on the CPU.  Per tracker:
    switches, recall and ``chip_smoke.legacy_departure`` from the bf16
    record.  Read from the cache, the probabilities are float16-rounded,
    where the run that wrote them segmented its float32 ones."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import torch
    from t3dct.engine.legacy import Tracker as JTracker
    vols, centers, lab1 = scene()
    folder = write_folder(work / Path(source).stem, vols, lab1)
    (folder / "unet_cache").mkdir(parents=True, exist_ok=True)
    with np.load(source) as probs:
        for key in probs.files:
            np.save(folder / "unet_cache" / (key + ".npy"), probs[key])
    single = np.load(RECORD_BF16)
    out = {}
    for who in ("jax", "port"):
        run_folder = work / f"{folder.name}_{who}"
        shutil.copytree(folder, run_folder)
        t0 = time.time()
        if who == "jax":
            run = tracker_record(cells_flow(example_tracker(
                JTracker, run_folder)), centers, lab1)
        else:
            run = chip_smoke.legacy_run_record(cells_flow(
                chip_smoke.legacy_tracker(torch.device("cpu"), run_folder)),
                centers)
        m = run["metrics"]
        m = m if isinstance(m, dict) else json.loads(m)
        out[run_folder.name] = dict(
            switches=m["id_switches"], recall=m["strict_recall"],
            seconds=round(time.time() - t0, 1),
            from_bf16_record=chip_smoke.legacy_departure(
                run, single, single["prob_1"]))
        print(json.dumps({run_folder.name: out[run_folder.name]}),
              flush=True)
    return out


@pytest.fixture(scope="module")
def records():
    out = {}
    for path in (RECORD, RECORD_ENSEMBLE, TRAIN_RECORD):
        with np.load(path) as data:
            out[path.name] = {k: data[k] for k in data.files}
    return out


def test_legacy_assets_are_the_recipe(records):
    """The weights, the records and their recipes; every tracked volume
    has 150 cells and its labels; the assets stay small."""
    for path in (WEIGHTS, RECORD, RECORD_ENSEMBLE, TRAIN_RECORD):
        assert path.is_file(), path
    for name, kw in ((RECORD.name, {}),
                     (RECORD_ENSEMBLE.name, dict(ensemble=ENSEMBLE))):
        rec = records[name]
        recipe = json.loads(str(rec["recipe"]))
        assert recipe["example"] == EXAMPLE and recipe["n_vols"] == N_VOLS
        assert recipe["max_cells"] == MAX_CELLS
        assert recipe.get("ensemble", False) == kw.get("ensemble", False)
        assert recipe["weights"] == dict(
            noise_level=NOISE_LEVEL, seed=WEIGHTS_SEED, batch_size=BATCH,
            iteration=WEIGHTS_EPOCHS, steps_per_epoch=WEIGHTS_STEPS)
        assert rec["cells"].shape == (N_VOLS,) and rec["cells"].min() > 0
        assert rec["auto_vol1"].shape == SHAPE_XYZ
        for t in range(1, N_VOLS + 1):
            assert rec[f"coords_{t}"].shape == (N_CELLS, 3)
            assert np.isfinite(rec[f"coords_{t}"]).all()
            assert rec[f"seg_coords_{t}"].shape == (rec["cells"][t - 1], 3)
            assert rec[f"labels_{t}"].shape == SHAPE_XYZ
        metrics = json.loads(str(rec["metrics"]))
        assert set(metrics) >= {"gate", "strict_recall", "id_switches",
                                "matched_t1"}
    total = sum(p.stat().st_size for p in ASSETS.iterdir())
    assert total < 16 * 1024 * 1024


def test_weights_load_in_both_packages():
    """``unet3_a.npz`` is JAX's ``save_pytree`` of ``(params, bn_state)``
    and loads in the port leaf for leaf."""
    import torch
    from t3dct.utils.checkpoint import load_pytree as jload
    from t3dct_torch.models.unet3d import unet3_a
    from t3dct_torch.utils.checkpoint import load_pytree
    jtree = jload(junet3_a().init(jax.random.PRNGKey(0)), WEIGHTS)
    tree = load_pytree(unet3_a().init(torch.Generator().manual_seed(0),
                                      device="cpu"), WEIGHTS)
    for got, want in zip(jax.tree_util.tree_leaves(tree),
                         jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_record_holds_its_recipe(records):
    """The retraining record: 30 steps of 8 affine draws each, patch starts
    of the 30-patch vol 1 from ``RandomState(1)``, losses and update norms
    of every U-Net leaf in ``save_pytree``'s order, for JAX's run and its
    nudged ones."""
    import torch
    from t3dct_torch.models.unet3d import unet3_a
    from t3dct_torch.utils.checkpoint import leaves_with_paths
    rec = records[TRAIN_RECORD.name]
    leaves = json.loads(str(rec["leaves"]))
    params, _ = unet3_a().init(torch.Generator().manual_seed(0),
                               device="cpu")
    assert leaves == [k for k, _ in leaves_with_paths(params)]
    assert rec["affine_m"].shape == (TRAIN_STEPS, BATCH, 2, 2)
    assert rec["affine_offset"].shape == (TRAIN_STEPS, BATCH, 2)
    rng = np.random.RandomState(1)
    assert rec["starts"].tolist() == [rng.randint(0, 30 - BATCH)
                                      for _ in range(TRAIN_STEPS)]
    assert rec["losses"].shape == (TRAIN_STEPS,)
    assert rec["update_norms"].shape == (TRAIN_STEPS, len(leaves))
    assert rec["losses_nudged"].shape == (len(NUDGE_SEEDS), TRAIN_STEPS)
    assert rec["update_norms_nudged"].shape == (len(NUDGE_SEEDS),
                                                TRAIN_STEPS, len(leaves))
    assert (rec["update_norms"] > 0).all()
    assert np.isfinite(rec["losses"]).all()


def test_recorded_draws_give_jax_batch(records):
    """The recorded affines of step 1 through the port's warp give JAX's
    first augmented batch of ``retrain_unet`` (its key stream, its patch
    start): images within 1e-5, labels exactly."""
    import torch
    from t3dct_torch.models import train_unet as tu
    rec = records[TRAIN_RECORD.name]
    vols, _, lab1 = scene()
    from t3dct.ops.lcn import normalize_image
    norm = np.asarray(normalize_image(vols[0], NOISE_LEVEL))
    tile = junet3_a().tile_shape
    start = int(rec["starts"][0])
    imgs = divide_img(norm, tile)[start:start + BATCH]
    labs = divide_img((lab1 > 0).astype(np.int32), tile)[start:start + BATCH]
    key = jax.random.PRNGKey(WEIGHTS_SEED + 1)
    _, sub = jax.random.split(key)
    jx, jy = augment_batch(sub, jnp.asarray(imgs, jnp.float32),
                           jnp.asarray(labs, jnp.int32))
    draws = [(torch.from_numpy(m), torch.from_numpy(o)) for m, o in
             zip(rec["affine_m"][0], rec["affine_offset"][0])]
    x, y = tu.augment_with(torch.from_numpy(imgs.astype(np.float32)),
                           torch.from_numpy(labs), draws)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def port_run(tmp_path, ensemble=False, f32=True):
    """The port's folder ``Tracker`` on the CPU through
    ``chip_smoke.py``'s phase 18 (then 19 in the same folder); ``f32=
    False``: as phase 23 runs it, JAX's default precision."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import torch
    from t3dct_torch.utils.timing import CudaStageTimer
    folder, centers = chip_smoke.write_legacy_folder(tmp_path / "legacy")
    runs = []
    for kw in ({}, dict(ensemble=ENSEMBLE))[:2 if ensemble else 1]:
        tr = chip_smoke.timed_legacy_example(chip_smoke.legacy_tracker(
            torch.device("cpu"), folder, f32=f32, **kw), CudaStageTimer())
        runs.append((tr, centers))
    return chip_smoke, runs


@pytest.mark.slow
def test_port_on_cpu_matches_records(records, tmp_path):
    """Phases 18 and 19 on the CPU: the port's single run of the example
    over the whole bench scene, then its ensemble run in the same folder,
    each held to its record with the phases' bounds."""
    chip_smoke, runs = port_run(tmp_path, ensemble=True)
    for (tr, centers), name in zip(runs, (RECORD.name,
                                          RECORD_ENSEMBLE.name)):
        bad, _ = chip_smoke.hold_legacy_to_record(
            name, records[name], tr, centers)
        assert not bad, (name, bad)


def port_bf16_departures(tmp_path, ensemble=True) -> dict:
    """Phase 23's folder runs on the CPU (the port's bf16 U-Net): each
    run's ``legacy_departure`` from its bf16 record, JAX's own spread, the
    bounds, and what ``hold_legacy_bf16`` rejects."""
    chip_smoke, runs = port_run(tmp_path, ensemble=ensemble, f32=False)
    single = np.load(RECORD_BF16)
    nudged = [np.load(nudged_bf16_path(s)) for s in NUDGE_SEEDS_BF16]
    out = dict(spread=chip_smoke.jax_spread(single, nudged))
    for (tr, centers), path in zip(runs, (RECORD_BF16,
                                          RECORD_ENSEMBLE_BF16)):
        bad, dep = chip_smoke.hold_legacy_bf16(
            path.name, np.load(path), single, nudged,
            chip_smoke.legacy_run_record(tr, centers))
        out[path.name] = dict(departure=dep, rejected=bad)
    return out


@pytest.mark.slow
def test_port_bf16_on_cpu_matches_records(tmp_path):
    """Phase 23's runs on the CPU: the port's bf16 single and ensemble runs
    over the whole bench scene, each within its bounds of JAX's bf16
    record."""
    out = port_bf16_departures(tmp_path)
    for name in (RECORD_BF16.name, RECORD_ENSEMBLE_BF16.name):
        assert not out[name]["rejected"], (name, out[name])


@pytest.mark.slow
def test_port_retrain_steps_on_cpu_match_record(records, tmp_path):
    """Phase 20's record check on the CPU: the port's first 30 steps of
    ``retrain_unet`` on JAX's batches, losses and update norms."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import torch
    rec = records[TRAIN_RECORD.name]
    folder, _ = chip_smoke.write_legacy_folder(tmp_path / "r", n_vols=1)
    losses, norms, _ = chip_smoke.replay_unet_record(
        torch.device("cpu"), folder, rec)
    chip_smoke.hold_losses("U-Net retrain", losses, rec["losses"],
                           TRAIN_STEPS, rec["losses_nudged"])
    chip_smoke.hold_update_norms("U-Net retrain", norms,
                                 rec["update_norms"],
                                 rec["update_norms_nudged"],
                                 json.loads(str(rec["leaves"])), first=0)


if __name__ == "__main__":
    import argparse
    import os
    import tempfile
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write-weights", action="store_true")
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--write-train", action="store_true")
    ap.add_argument("--nudged", choices=("unet", "beta"),
                    help="JAX's run nudged by one ulp against the record")
    ap.add_argument("--em-parting", action="store_true",
                    help="the legacy fits on the record's own inputs")
    ap.add_argument("--write-bf16", nargs="+",
                    choices=("single", "ensemble"),
                    help="the bfloat16 records of JAX's own Tracker")
    ap.add_argument("--nudged-bf16", nargs="*", type=int,
                    help="the bfloat16 single run, U-Net nudged by one ulp "
                    "with each seed given (default 1)")
    ap.add_argument("--cross-track", nargs="+", metavar="NPZ",
                    help="JAX's and the port's trackers on the cell sets "
                    "of a port run's cached bf16 probabilities")
    ap.add_argument("--port-bf16", choices=("single", "ensemble"),
                    help="the port's bf16 runs on the CPU against the bf16 "
                    "records (ensemble: both), and JAX's spread")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        out = {}
        if args.write_weights:
            out["weights"] = write_weights(Path(tmp))
            print(json.dumps(out), flush=True)
        if args.write:
            out["records"] = write_records(Path(tmp))
        if args.write_train:
            out["train"] = write_train_record(Path(tmp))
        if args.nudged:
            out["nudged"] = nudged_run(Path(tmp), args.nudged)
        if args.em_parting:
            out["em_parting"] = em_parting()
        if args.write_bf16:
            out["records_bf16"] = write_records_bf16(Path(tmp),
                                                     args.write_bf16)
        if args.nudged_bf16 is not None:
            out["nudged_bf16"] = {}
            for seed in args.nudged_bf16 or [1]:
                out["nudged_bf16"].update(write_nudged_bf16(Path(tmp),
                                                            seed))
        if args.cross_track:
            out["cross_track"] = {}
            for source in args.cross_track:
                out["cross_track"].update(cross_track(Path(tmp), source))
        if args.port_bf16:
            out["port_bf16"] = port_bf16_departures(
                Path(tmp), args.port_bf16 == "ensemble")
    print(json.dumps(out))
