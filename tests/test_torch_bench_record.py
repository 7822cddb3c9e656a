"""The committed bench assets (``3deecelltracker_tpu_torch/assets/bench/``)
and JAX's record of the bench scene.

The assets were made with the JAX package on the CPU by ``bench.py``'s own
recipe: ``get_trained_model`` (StarDist3D, 16 epochs x 30 steps on the
vol-1 ground truth of the bench scene) and ``train_ffn`` (600 iterations,
seed 0, on the trained model's vol-1 ``seg/coords000001.npy``).  The
record is JAX's ``segment_and_track(handoff="device")`` over the 21-volume
bench scene with those weights and ``bench_composition``'s arguments.
Regenerate the record (JAX, on the CPU) with

    python tests/test_torch_bench_record.py --write

The ensemble record is JAX's two-step workflow of the examples over the
same scene and weights: ``predict_and_save``, then ``track_timelapse`` in
ensemble mode (``ENSEMBLE``), then ``TrackerLite.activities``; regenerate
it with ``--write-ensemble``.  The tiled record is the same two steps in
single mode with ``predict_and_save(tile_shape=TILE_SHAPE)``, each volume
cut into tiles along y (``predict_instances_tiled``); regenerate it with
``--write-tiled``.  The u8 record is the single-mode run again with the
8-bit upload (``transport="u8"``: each volume quantized against its own
1/99.8 percentiles); regenerate it with ``--write-u8``.  The refine record
is the single-mode run again with the compensated M-step
(``TrackingConfig(m_step_refine=REFINE)``, ``bench_composition``'s other
arguments), each volume's EM iteration count recorded beside it;
regenerate it with ``--write-refine``.

The tier-1 tests hold the port's loaders to JAX's on the assets and check
the records; the ``slow`` tests re-derive the record with JAX and run the
port on the CPU over the whole scene against each record, with the bounds
of ``chip_smoke.py``'s phases 11, 13, 16, 28 and 29."""

import contextlib
import functools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_scene import REPO, jax_script  # noqa: E402

import t3dct_torch  # noqa: E402,F401
from t3dct.engine.stardist import StarDist3D as JStarDist3D  # noqa: E402
from t3dct.engine.tracker import TrackerLite as JTrackerLite  # noqa: E402
from t3dct.models.ffn import FFN  # noqa: E402
from t3dct.models.ffn import ffn_pair_scores as j_scores  # noqa: E402
from t3dct.utils.checkpoint import load_pytree  # noqa: E402
from t3dct_torch.coordinates import Coordinates  # noqa: E402
from t3dct_torch.engine.stardist import StarDist3D  # noqa: E402
from t3dct_torch.engine.tracker import TrackerLite  # noqa: E402
from t3dct_torch.models.ffn import ffn_pair_scores  # noqa: E402
from t3dct_torch.utils.convert import ffn_from_numpy, load_npz  # noqa: E402
from t3dct_torch.utils.synthetic import make_recording  # noqa: E402

ASSETS = REPO / "3deecelltracker_tpu_torch" / "assets" / "bench"
RECORD = ASSETS / "jax_record.npz"
ENSEMBLE_RECORD = ASSETS / "jax_record_ensemble.npz"
TILED_RECORD = ASSETS / "jax_record_tiled.npz"
U8_RECORD = ASSETS / "jax_record_u8.npz"
REFINE_RECORD = ASSETS / "jax_record_refine.npz"
# the refine record's TrackingConfig.m_step_refine
REFINE = 8
N_VOLS = 21
SHAPE = (24, 401, 168)
VOXEL_SIZE = (1.0, 1.0, 9.2)
# bench_composition's arguments (bench.py:369-387)
MAX_CANDIDATES, RENDER_BOX = 256, (9, 33, 33)
# the record keeps every volume's labels unless they pass this compressed
# size; then volumes 2, 11 and 21 and every volume's per-label counts
LABELS_BUDGET = 8 * 1024 * 1024
# chip_smoke.py phase 11's bounds (kept cells are held exactly here): the
# median per volume of the tracked coordinates' distance to JAX's, and
# every cell within the record's identity gate (see chip_smoke.py)
COORD_MEDIAN = 1e-2
LABELS_EQUAL = 0.995


def _conv_bound(ref):
    # f32 accumulation in a different summation order (the bound of
    # test_torch_stardist.py)
    return 1e-5 * float(np.abs(ref).max()) + 1e-6


def jax_ffn_weights():
    template = FFN().init(jax.random.PRNGKey(0))
    return load_pytree(template, ASSETS / "ffn.npz")


def jax_model():
    model = JStarDist3D.load(ASSETS / "sd_model")
    model.max_candidates, model.render_box = MAX_CANDIDATES, RENDER_BOX
    return model


@contextlib.contextmanager
def jax_em_iterations():
    """Inside the block every PR-GLS EM that JAX's ``track_step`` runs
    appends its iteration count to the list yielded, in the order the EMs
    run: ``engine.tracker.prgls_with_two_ref`` is wrapped while the block
    traces, its ``n_iterations`` handed to the host by a
    ``jax.debug.callback``.  The JAX package itself is not changed."""
    import t3dct.engine.tracker as jtracker
    counts = []
    em = jtracker.prgls_with_two_ref

    def counted(*args, **kwargs):
        res = em(*args, **kwargs)
        jax.debug.callback(lambda n: counts.append(int(n)),
                           res.n_iterations)
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracker, "prgls_with_two_ref", counted)
        yield counts


def write_record(out: Path, work: Path, transport: str = "u16",
                 m_step_refine: int = 0) -> dict:
    """JAX's ``segment_and_track(handoff="device", transport=transport)``
    over the bench scene with the committed weights, through ``bench.py``'s
    own ``make_recording`` and ``bench_composition``; writes the record to
    ``out`` and returns its metrics.  ``m_step_refine`` > 0 runs
    ``bench_composition``'s ``TrackingConfig`` with that
    ``m_step_refine`` and records each tracked volume's EM iteration count
    (``em_iterations``, t = 2, 3, ...)."""
    import t3dct.config as jconfig
    from t3dct.io.imageio import imread_stack
    with jax_script(REPO / "bench.py", "jax_bench", work / "xla") as bench, \
            (jax_em_iterations() if m_step_refine else
             contextlib.nullcontext([])) as iterations, \
            pytest.MonkeyPatch.context() as mp:
        if m_step_refine:
            # bench_composition imports TrackingConfig when it runs
            mp.setattr(jconfig, "TrackingConfig", functools.partial(
                jconfig.TrackingConfig, m_step_refine=m_step_refine))
        raw = work / "raw"
        raw.mkdir(parents=True)
        images_path, centers, lab1 = bench.make_recording(raw)
        results = work / "results"
        t0 = time.perf_counter()
        _, coords = bench.bench_composition(images_path, results, lab1,
                                            jax_model(), jax_ffn_weights(),
                                            handoff="device",
                                            transport=transport)
        jax.effects_barrier()
        wall = time.perf_counter() - t0
        metrics = bench.tracking_id_metrics(coords, centers)
    metrics.update(cpu_wall_s=wall, transport=transport)
    arrays, labels, counts = {}, {}, {}
    if m_step_refine:
        assert len(iterations) == N_VOLS - 1, iterations
        metrics.update(m_step_refine=m_step_refine)
        arrays["em_iterations"] = np.asarray(iterations, np.int32)
    for t in range(1, N_VOLS + 1):
        arrays[f"seg_coords_{t}"] = np.load(results / "seg" /
                                            f"coords{t:06d}.npy")
        arrays[f"coords_{t}"] = np.asarray(coords[t], np.float32)
        lab = imread_stack(sorted((results / "track_results" / "labels")
                                  .glob("track_results_t%06i_z*.tif" % t)))
        labels[f"labels_{t}"] = lab.transpose(1, 2, 0)
        counts[f"label_counts_{t}"] = np.bincount(lab.ravel())
    np.savez_compressed(out, metrics=json.dumps(metrics), **arrays,
                        **labels)
    if out.stat().st_size > LABELS_BUDGET:
        kept = {k: v for k, v in labels.items()
                if k in ("labels_2", "labels_11", "labels_21")}
        np.savez_compressed(out, metrics=json.dumps(metrics), **arrays,
                            **kept, **counts)
    return metrics


# the ensemble record's recipe: JAX's two-step workflow, predict_and_save
# then track_timelapse in ensemble mode with these settings
ENSEMBLE = dict(beta=3.0, lambda_=3.0, ensemble=True, sampling_number=20,
                adjacent=False)
ACTIVITY_DISCARD = 0.1


def write_ensemble_record(out: Path, work: Path) -> dict:
    """JAX's v1.0 two-step workflow over the bench scene with the
    committed weights: ``predict_and_save``, then ``track_timelapse`` in
    ensemble mode (``ENSEMBLE``) with ``bench_composition``'s voxel size
    and interpolation and the proofed vol-1 labels, then
    ``TrackerLite.activities``.  Writes each volume's tracked coordinates,
    uint8 labels and reference volumes (members), the metrics and the
    activities to ``out``; returns the metrics."""
    from t3dct.config import TrackingConfig
    from t3dct.engine.pipeline import track_timelapse
    from t3dct.engine.stardist import predict_and_save
    from t3dct.engine.tracker import get_volumes_list
    from t3dct.io.imageio import imread_stack
    with jax_script(REPO / "bench.py", "jax_bench", work / "xla") as bench:
        raw = work / "raw"
        raw.mkdir(parents=True)
        images_path, centers, lab1 = bench.make_recording(raw)
        results = work / "results"
        bench._save_manual_vol1(results, lab1)
        t0 = time.perf_counter()
        predict_and_save(images_path, jax_model(), results)
        seg_wall = time.perf_counter() - t0
        ffn = jax_ffn_weights()
        coords = track_timelapse(
            results, str(results / "manual_vol1" / "*.tif"), ffn,
            voxel_size=VOXEL_SIZE, interpolation_factor=10,
            t_range=(1, N_VOLS), grid=(1, 2, 2),
            config=TrackingConfig(**ENSEMBLE), verbose=False)
        wall = time.perf_counter() - t0
        metrics = bench.tracking_id_metrics(coords, centers)
    tracker = JTrackerLite(results, ffn, type(
        "Vol1", (), {"cell_num": int(coords[1].shape[0])})())
    activities = tracker.activities(images_path,
                                    discard_ratio=ACTIVITY_DISCARD)
    metrics.update(cpu_wall_s=wall, cpu_seg_wall_s=seg_wall)
    arrays = {}
    for t in range(1, N_VOLS + 1):
        arrays[f"seg_coords_{t}"] = np.load(results / "seg" /
                                            f"coords{t:06d}.npy")
        arrays[f"coords_{t}"] = np.asarray(coords[t], np.float32)
        lab = imread_stack(sorted((results / "track_results" / "labels")
                                  .glob("track_results_t%06i_z*.tif" % t)))
        arrays[f"labels_{t}"] = lab.transpose(1, 2, 0)
        if t > 1:
            arrays[f"members_{t}"] = np.asarray(get_volumes_list(
                t, [], ENSEMBLE["sampling_number"], ENSEMBLE["adjacent"],
                1), np.int32)
    np.savez_compressed(out, metrics=json.dumps(metrics),
                        recipe=json.dumps(dict(
                            ENSEMBLE, voxel_size=VOXEL_SIZE,
                            interpolation_factor=10, t_range=(1, N_VOLS),
                            max_candidates=MAX_CANDIDATES,
                            render_box=RENDER_BOX,
                            discard_ratio=ACTIVITY_DISCARD)),
                        activities=np.asarray(activities, np.float64),
                        **arrays)
    return metrics


# the tiled record's recipe: JAX's two-step workflow in single mode with
# the tiled segmentation; y (401) is cut into tiles of 256 with the bench
# network's receptive-field shrink, z and x stay whole
TILE_SHAPE = (None, 256, None)
TILED = dict(tile_shape=TILE_SHAPE, tile_candidates=256, tile_batch=8,
             shrink=None)


def write_tiled_record(out: Path, work: Path) -> dict:
    """JAX's v1.0 two-step workflow over the bench scene with the
    committed weights and the tiled segmentation:
    ``predict_and_save(**TILED)``, then ``track_timelapse`` in single mode
    with ``bench_composition``'s settings.  Writes each volume's kept
    ``seg/`` coordinates and tracked coordinates, the first volume's
    ``auto_vol1`` labels (as (y, x, z)), the metrics and the recipe to
    ``out``; returns the metrics."""
    from t3dct.config import TrackingConfig
    from t3dct.engine.pipeline import track_timelapse
    from t3dct.engine.stardist import predict_and_save
    from t3dct.io.imageio import imread_stack
    with jax_script(REPO / "bench.py", "jax_bench", work / "xla") as bench:
        raw = work / "raw"
        raw.mkdir(parents=True)
        images_path, centers, lab1 = bench.make_recording(raw)
        results = work / "results"
        bench._save_manual_vol1(results, lab1)
        t0 = time.perf_counter()
        predict_and_save(images_path, jax_model(), results, **TILED)
        seg_wall = time.perf_counter() - t0
        coords = track_timelapse(
            results, str(results / "manual_vol1" / "*.tif"),
            jax_ffn_weights(), voxel_size=VOXEL_SIZE,
            interpolation_factor=10, t_range=(1, N_VOLS), grid=(1, 2, 2),
            config=TrackingConfig(beta=3.0, lambda_=3.0), verbose=False)
        wall = time.perf_counter() - t0
        metrics = bench.tracking_id_metrics(coords, centers)
    metrics.update(cpu_wall_s=wall, cpu_seg_wall_s=seg_wall)
    arrays = {}
    for t in range(1, N_VOLS + 1):
        arrays[f"seg_coords_{t}"] = np.load(results / "seg" /
                                            f"coords{t:06d}.npy")
        arrays[f"coords_{t}"] = np.asarray(coords[t], np.float32)
    arrays["auto_vol1"] = imread_stack(sorted(
        (results / "auto_vol1").glob("*.tif"))).transpose(1, 2, 0)
    np.savez_compressed(out, metrics=json.dumps(metrics),
                        recipe=json.dumps(dict(
                            TILED, voxel_size=VOXEL_SIZE,
                            interpolation_factor=10, t_range=(1, N_VOLS),
                            beta=3.0, lambda_=3.0,
                            max_candidates=MAX_CANDIDATES,
                            render_box=RENDER_BOX)),
                        **arrays)
    return metrics


@pytest.fixture(scope="module")
def record():
    with np.load(RECORD) as data:
        return {k: data[k] for k in data.files}


def test_assets_are_the_bench_recipe():
    """The StarDist folder (``StarDist3D.save``'s three files) and the FFN
    pytree, with the bench's config."""
    for name in ("sd_model/weights.npz", "sd_model/config.json",
                 "sd_model/thresholds.json", "ffn.npz", "jax_record.npz"):
        assert (ASSETS / name).is_file(), name
    cfg = json.loads((ASSETS / "sd_model/config.json").read_text())
    assert cfg["n_rays"] == 96 and tuple(cfg["grid"]) == (1, 2, 2)
    assert tuple(cfg["train_patch_size"]) == (24, 96, 96)
    assert cfg["prob_thresh"] == 0.3 and cfg["arch"] == "tpu"
    total = sum(p.stat().st_size for p in ASSETS.rglob("*") if p.is_file())
    assert total < 32 * 1024 * 1024


def test_stardist_assets_load_like_jax():
    """The port's ``StarDist3D.load`` reads the trained folder with numpy
    and its network gives JAX's outputs on a (24, 96, 96) crop of the
    bench scene's vol 1, within the f32 summation-order bound."""
    tm = StarDist3D.load(ASSETS / "sd_model", device="cpu")
    jm = jax_model()
    assert tm.thresholds == jm._thresholds
    assert tm.config.grid == tuple(jm.config.grid)
    vol = make_recording(1, shape=SHAPE)[0][0]
    mi, ma = np.percentile(vol, (1.0, 99.8))
    crop = ((vol[:, 150:246, 40:136] - mi) / (ma - mi + 1e-20)
            ).astype(np.float32)[None, ..., None]
    jp, jd = (np.asarray(a) for a in jm.net.apply(jm.params,
                                                  jnp.asarray(crop)))
    tp, td = (a.numpy() for a in tm.net.apply(tm.params,
                                              torch.from_numpy(crop)))
    assert tp.shape == jp.shape and td.shape == jd.shape
    assert np.abs(tp - jp).max() <= _conv_bound(jp)
    assert np.abs(td - jd).max() <= _conv_bound(jd)
    assert (jp > 0.3).any()               # the trained model sees cells


def test_ffn_assets_load_like_jax(tmp_path):
    """``ffn_from_numpy`` of the ``.npz`` scores pairs as JAX's loaded FFN
    does, to 1e-5; the port's ``TrackerLite`` loads the same file and pads
    point sets as JAX's."""
    jp, js = jax_ffn_weights()
    tree = load_npz(ASSETS / "ffn.npz")
    tp, ts = ffn_from_numpy(tree["0"], tree["1"], "cpu")
    rng = np.random.RandomState(0)
    f1 = rng.randn(40, 61).astype(np.float32)
    f2 = rng.randn(35, 61).astype(np.float32)
    want = np.asarray(j_scores(jp, js, jnp.asarray(f1), jnp.asarray(f2)))
    got = ffn_pair_scores(tp, ts, torch.from_numpy(f1), torch.from_numpy(f2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    vol1 = Coordinates.from_raw(rng.rand(150, 3) * 100, 10, VOXEL_SIZE,
                                device="cpu")
    tracker = TrackerLite(tmp_path / "port", ASSETS / "ffn.npz", vol1)
    assert tracker.max_cells == 256
    for key, w in tracker.ffn_params["feat"].items():
        np.testing.assert_array_equal(w.numpy(), tp["feat"][key].numpy())
    jt = JTrackerLite(tmp_path / "jax", (jp, js),
                      type("Vol1", (), {"cell_num": 150})())
    pts = rng.rand(143, 3).astype(np.float32)
    for a, b in zip(tracker._pad_np(pts), jt._pad_np(pts)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="257 cells exceeds"):
        tracker._pad_np(np.zeros((257, 3), np.float32))


def test_record_holds_the_bench_run(record):
    """Every volume's kept seg coordinates and tracked coordinates, the
    recorded label volumes, and JAX's tracking metrics."""
    metrics = json.loads(str(record["metrics"]))
    assert set(metrics) >= {"gate", "strict_recall", "strict_accuracy_all_t",
                            "id_switches"}
    n1 = record["coords_1"].shape[0]
    for t in range(1, N_VOLS + 1):
        seg = record[f"seg_coords_{t}"]
        assert seg.ndim == 2 and seg.shape[1] == 3 and seg.dtype == np.int32
        assert 0 < len(seg) <= 256
        c = record[f"coords_{t}"]
        assert c.shape == (n1, 3) and np.isfinite(c).all()
    labels = [k for k in record if k.startswith("labels_")]
    assert labels
    for k in labels:
        assert record[k].shape == (SHAPE[1], SHAPE[2], SHAPE[0])
        assert record[k].dtype == np.uint8


@pytest.fixture(scope="module")
def ensemble_record():
    with np.load(ENSEMBLE_RECORD) as data:
        return {k: data[k] for k in data.files}


def test_ensemble_record_holds_its_recipe(ensemble_record, record):
    """JAX's two-step ensemble run: the recipe it states, each volume's
    members (``get_volumes_list``: 1..t-1, the evenly spread 20 at t =
    21), tracked coordinates, uint8 labels and metrics, the activities of
    every cell and volume, within the labels budget; its segmentation is
    the single-mode record's, volume for volume."""
    from t3dct.engine.tracker import get_volumes_list
    rec = ensemble_record
    assert ENSEMBLE_RECORD.stat().st_size < LABELS_BUDGET
    recipe = json.loads(str(rec["recipe"]))
    for key, value in ENSEMBLE.items():
        assert recipe[key] == value, key
    assert tuple(recipe["voxel_size"]) == VOXEL_SIZE
    assert recipe["interpolation_factor"] == 10
    assert tuple(recipe["t_range"]) == (1, N_VOLS)
    assert recipe["discard_ratio"] == ACTIVITY_DISCARD
    assert recipe["max_candidates"] == MAX_CANDIDATES
    metrics = json.loads(str(rec["metrics"]))
    assert set(metrics) >= {"gate", "strict_recall", "id_switches",
                            "cpu_wall_s"}
    n1 = rec["coords_1"].shape[0]
    np.testing.assert_array_equal(rec["coords_1"], record["coords_1"])
    for t in range(1, N_VOLS + 1):
        np.testing.assert_array_equal(rec[f"seg_coords_{t}"],
                                      record[f"seg_coords_{t}"])
        assert rec[f"coords_{t}"].shape == (n1, 3)
        assert np.isfinite(rec[f"coords_{t}"]).all()
        lab = rec[f"labels_{t}"]
        assert lab.dtype == np.uint8 and lab.shape == (SHAPE[1], SHAPE[2],
                                                      SHAPE[0])
        if t > 1:
            assert rec[f"members_{t}"].tolist() == get_volumes_list(
                t, [], ENSEMBLE["sampling_number"], ENSEMBLE["adjacent"], 1)
    assert rec["members_21"].tolist() == list(range(1, 21))
    acts = rec["activities"]
    assert acts.shape == (N_VOLS, n1) and np.isfinite(acts).all()
    # the ensemble is a different prediction from the single-mode run
    assert any(not np.array_equal(rec[f"coords_{t}"], record[f"coords_{t}"])
               for t in range(2, N_VOLS + 1))


@pytest.fixture(scope="module")
def tiled_record():
    with np.load(TILED_RECORD) as data:
        return {k: data[k] for k in data.files}


def test_tiled_record_holds_its_recipe(tiled_record, record):
    """JAX's two-step run with the tiled segmentation: the recipe it
    states, each volume's kept cells and tracked coordinates, the first
    volume's ``auto_vol1`` labels (uint8, one id per kept cell) and the
    metrics, within the labels budget.  Away from the y faces (farther
    than the bench network's receptive field, 57 voxels) its kept cells
    are the whole-volume record's."""
    rec = tiled_record
    assert TILED_RECORD.stat().st_size < LABELS_BUDGET
    recipe = json.loads(str(rec["recipe"]))
    assert tuple(recipe["tile_shape"]) == TILE_SHAPE
    for key in ("tile_candidates", "tile_batch", "shrink"):
        assert recipe[key] == TILED[key], key
    assert tuple(recipe["voxel_size"]) == VOXEL_SIZE
    assert recipe["interpolation_factor"] == 10
    assert (recipe["beta"], recipe["lambda_"]) == (3.0, 3.0)
    assert recipe["max_candidates"] == MAX_CANDIDATES
    assert tuple(recipe["render_box"]) == RENDER_BOX
    metrics = json.loads(str(rec["metrics"]))
    assert set(metrics) >= {"gate", "strict_recall", "id_switches",
                            "cpu_wall_s", "cpu_seg_wall_s"}
    n1 = rec["coords_1"].shape[0]
    for t in range(1, N_VOLS + 1):
        seg = rec[f"seg_coords_{t}"]
        assert seg.ndim == 2 and seg.shape[1] == 3 and seg.dtype == np.int32
        assert 0 < len(seg) <= MAX_CANDIDATES
        assert rec[f"coords_{t}"].shape == (n1, 3)
        assert np.isfinite(rec[f"coords_{t}"]).all()
        inner = [{tuple(p) for p in s if 57 < p[0] < SHAPE[1] - 1 - 57}
                 for s in (seg, record[f"seg_coords_{t}"])]
        assert inner[0] == inner[1], t
    lab = rec["auto_vol1"]
    assert lab.shape == (SHAPE[1], SHAPE[2], SHAPE[0])
    assert lab.dtype == np.uint8
    assert len(np.unique(lab)) - 1 == len(rec["seg_coords_1"])


@pytest.fixture(scope="module")
def u8_record():
    with np.load(U8_RECORD) as data:
        return {k: data[k] for k in data.files}


def test_u8_record_holds_the_bench_run(u8_record, record):
    """JAX's run with the 8-bit upload: every volume's kept cells and
    tracked coordinates and the recorded labels, as the u16 record holds
    them, within the labels budget; its accuracy as BASELINE.md found it
    (strict recall 1.0, 0 identity switches), while its segmentation is
    not the lossless run's in every volume."""
    rec = u8_record
    assert U8_RECORD.stat().st_size < LABELS_BUDGET
    metrics = json.loads(str(rec["metrics"]))
    assert metrics["transport"] == "u8"
    assert metrics["strict_recall"] == 1.0 and metrics["id_switches"] == 0
    n1 = rec["coords_1"].shape[0]
    assert n1 == record["coords_1"].shape[0]
    for t in range(1, N_VOLS + 1):
        seg = rec[f"seg_coords_{t}"]
        assert seg.ndim == 2 and seg.shape[1] == 3 and seg.dtype == np.int32
        assert 0 < len(seg) <= MAX_CANDIDATES
        assert rec[f"coords_{t}"].shape == (n1, 3)
        assert np.isfinite(rec[f"coords_{t}"]).all()
    labels = [k for k in rec if k.startswith("labels_")]
    assert labels
    for k in labels:
        assert rec[k].shape == (SHAPE[1], SHAPE[2], SHAPE[0])
        assert rec[k].dtype == np.uint8
    assert any(not np.array_equal(rec[f"seg_coords_{t}"],
                                  record[f"seg_coords_{t}"])
               for t in range(1, N_VOLS + 1))


@pytest.fixture(scope="module")
def refine_record():
    with np.load(REFINE_RECORD) as data:
        return {k: data[k] for k in data.files}


def test_refine_record_holds_the_bench_run(refine_record, record):
    """JAX's run with ``m_step_refine=REFINE``: the u16 record's kept cells
    in every volume (the segmentation is the same), tracked coordinates
    and labels as that record holds them, each tracked volume's EM
    iteration count, strict recall 1.0 and 0 identity switches; the
    coordinates are not the floored EM's."""
    rec = refine_record
    assert REFINE_RECORD.stat().st_size < LABELS_BUDGET
    metrics = json.loads(str(rec["metrics"]))
    assert metrics["m_step_refine"] == REFINE
    assert metrics["strict_recall"] == 1.0 and metrics["id_switches"] == 0
    iters = rec["em_iterations"]
    assert iters.shape == (N_VOLS - 1,) and iters.dtype == np.int32
    assert ((iters > 1) & (iters < 2000)).all()
    n1 = record["coords_1"].shape[0]
    for t in range(1, N_VOLS + 1):
        np.testing.assert_array_equal(rec[f"seg_coords_{t}"],
                                      record[f"seg_coords_{t}"])
        assert rec[f"coords_{t}"].shape == (n1, 3)
        assert np.isfinite(rec[f"coords_{t}"]).all()
    labels = [k for k in rec if k.startswith("labels_")]
    assert labels
    for k in labels:
        assert rec[k].shape == (SHAPE[1], SHAPE[2], SHAPE[0])
        assert rec[k].dtype == np.uint8
    assert any(not np.array_equal(rec[f"coords_{t}"], record[f"coords_{t}"])
               for t in range(2, N_VOLS + 1))


def test_port_scene_is_the_bench_scene(tmp_path):
    """``utils.synthetic.make_recording`` gives the volumes, labels and
    centres that ``bench.make_recording`` writes (first two volumes)."""
    from t3dct.io.imageio import load_2d_slices_at_time
    with jax_script(REPO / "bench.py", "jax_bench",
                    tmp_path / "xla") as bench:
        bench.N_VOLS = 2
        pattern, centers, lab1 = bench.make_recording(tmp_path)
    vols, my_centers, my_lab1 = make_recording(2, shape=SHAPE)
    np.testing.assert_array_equal(my_lab1, lab1)
    for t in (1, 2):
        np.testing.assert_array_equal(
            load_2d_slices_at_time(pattern, t, do_normalize=False),
            vols[t - 1])
        np.testing.assert_array_equal(my_centers[t], centers[t])


def hold_to_record(record, results: Path, coords, centers,
                   kept_as_sets: bool = False, coord_median=COORD_MEDIAN,
                   labels_equal=LABELS_EQUAL) -> dict:
    """Phase 11's checks on a run of the port (without the candidate
    margins, which need the run's candidates): kept cells exact (with
    ``kept_as_sets``, the same cells in any order), coords and labels
    within the bounds, strict recall and switches equal."""
    from t3dct_torch.engine.metrics import tracking_id_metrics
    from t3dct_torch.io.imageio import imread_stack
    want = json.loads(str(record["metrics"]))
    gate = want["gate"]
    for t in range(1, N_VOLS + 1):
        got = np.load(results / "seg" / f"coords{t:06d}.npy")
        if kept_as_sets:
            assert got.shape == record[f"seg_coords_{t}"].shape
            got = got[np.lexsort(got.T)]
            ref = record[f"seg_coords_{t}"]
            np.testing.assert_array_equal(got, ref[np.lexsort(ref.T)])
        else:
            np.testing.assert_array_equal(got, record[f"seg_coords_{t}"])
        d = np.linalg.norm(coords[t] - record[f"coords_{t}"], axis=1)
        assert np.median(d) <= coord_median and d.max() <= gate, t
        if f"labels_{t}" in record:
            lab = imread_stack(sorted((results / "track_results" / "labels")
                                      .glob("track_results_t%06i_z*.tif"
                                            % t))).transpose(1, 2, 0)
            assert (lab == record[f"labels_{t}"]).mean() >= labels_equal
    got = tracking_id_metrics(coords, centers, VOXEL_SIZE, N_VOLS)
    assert got["strict_recall"] == want["strict_recall"]
    assert got["id_switches"] == want["id_switches"]
    return got


@pytest.mark.slow
def test_record_rederives_with_jax(record, tmp_path):
    """JAX re-run from the committed weights: the same record within the
    phase's bounds (exact on the machine that wrote it)."""
    out = tmp_path / "again.npz"
    write_record(out, tmp_path / "work")
    want = json.loads(str(record["metrics"]))
    with np.load(out) as again:
        for t in range(1, N_VOLS + 1):
            np.testing.assert_array_equal(again[f"seg_coords_{t}"],
                                          record[f"seg_coords_{t}"])
            d = np.linalg.norm(again[f"coords_{t}"] - record[f"coords_{t}"],
                               axis=1)
            assert np.median(d) <= COORD_MEDIAN and d.max() <= want["gate"]
        got = json.loads(str(again["metrics"]))
        for key in ("strict_recall", "id_switches"):
            assert got[key] == want[key]


@pytest.mark.slow
def test_port_on_cpu_matches_record(record, tmp_path):
    """The port's ``segment_and_track`` on the CPU over the whole bench
    scene with the committed weights, held to the record."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import segment_and_track
    pattern, centers = chip_smoke.write_bench_scene(tmp_path)
    model = StarDist3D.load(ASSETS / "sd_model", device="cpu")
    model.max_candidates, model.render_box = MAX_CANDIDATES, RENDER_BOX
    results = tmp_path / "results"
    coords = segment_and_track(
        pattern, model, results, str(results / "manual_vol1" / "*.tif"),
        ASSETS / "ffn.npz", VOXEL_SIZE, 10, (1, N_VOLS),
        TrackingConfig(beta=3.0, lambda_=3.0), verbose=False,
        handoff="device", device="cpu")
    hold_to_record(record, results, coords, centers)


@pytest.mark.slow
def test_port_u8_on_cpu_matches_record(u8_record, tmp_path):
    """The port's ``segment_and_track(transport="u8")`` on the CPU over the
    whole bench scene, held to JAX's u8 record.  The 8-bit volumes leave
    near-ties among the kept cells' probabilities (at t = 4 two at
    0.842037, 1.4e-7 apart), which the two frameworks' f32 sums order
    either way, so the kept cells are held as sets, as phase 28 holds
    them (``chip_smoke.kept_difference``)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import segment_and_track
    pattern, centers = chip_smoke.write_bench_scene(tmp_path)
    model = StarDist3D.load(ASSETS / "sd_model", device="cpu")
    model.max_candidates, model.render_box = MAX_CANDIDATES, RENDER_BOX
    results = tmp_path / "results"
    coords = segment_and_track(
        pattern, model, results, str(results / "manual_vol1" / "*.tif"),
        ASSETS / "ffn.npz", VOXEL_SIZE, 10, (1, N_VOLS),
        TrackingConfig(beta=3.0, lambda_=3.0), verbose=False,
        handoff="device", transport="u8", device="cpu")
    hold_to_record(u8_record, results, coords, centers, kept_as_sets=True)


@pytest.mark.slow
@pytest.mark.parametrize("em_threads", [1, 2, 3, 4])
def test_port_refine_on_cpu_matches_record(refine_record, tmp_path,
                                           em_threads):
    """The port's ``segment_and_track`` with ``m_step_refine=REFINE`` on
    the CPU over the whole bench scene, held to JAX's refine record by
    phase 29's rule (kept cells exact, the coordinates and labels within
    ``chip_smoke.REFINE_*``) and with strict recall and identity switches
    equal.  The run with the EM on one torch thread set those bounds at
    twice its own departure (the refined EM is chaotic: a volume's median
    up to 0.5782 real units, labels 0.997608 equal at least, EM
    iterations 40-305 a volume against JAX's 39-262); the thread count
    sets the float32 summation order, so 2-4 threads are other
    trajectories (medians up to 0.6251).  The segmentation runs on every
    thread.  Prints each volume's departure."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine import pipeline
    from t3dct_torch.engine.pipeline import segment_and_track
    from test_torch_scene import torch_threads
    pattern, centers = chip_smoke.write_bench_scene(tmp_path)
    model = StarDist3D.load(ASSETS / "sd_model", device="cpu")
    model.max_candidates, model.render_box = MAX_CANDIDATES, RENDER_BOX
    results = tmp_path / "results"
    track = pipeline.track_from_seg

    def em_thread_track(*args, **kwargs):
        with torch_threads(em_threads):
            return track(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "track_from_seg", em_thread_track)
        coords = segment_and_track(
            pattern, model, results,
            str(results / "manual_vol1" / "*.tif"), ASSETS / "ffn.npz",
            VOXEL_SIZE, 10, (1, N_VOLS),
            TrackingConfig(beta=3.0, lambda_=3.0, m_step_refine=REFINE),
            verbose=False, handoff="device", device="cpu")
    for t in range(1, N_VOLS + 1):
        d = np.linalg.norm(coords[t] - refine_record[f"coords_{t}"], axis=1)
        print(f"t={t}: median {np.median(d):.4f}, max {d.max():.3f}")
    hold_to_record(refine_record, results, coords, centers,
                   coord_median=chip_smoke.REFINE_COORD_MEDIAN,
                   labels_equal=chip_smoke.REFINE_LABELS_EQUAL)


@pytest.mark.slow
def test_port_tiled_on_cpu_matches_record(tiled_record, tmp_path):
    """The port's two-step workflow with the tiled segmentation on the CPU
    over the whole bench scene, held to JAX's tiled record with phase
    11's bounds, and its first volume's ``auto_vol1`` labels exactly."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import track_timelapse
    from t3dct_torch.engine.stardist import predict_and_save
    from t3dct_torch.io.imageio import imread_stack
    pattern, centers = chip_smoke.write_bench_scene(tmp_path)
    model = StarDist3D.load(ASSETS / "sd_model", device="cpu")
    model.max_candidates, model.render_box = MAX_CANDIDATES, RENDER_BOX
    results = tmp_path / "results"
    predict_and_save(pattern, model, results, **TILED)
    coords = track_timelapse(
        results, str(results / "manual_vol1" / "*.tif"), ASSETS / "ffn.npz",
        VOXEL_SIZE, 10, (1, N_VOLS), grid=(1, 2, 2),
        config=TrackingConfig(beta=3.0, lambda_=3.0), verbose=False,
        device="cpu")
    hold_to_record(tiled_record, results, coords, centers)
    lab = imread_stack(sorted((results / "auto_vol1").glob("*.tif")))
    np.testing.assert_array_equal(lab.transpose(1, 2, 0),
                                  tiled_record["auto_vol1"])


@pytest.mark.slow
def test_port_ensemble_on_cpu_matches_record(ensemble_record, tmp_path):
    """The port's two-step workflow on the CPU over the whole bench scene,
    ensemble mode, held to JAX's ensemble record with phase 13's bounds,
    and its activities within 1e-4 relative of the record's."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import track_timelapse
    from t3dct_torch.engine.stardist import predict_and_save
    from t3dct_torch.engine.tracker import TrackerLite as PortTracker
    pattern, centers = chip_smoke.write_bench_scene(tmp_path)
    model = StarDist3D.load(ASSETS / "sd_model", device="cpu")
    model.max_candidates, model.render_box = MAX_CANDIDATES, RENDER_BOX
    results = tmp_path / "results"
    predict_and_save(pattern, model, results)
    coords = track_timelapse(
        results, str(results / "manual_vol1" / "*.tif"), ASSETS / "ffn.npz",
        VOXEL_SIZE, 10, (1, N_VOLS), grid=(1, 2, 2),
        config=TrackingConfig(**ENSEMBLE), verbose=False, device="cpu")
    hold_to_record(ensemble_record, results, coords, centers)
    vol1 = Coordinates.from_real(coords[1], 10, VOXEL_SIZE, device="cpu")
    acts = PortTracker(results, ASSETS / "ffn.npz", vol1).activities(
        pattern, discard_ratio=ACTIVITY_DISCARD)
    np.testing.assert_allclose(acts, ensemble_record["activities"],
                               rtol=1e-4)


if __name__ == "__main__":
    import argparse
    import os
    import tempfile
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="run JAX over the bench scene and write "
                         "assets/bench/jax_record.npz")
    ap.add_argument("--write-ensemble", action="store_true",
                    help="run JAX's two-step workflow in ensemble mode "
                         "over the bench scene and write "
                         "assets/bench/jax_record_ensemble.npz")
    ap.add_argument("--write-tiled", action="store_true",
                    help="run JAX's two-step workflow with the tiled "
                         "segmentation over the bench scene and write "
                         "assets/bench/jax_record_tiled.npz")
    ap.add_argument("--write-u8", action="store_true",
                    help="run JAX over the bench scene with "
                         "transport='u8' and write "
                         "assets/bench/jax_record_u8.npz")
    ap.add_argument("--write-refine", action="store_true",
                    help="run JAX over the bench scene with "
                         "m_step_refine=REFINE and write "
                         "assets/bench/jax_record_refine.npz")
    args = ap.parse_args()
    if not (args.write or args.write_ensemble or args.write_tiled
            or args.write_u8 or args.write_refine):
        ap.error("nothing to do without --write, --write-ensemble, "
                 "--write-tiled, --write-u8 or --write-refine")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    for flag, path, writer in ((args.write, RECORD, write_record),
                               (args.write_ensemble, ENSEMBLE_RECORD,
                                write_ensemble_record),
                               (args.write_tiled, TILED_RECORD,
                                write_tiled_record),
                               (args.write_u8, U8_RECORD,
                                lambda out, work: write_record(
                                    out, work, transport="u8")),
                               (args.write_refine, REFINE_RECORD,
                                lambda out, work: write_record(
                                    out, work, m_step_refine=REFINE))):
        if flag:
            with tempfile.TemporaryDirectory() as tmp:
                m = writer(path, Path(tmp))
            print(json.dumps(m))
            print(f"{path}: {path.stat().st_size} bytes")
