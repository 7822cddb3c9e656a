"""The v1.0 two-step workflow of the examples against the JAX package's, on
the CPU, over the small TIFF recording of ``test_torch_driver.py`` ((8, 64,
48) volumes, 12 cells, the small StarDist with its pass-through path, the
same weights in both packages): ``predict_and_save``, then
``track_timelapse`` in single and ensemble mode, and
``segment_and_track(handoff="disk")``, which runs both at once.

Bounds (those of ``test_torch_driver.py``): seg coordinates exact; prob
maps within 1e-3 (both store the float16 map; one float16 step is 4.9e-4
near 1); tracked coordinates within 1e-2 real units (the f32 EM moves
JAX's own output by ~2e-3 for a 1-ulp input change), but for at most one
cell per volume, which may land one rounding step apart (less than 1.5
real units) when the EM noise straddles a rounding boundary of the
correction loop's integer displacement (``test_slice_rounding_flip_is_
one_step``): in ensemble mode at t = 6 one cell's y displacement is
-2.50015 interp steps in JAX and -2.49984 in the port, from member
predictions 1.8e-3 apart; labels at least 99.5% of voxels equal per
volume; the same file names in both trees.
Single-mode and ensemble tracking run from one ``seg/`` tree (JAX's), so
the comparison holds the tracking alone."""

import inspect
import shutil
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import t3dct_torch  # noqa: F401
from t3dct.config import TrackingConfig as JTrackingConfig
from t3dct.engine.pipeline import segment_and_track as j_segment_and_track
from t3dct.engine.pipeline import track_timelapse as j_track_timelapse
from t3dct.engine.stardist import predict_and_save as j_predict_and_save
from t3dct_torch.config import StarDistConfig, TrackingConfig
from t3dct_torch.engine import pipeline
from t3dct_torch.engine.pipeline import segment_and_track, track_timelapse
from t3dct_torch.engine.stardist import (StarDist3D, load_stardist_model,
                                         predict_and_save)
from t3dct_torch.io import imageio
from t3dct_torch.io.artifacts import ResultsTree
from test_torch_driver import files, manual_vol1, write_recording
from test_torch_scene import (INTERP, REPO, SHAPE, VOXEL_SIZE, ffn_pair,
                              recording, stardist_pair)

N_VOLS = 7
COORD_ATOL = 1e-2
LABELS_EQUAL = 0.995
PROB_ATOL = 1e-3
GRID = (1, 2, 2)
ENSEMBLE = dict(ensemble=True, sampling_number=20, trim_proportion=0.25)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    vols, _, lab = recording(N_VOLS, seed=1)
    return root, write_recording(root, vols, lab), vols, lab


@pytest.fixture(scope="module")
def models():
    jm, tm = stardist_pair()
    jffn, tffn = ffn_pair()
    return jm, tm, jffn, tffn


@pytest.fixture(scope="module")
def segmented(scene, models):
    """Both packages' ``predict_and_save`` over the recording."""
    root, pattern, _, _ = scene
    jm, tm, _, _ = models
    j_predict_and_save(pattern, jm, root / "jax_seg")
    predict_and_save(pattern, tm, root / "port_seg")
    return root / "jax_seg", root / "port_seg"


def _labels(root: Path, t: int) -> np.ndarray:
    pat = "track_results/labels/track_results_t%06i_z*.tif" % t
    return np.stack([imageio.imread(p) for p in sorted(root.glob(pat))])


def _seg_tree_copy(src: Path, dst: Path, lab) -> str:
    """A results tree holding ``src``'s ``seg/`` and the proofed vol-1
    labels; returns the manual_vol1 glob."""
    shutil.copytree(src / "seg", dst / "seg")
    return manual_vol1(dst, lab)


# ---- predict_and_save ---------------------------------------------------


def test_predict_and_save_files_match_jax(segmented):
    jax_root, port_root = segmented
    assert files(port_root) == files(jax_root)
    names = files(jax_root)
    assert sum(n.startswith("seg/") for n in names) == 2 * N_VOLS
    assert sum(n.startswith("auto_vol1/") for n in names) == SHAPE[0]


def test_predict_and_save_seg_matches_jax(segmented):
    """Seg coordinates exact (dtype and order included), prob maps in the
    (x, y, z) grid frame within ``PROB_ATOL``."""
    jax_root, port_root = segmented
    jt, pt = ResultsTree(jax_root), ResultsTree(port_root)
    for t in range(1, N_VOLS + 1):
        got, want = pt.load_seg_coords(t), jt.load_seg_coords(t)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        gp, wp = pt.load_seg_prob(t), jt.load_seg_prob(t)
        assert gp.dtype == wp.dtype == np.float32
        assert gp.shape == wp.shape == (SHAPE[1] // 2, SHAPE[2] // 2,
                                        SHAPE[0])
        np.testing.assert_allclose(gp, wp, atol=PROB_ATOL)
        # float16 values, as the device ships the map
        np.testing.assert_array_equal(gp.astype(np.float16), gp)


def test_predict_and_save_auto_vol1_matches_jax(segmented):
    jax_root, port_root = segmented
    for p in sorted((jax_root / "auto_vol1").iterdir()):
        got = imageio.imread(port_root / "auto_vol1" / p.name)
        want = imageio.imread(p)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_predict_and_save_volumes_and_progress(scene, models, segmented,
                                               tmp_path):
    """``volumes=`` segments those volumes only (no ``auto_vol1``: the
    recording's first is not among them), with the full run's artifacts;
    ``progress_cb`` comes once per volume, after its artifacts are on
    disk."""
    _, pattern, _, _ = scene
    _, tm, _, _ = models
    seen, lock = [], threading.Lock()
    tree = ResultsTree(tmp_path)

    def cb(t):
        assert tree.load_seg_coords(t) is not None
        assert tree.load_seg_prob(t).shape[2] == SHAPE[0]
        with lock:
            seen.append(t)

    predict_and_save(pattern, tm, tmp_path, volumes=[3, 5, 6],
                     progress_cb=cb)
    assert sorted(seen) == [3, 5, 6]
    assert sorted(n for n in files(tmp_path) if n.startswith("seg/")) == \
        [f"seg/coords{t:06d}.npy" for t in (3, 5, 6)] + \
        [f"seg/prob{t:06d}.npy" for t in (3, 5, 6)]
    assert not (tmp_path / "auto_vol1").exists()
    full = ResultsTree(segmented[1])
    for t in (3, 5, 6):
        np.testing.assert_array_equal(tree.load_seg_coords(t),
                                      full.load_seg_coords(t))


def test_predict_and_save_should_stop(scene, models, tmp_path):
    """The sweep ends at the first poll that says stop, after the volumes
    before it."""
    _, pattern, _, _ = scene
    _, tm, _, _ = models
    polls = []

    def stop():
        polls.append(1)
        return len(polls) > 2

    predict_and_save(pattern, tm, tmp_path, should_stop=stop)
    assert sorted(p.name for p in (tmp_path / "seg").glob("coords*")) == \
        ["coords000001.npy", "coords000002.npy"]


def test_predict_and_save_end_of_recording(scene, models, tmp_path,
                                           capsys):
    """Volume 3 missing: JAX's warning, the volumes before it written, and
    no error; the same files as JAX's run."""
    _, _, vols, lab = scene
    jm, tm, _, _ = models
    pattern = write_recording(tmp_path, vols[:4], lab, skip=(3,))
    predict_and_save(pattern, tm, tmp_path / "port")
    out = capsys.readouterr().out
    assert "Warning: segmentation stopped; images at t=3 cannot be " \
        "loaded!" in out
    j_predict_and_save(pattern, jm, tmp_path / "jax")
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert (tmp_path / "port/seg/coords000002.npy").exists()
    assert not (tmp_path / "port/seg/coords000004.npy").exists()


def test_predict_and_save_write_failure_raises(scene, models, tmp_path,
                                               monkeypatch):
    """A write failure surfaces as itself, not as the end of the
    recording."""
    _, pattern, _, _ = scene
    _, tm, _, _ = models

    def broken(self, t, prob):
        raise FileNotFoundError(f"disk gone at t={t}")

    monkeypatch.setattr(ResultsTree, "save_seg_prob", broken)
    with pytest.raises(FileNotFoundError, match="disk gone at t="):
        predict_and_save(pattern, tm, tmp_path)


@pytest.mark.parametrize("kwargs,err,match", [
    (dict(tile_shape=(None, 32, 32), mesh=object()), ValueError,
     "mutually exclusive"),
    (dict(mesh=object()), TypeError, "DeviceMesh"),
    (dict(transport="u8"), NotImplementedError, "A.5b"),
], ids=["tiles", "mesh", "u8"])
def test_predict_and_save_raises_for_what_is_not_ported(tmp_path, kwargs,
                                                        err, match):
    """Each raises before anything is written: tiles over a mesh (JAX's
    ``ValueError``; ``predict_instances_sharded`` shards tiles), a mesh
    that is no ``DeviceMesh``, and the u8 wire format (A.5b).  The mesh
    runs are ``tests/test_torch_mesh_*.py``."""
    with pytest.raises(err, match=match):
        predict_and_save(str(tmp_path / "r_t%03i_z*.tif"), None,
                         tmp_path / "res", **kwargs)
    assert not (tmp_path / "res").exists()


def test_predict_and_save_hdf5_raises(tmp_path, models, monkeypatch):
    """Where ``h5py`` does not import (the card's machine), an HDF5
    recording raises an ``ImportError`` that names it before anything is
    written; a dict naming another file type raises JAX's
    ``AssertionError``.  ``tests/test_torch_h5.py`` runs HDF5
    recordings."""
    _, tm, _, _ = models
    with pytest.raises(AssertionError, match="HDF5"):
        predict_and_save({"h5_file": str(tmp_path / "r.tif"), "channel": 0},
                         tm, tmp_path / "res")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        predict_and_save({"h5_file": str(tmp_path / "r.h5"), "channel": 0},
                         tm, tmp_path / "res")
    assert not (tmp_path / "res").exists()


@pytest.mark.parametrize("handoff", ["disk", "device"])
def test_segment_and_track_hdf5_raises(tmp_path, models, handoff,
                                       monkeypatch):
    """Without ``h5py`` an HDF5 recording raises an ``ImportError`` that
    names it before anything is read or written, whichever the
    handoff."""
    _, tm, _, tffn = models
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        segment_and_track({"h5_file": str(tmp_path / "r.h5"), "channel": 0},
                          tm, tmp_path / "res", str(tmp_path / "m/*.tif"),
                          tffn, VOXEL_SIZE, INTERP, (1, 2), handoff=handoff,
                          verbose=False, device="cpu")
    assert not (tmp_path / "res").exists()


def test_load_stardist_model(tmp_path):
    """The committed folder loads as ``StarDist3D.load`` loads it; a
    reference Keras folder loads as an ``arch="keras"`` model with its
    thresholds (``tests/test_torch_keras.py`` holds it against JAX)."""
    from test_torch_keras import (SMALL, keras_stardist_params,
                                  write_reference_folder)
    assets = REPO / "3deecelltracker_tpu_torch" / "assets" / "bench"
    model = load_stardist_model("sd_model", basedir=str(assets),
                                device="cpu")
    ref = StarDist3D.load(assets / "sd_model", device="cpu")
    assert model.thresholds == ref.thresholds
    assert model.config == ref.config
    assert model.arch == "tpu"
    cfg = StarDistConfig(**SMALL["g122"])
    write_reference_folder(tmp_path / "keras", cfg,
                           keras_stardist_params(cfg),
                           {"prob": 0.4, "nms": 0.2})
    keras = load_stardist_model("keras", basedir=str(tmp_path),
                                device="cpu")
    assert keras.arch == "keras" and keras.config == cfg
    assert keras.thresholds == {"prob": 0.4, "nms": 0.2}


# ---- track_timelapse ----------------------------------------------------


def _track_both(segmented, scene, models, tmp_path, config_kw, miss_frame):
    root, pattern, _, lab = scene
    _, _, jffn, tffn = models
    jax_root, _ = segmented
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jglob = _seg_tree_copy(jax_root, jdir, lab)
    pglob = _seg_tree_copy(jax_root, pdir, lab)
    want = j_track_timelapse(jdir, jglob, jffn, VOXEL_SIZE, INTERP,
                             (1, N_VOLS), grid=GRID,
                             config=JTrackingConfig(**config_kw),
                             miss_frame=miss_frame, images_path=pattern,
                             verbose=False)
    got = track_timelapse(pdir, pglob, tffn, VOXEL_SIZE, INTERP,
                          (1, N_VOLS), grid=GRID,
                          config=TrackingConfig(**config_kw),
                          miss_frame=miss_frame, images_path=pattern,
                          verbose=False, device="cpu")
    return jdir, pdir, {t: np.asarray(c) for t, c in want.items()}, got


def _hold(jdir, pdir, want, got, miss_frame):
    assert sorted(got) == sorted(want) == list(range(1, N_VOLS + 1))
    for t in want:
        assert got[t].dtype == np.float32 and got[t].shape == want[t].shape
        assert np.isfinite(got[t]).all()
        off = np.abs(got[t] - want[t]).max(axis=1)
        assert (off > COORD_ATOL).sum() <= 1 and off.max() < 1.5, (t, off)
    assert files(pdir) == files(jdir)
    for t in range(1, N_VOLS + 1):
        if t in (miss_frame or []):
            assert not list(pdir.glob("track_results/**/*t%06i*" % t))
            continue
        got_l, want_l = _labels(pdir, t), _labels(jdir, t)
        assert got_l.dtype == want_l.dtype == np.uint8
        assert (got_l == want_l).mean() >= LABELS_EQUAL, t


@pytest.mark.parametrize("miss_frame", [None, [3]], ids=["all", "miss3"])
def test_track_timelapse_single_matches_jax(segmented, scene, models,
                                            tmp_path, miss_frame):
    jdir, pdir, want, got = _track_both(segmented, scene, models, tmp_path,
                                        {}, miss_frame)
    _hold(jdir, pdir, want, got, miss_frame)
    if miss_frame:
        np.testing.assert_array_equal(got[3], got[2])


@pytest.mark.parametrize("miss_frame", [None, [3]], ids=["all", "miss3"])
def test_track_timelapse_ensemble_matches_jax(segmented, scene, models,
                                              tmp_path, miss_frame,
                                              monkeypatch):
    """Ensemble mode with ``trim_proportion`` 0.25, so that members are cut
    from t = 5 on; the members per volume are ``get_volumes_list``'s,
    without the miss frame."""
    calls = []
    fan_out = pipeline.ensemble_member_predictions

    def counted(params, state, confirmed, *args, **kwargs):
        calls.append(int(confirmed.shape[0]))
        return fan_out(params, state, confirmed, *args, **kwargs)

    monkeypatch.setattr(pipeline, "ensemble_member_predictions", counted)
    jdir, pdir, want, got = _track_both(segmented, scene, models, tmp_path,
                                        ENSEMBLE, miss_frame)
    _hold(jdir, pdir, want, got, miss_frame)
    skip = miss_frame or []
    assert calls == [len([v for v in range(1, t) if v not in skip])
                     for t in range(2, N_VOLS + 1) if t not in skip]


def test_track_timelapse_ensemble_differs_from_single(segmented, scene,
                                                      models, tmp_path):
    """The ensemble branch is a different prediction: its coordinates are
    not single mode's at every volume."""
    _, _, _, single = _track_both(segmented, scene, models, tmp_path / "s",
                                  {}, None)
    _, _, _, ens = _track_both(segmented, scene, models, tmp_path / "e",
                               ENSEMBLE, None)
    assert any(not np.array_equal(single[t], ens[t])
               for t in range(2, N_VOLS + 1))


@pytest.mark.parametrize("kwargs,err,match", [
    (dict(mesh=object()), TypeError, "DeviceMesh"),
    (dict(save_figures=True), NotImplementedError, "A.9")],
    ids=["mesh", "figures"])
def test_track_timelapse_raises_for_what_is_not_ported(tmp_path, kwargs,
                                                       err, match):
    with pytest.raises(err, match=match):
        track_timelapse(tmp_path, str(tmp_path / "m/*.tif"), None,
                        VOXEL_SIZE, INTERP, (1, 2), device="cpu", **kwargs)


# ---- segment_and_track(handoff="disk") -----------------------------------


@pytest.fixture(scope="module")
def disk_runs(scene, models):
    root, pattern, _, lab = scene
    jm, tm, jffn, tffn = models
    out = {}
    for name, fn, model, ffn, kw in (
            ("jax", j_segment_and_track, jm, jffn,
             dict(config=JTrackingConfig(), handoff="disk")),
            ("disk", segment_and_track, tm, tffn,
             dict(config=TrackingConfig(), device="cpu")),
            ("device", segment_and_track, tm, tffn,
             dict(config=TrackingConfig(), handoff="device",
                  device="cpu"))):
        res = root / f"sat_{name}"
        coords = fn(pattern, model, res, manual_vol1(res, lab), ffn,
                    VOXEL_SIZE, INTERP, (1, N_VOLS), verbose=False, **kw)
        out[name] = (res, {t: np.asarray(c) for t, c in coords.items()})
    return out


@pytest.mark.parametrize("other", ["jax", "device"])
def test_disk_handoff_matches(disk_runs, other):
    """The port's disk handoff against JAX's, and against the port's
    device handoff: the same files, seg artifacts, coordinates and
    labels."""
    pdir, got = disk_runs["disk"]
    odir, want = disk_runs[other]
    _hold(odir, pdir, want, got, None)
    pt, ot = ResultsTree(pdir), ResultsTree(odir)
    for t in range(1, N_VOLS + 1):
        np.testing.assert_array_equal(pt.load_seg_coords(t),
                                      ot.load_seg_coords(t))
        np.testing.assert_allclose(pt.load_seg_prob(t), ot.load_seg_prob(t),
                                   atol=PROB_ATOL)


def test_disk_and_device_handoffs_agree_exactly_on_seg(disk_runs):
    """The port's two handoffs run the same seg call per volume: seg/ and
    auto_vol1/ are bit-equal."""
    pdir, _ = disk_runs["disk"]
    ddir, _ = disk_runs["device"]
    for name in files(pdir):
        if name.startswith(("seg/", "auto_vol1/")):
            assert (pdir / name).read_bytes() == (ddir / name).read_bytes()


def test_default_handoff_is_jax():
    """The port's ``segment_and_track`` defaults to JAX's handoff, and
    every parameter JAX's has keeps its default."""
    mine = inspect.signature(segment_and_track).parameters
    theirs = inspect.signature(j_segment_and_track).parameters
    assert mine["handoff"].default == theirs["handoff"].default == "disk"
    for name, p in theirs.items():
        if name in mine and name != "config":
            assert mine[name].default == p.default, name


def test_disk_handoff_ensemble_runs(scene, models, tmp_path):
    """Ensemble tracking through the disk handoff: every volume tracked,
    the tree complete."""
    _, pattern, _, lab = scene
    _, tm, _, tffn = models
    coords = segment_and_track(pattern, tm, tmp_path,
                               manual_vol1(tmp_path, lab), tffn, VOXEL_SIZE,
                               INTERP, (1, 4), TrackingConfig(**ENSEMBLE),
                               verbose=False, device="cpu")
    assert sorted(coords) == [1, 2, 3, 4]
    assert len(list(tmp_path.glob("track_results/coords_real/*"))) == 4


def test_disk_truncated_recording_raises(scene, models, tmp_path):
    """Volume 3 missing: volumes 1-2 tracked and written, then JAX's
    error."""
    _, _, vols, lab = scene
    _, tm, _, tffn = models
    pattern = write_recording(tmp_path, vols[:4], lab, skip=(3,))
    with pytest.raises(RuntimeError, match="segmentation ended at t=2 "
                                           "before volume 3"):
        segment_and_track(pattern, tm, tmp_path / "res",
                          manual_vol1(tmp_path / "res", lab), tffn,
                          VOXEL_SIZE, INTERP, (1, 4), verbose=False,
                          device="cpu")
    assert (tmp_path / "res/track_results/coords_real/"
            "coords000002.npy").exists()


class _Slow(StarDist3D):
    """The small model with a pause per volume, and a count of its
    calls."""

    pause = 0.3

    def predict_instances_device(self, *args, **kwargs):
        import time
        time.sleep(self.pause)
        self.calls = getattr(self, "calls", 0) + 1
        return super().predict_instances_device(*args, **kwargs)


def test_disk_tracking_failure_cancels_segmenter(scene, models, tmp_path):
    """Tracking fails at once (no proofed vol-1 labels): the error is
    tracking's, and the segmenter stops after its volume in flight instead
    of sweeping all seven volumes."""
    _, pattern, _, _ = scene
    _, tm, _, tffn = models
    model = _Slow(tm.config, tm.params, max_candidates=tm.max_candidates,
                  render_box=tm.render_box, device="cpu")
    with pytest.raises(FileNotFoundError, match="No image in"):
        segment_and_track(pattern, model, tmp_path,
                          str(tmp_path / "none" / "*.tif"), tffn,
                          VOXEL_SIZE, INTERP, (1, N_VOLS), verbose=False,
                          device="cpu")
    assert getattr(model, "calls", 0) < N_VOLS
    assert len(list((tmp_path / "seg").glob("coords*"))) < N_VOLS


class _Broken(StarDist3D):
    def predict_instances_device(self, *args, **kwargs):
        raise ArithmeticError("seg blew up")


def test_disk_segmenter_error_surfaces(scene, models, tmp_path):
    """A segmenter error reaches the caller's thread, as JAX's does:
    tracking stops with "segmentation failed" caused by it."""
    _, pattern, _, lab = scene
    _, tm, _, tffn = models
    model = _Broken(tm.config, tm.params, max_candidates=tm.max_candidates,
                    render_box=tm.render_box, device="cpu")
    with pytest.raises(RuntimeError, match="segmentation failed") as err:
        segment_and_track(pattern, model, tmp_path,
                          manual_vol1(tmp_path, lab), tffn, VOXEL_SIZE,
                          INTERP, (1, 3), verbose=False, device="cpu")
    assert isinstance(err.value.__cause__, ArithmeticError)
