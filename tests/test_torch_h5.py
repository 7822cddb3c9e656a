"""HDF5 recordings on the port (``io.imageio``: ``save_recording_h5``,
``load_2d_slices_at_time``, ``get_t_range``, ``check_recording``) and
through the v1.0 workflow (``predict_and_save``, ``track_timelapse``,
``segment_and_track`` and ``scripts/track_stardist_h5.py``), against the
JAX package on the CPU.

A recording is one (T, C, Z, Y, X) dataset addressed by ``{"h5_file",
"channel"[, "dset"]}``.  Tolerances: volumes read exactly; an HDF5
recording's ``seg/`` and ``track_results/`` bit-equal to those of its TIFF
twin (the same volumes as per-(t, z) slices); against JAX's run over the
HDF5 recording, the bounds of ``tests/test_torch_workflow.py`` (seg
coordinates exact, prob maps 1e-3, tracked coordinates 1e-2 but for one
cell per volume one rounding step apart, labels 99.5%).
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

import t3dct_torch  # noqa: F401
from t3dct.config import TrackingConfig as JTrackingConfig
from t3dct.engine.pipeline import track_timelapse as j_track_timelapse
from t3dct.engine.stardist import predict_and_save as j_predict_and_save
from t3dct.io import imageio as jio
from t3dct_torch.config import TrackingConfig
from t3dct_torch.engine.pipeline import segment_and_track, track_timelapse
from t3dct_torch.engine.stardist import predict_and_save
from t3dct_torch.io import imageio
from test_torch_driver import files, manual_vol1, write_recording
from test_torch_scene import INTERP, VOXEL_SIZE, ffn_pair, recording, \
    stardist_pair
from test_torch_workflow import COORD_ATOL, LABELS_EQUAL, PROB_ATOL

N_VOLS = 5
GRID = (1, 2, 2)


def h5_recording(path, vols, dset="default"):
    imageio.save_recording_h5(str(path), np.stack(vols), dset=dset)
    return {"h5_file": str(path), "channel": 0, "dset": dset}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("layout", ["TZYX", "TCZYX"])
def test_recording_reads_in_the_other_package(tmp_path, writer, layout):
    """A recording that one package writes, the other reads: every
    volume of every channel exactly (raw and normalized), the time range
    ``(T, 1)``, the dataset chunked per volume with gzip level 1."""
    import h5py
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 4000, (3, 2, 4, 9, 7)).astype(np.uint16)
    data = arr[:, 0] if layout == "TZYX" else arr
    save = jio.save_recording_h5 if writer == "jax" else \
        imageio.save_recording_h5
    save(str(tmp_path / "r.h5"), data, dset="vols")
    with h5py.File(tmp_path / "r.h5", "r") as f:
        d = f["vols"]
        assert d.chunks == (1, 1, 4, 9, 7) and d.compression == "gzip"
        assert d.compression_opts == 1 and d.dtype == np.uint16
    n_ch = 1 if layout == "TZYX" else 2
    for c in range(n_ch):
        rec = {"h5_file": str(tmp_path / "r.h5"), "channel": c,
               "dset": "vols"}
        for mod in (imageio, jio):
            assert mod.get_t_range(rec) == (3, 1)
        for t in (1, 2, 3):
            got = imageio.load_2d_slices_at_time(rec, t, do_normalize=False)
            assert got.dtype == np.uint16
            np.testing.assert_array_equal(got, arr[t - 1, c])
            np.testing.assert_array_equal(
                got, jio.load_2d_slices_at_time(rec, t, do_normalize=False))
            np.testing.assert_array_equal(
                imageio.load_2d_slices_at_time(rec, t),
                jio.load_2d_slices_at_time(rec, t))


def test_default_dataset_and_bad_shapes(tmp_path):
    """``dset`` defaults to ``"default"`` in both packages; a 3-D array is
    not a recording (JAX's ``ValueError``)."""
    vols = np.arange(2 * 3 * 4 * 5, dtype=np.uint16).reshape(2, 3, 4, 5)
    imageio.save_recording_h5(str(tmp_path / "a.h5"), vols)
    rec = {"h5_file": str(tmp_path / "a.h5"), "channel": 0}
    np.testing.assert_array_equal(
        jio.load_2d_slices_at_time(rec, 2, do_normalize=False), vols[1])
    for save in (imageio.save_recording_h5, jio.save_recording_h5):
        with pytest.raises(ValueError, match="expected"):
            save(str(tmp_path / "b.h5"), vols[0])


@pytest.mark.parametrize("case", ["extension", "type"])
def test_recording_checks_raise_as_jax(tmp_path, case):
    """A dict naming another file type raises JAX's ``AssertionError``
    (JAX's ``get_t_range`` skips that check and fails in h5py; the port's
    raises the same ``AssertionError``), anything but a str or a dict
    JAX's ``ValueError``, with JAX's messages."""
    bad = {"h5_file": str(tmp_path / "r.tif"), "channel": 0} \
        if case == "extension" else 17
    fns = ("load_2d_slices_at_time",) if case == "extension" else \
        ("load_2d_slices_at_time", "get_t_range")
    for fn in fns:
        args = (bad, 1) if fn == "load_2d_slices_at_time" else (bad,)
        with pytest.raises(Exception) as want:
            getattr(jio, fn)(*args)
        with pytest.raises(want.type) as got:
            getattr(imageio, fn)(*args)
        assert str(got.value) == str(want.value)
    for fn in (imageio.check_recording, imageio.get_t_range):
        with pytest.raises(want.type, match=re.escape(str(want.value))):
            fn(bad)


def test_hdf5_needs_h5py(tmp_path, monkeypatch):
    """Where ``h5py`` does not import, every HDF5 function raises an
    ``ImportError`` that names it; a TIFF recording still reads."""
    vols, _, lab = recording(1, seed=1)
    pattern = write_recording(tmp_path, vols, lab)
    rec = h5_recording(tmp_path / "r.h5", vols)
    monkeypatch.setitem(sys.modules, "h5py", None)
    for fn in (lambda: imageio.load_2d_slices_at_time(rec, 1),
               lambda: imageio.get_t_range(rec),
               lambda: imageio.check_recording(rec),
               lambda: imageio.save_recording_h5(str(tmp_path / "b.h5"),
                                                 np.stack(vols))):
        with pytest.raises(ImportError, match="h5py"):
            fn()
    np.testing.assert_array_equal(
        imageio.load_2d_slices_at_time(pattern, 1, do_normalize=False),
        vols[0])


# ---- the workflow over an HDF5 recording -----------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The small scene as a TIFF recording and as its HDF5 twin."""
    root = tmp_path_factory.mktemp("h5scene")
    vols, _, lab = recording(N_VOLS, seed=1)
    pattern = write_recording(root, vols, lab)
    return root, pattern, h5_recording(root / "rec.h5", vols), vols, lab


@pytest.fixture(scope="module")
def models():
    jm, tm = stardist_pair()
    jffn, tffn = ffn_pair()
    return jm, tm, jffn, tffn


def _two_steps(rec, model, ffn, root, lab):
    """``predict_and_save`` then single-mode ``track_timelapse`` (with the
    recording, for the merged-label PNGs) into ``root``."""
    predict_and_save(rec, model, root)
    return track_timelapse(root, manual_vol1(root, lab), ffn, VOXEL_SIZE,
                           INTERP, (1, N_VOLS), grid=GRID,
                           images_path=rec, verbose=False, device="cpu")


def _same_bytes(a: Path, b: Path):
    names = files(a)
    assert names == files(b)
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.fixture(scope="module")
def runs(scene, models):
    root, pattern, rec, _, lab = scene
    jm, tm, jffn, tffn = models
    h5 = _two_steps(rec, tm, tffn, root / "h5", lab)
    tif = _two_steps(pattern, tm, tffn, root / "tif", lab)
    j_predict_and_save(rec, jm, root / "jax")
    jax = j_track_timelapse(root / "jax", manual_vol1(root / "jax", lab),
                            jffn, VOXEL_SIZE, INTERP, (1, N_VOLS), grid=GRID,
                            config=JTrackingConfig(), images_path=rec,
                            verbose=False)
    return root, h5, tif, {t: np.asarray(c) for t, c in jax.items()}


def test_hdf5_tree_equals_its_tiff_twin(runs):
    """``seg/``, ``auto_vol1/`` and ``track_results/`` (coordinates,
    labels, merged-label PNGs) of the HDF5 recording equal its TIFF
    twin's byte for byte, and so do the returned coordinates."""
    root, h5, tif, _ = runs
    assert sorted(h5) == sorted(tif) == list(range(1, N_VOLS + 1))
    for t in h5:
        np.testing.assert_array_equal(h5[t], tif[t])
    assert any(n.startswith("track_results/merged_labels/")
               for n in files(root / "h5"))
    _same_bytes(root / "h5", root / "tif")


def test_hdf5_run_matches_jax(runs):
    """The port's two steps over the HDF5 recording against JAX's over
    the same file: the same files, seg coordinates exact, prob maps within
    1e-3, tracked coordinates within 1e-2 (one cell a volume may land one
    rounding step apart), labels 99.5%."""
    from t3dct_torch.io.artifacts import ResultsTree
    root, got, _, want = runs
    assert files(root / "h5") == files(root / "jax")
    pt, jt = ResultsTree(root / "h5"), ResultsTree(root / "jax")
    for t in range(1, N_VOLS + 1):
        np.testing.assert_array_equal(pt.load_seg_coords(t),
                                      jt.load_seg_coords(t))
        np.testing.assert_allclose(pt.load_seg_prob(t), jt.load_seg_prob(t),
                                   atol=PROB_ATOL)
        off = np.abs(got[t] - want[t]).max(axis=1)
        assert (off > COORD_ATOL).sum() <= 1 and off.max() < 1.5, (t, off)
        pat = "track_results/labels/track_results_t%06i_z*.tif" % t
        gl, wl = (np.stack([imageio.imread(p) for p in sorted(r.glob(pat))])
                  for r in (root / "h5", root / "jax"))
        assert (gl == wl).mean() >= LABELS_EQUAL, t


@pytest.mark.parametrize("handoff", ["device", "disk"])
def test_segment_and_track_over_hdf5(scene, models, runs, tmp_path,
                                     handoff):
    """``segment_and_track`` takes the HDF5 recording with either handoff
    and writes the tree of the two-step run over it, byte for byte."""
    root, _, rec, _, lab = scene
    _, tm, _, tffn = models
    got = segment_and_track(rec, tm, tmp_path, manual_vol1(tmp_path, lab),
                            tffn, VOXEL_SIZE, INTERP, (1, N_VOLS),
                            TrackingConfig(), verbose=False, handoff=handoff,
                            device="cpu")
    _, h5, _, _ = runs
    for t in h5:
        np.testing.assert_array_equal(got[t], h5[t])
    _same_bytes(tmp_path, root / "h5")


def test_track_stardist_h5_script(scene, models, runs, tmp_path):
    """``scripts/track_stardist_h5.py`` end to end on the CPU: the
    segmentation step, then (with the proofed labels in ``manual_vol1/``)
    ``--skip-segmentation``, which tracks the recording and writes the
    coordinates CSV; its tree is the two-step run's, byte for byte."""
    from t3dct_torch.scripts import track_stardist_h5 as script
    from t3dct_torch.utils.checkpoint import save_pytree
    root, _, rec, _, lab = scene
    _, tm, _, tffn = models
    tm.save(tmp_path / "models" / "sd")
    save_pytree(tffn, tmp_path / "ffn.npz")
    results = tmp_path / "results"
    argv = ["--h5", rec["h5_file"], "--channel", "0", "--results",
            str(results), "--stardist-model", "sd", "--stardist-basedir",
            str(tmp_path / "models"), "--ffn-weights",
            str(tmp_path / "ffn.npz"), "--voxel-size", *map(str, VOXEL_SIZE),
            "--interpolation-factor", str(INTERP), "--beta", "3.0",
            "--lambda", "3.0", "--device", "cpu"]
    assert script.main(argv) is None
    assert len(list((results / "seg").glob("coords*.npy"))) == N_VOLS
    manual_vol1(results, lab)
    coords = script.main(argv + ["--skip-segmentation"])
    assert sorted(coords) == list(range(1, N_VOLS + 1))
    assert list(results.rglob("*.csv"))
    _, h5, _, _ = runs
    for t in h5:
        np.testing.assert_array_equal(coords[t], h5[t])
