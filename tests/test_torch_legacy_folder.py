"""The port's folder ``Tracker`` (the legacy v0.4 workflow of
``examples/use_unet_legacy.py``) against JAX's, on the CPU.

The scene is ``tests/test_legacy_tracker.py``'s: 4 gaussian cells drifting
over (x, y, z) = (48, 48, 8) volumes, written as ``raw_t%03i_z%03i.tif``
slices into two identical folders with the vol-1 labels as
``manual_vol1/`` and the FFN (``feature_distance_ffn``, saved by JAX's
``save_pytree``) under ``models/``.  The U-Net is a small variant-a spec
with the port's seeded weights and ``with_intensity_path``, handed to both
packages as the same numbers (``load_unet_arrays``); both segmenters are
built in float32 (``Float32Tracker`` and ``PortFloat32Tracker``; both
packages default to bfloat16, whose parity tests/test_torch_bf16.py
holds).  Each run goes through the example's flow:
``load_ffn``, ``segment_vol1``, ``load_manual_seg``, ``interpolate_seg``,
``cal_subregions``, ``initiate_tracking``, ``track(2)``,
``save_coordinates``.

Tolerances: ``auto_vol1/`` and every ``track_results_*`` label slice
exactly; the tracked coordinates (and the CSV's numbers) within
``COORD_TOL`` = 1e-3 real units (the f32 EM's noise after the correction
loop snaps cells to probability-weighted centres,
``tests/test_torch_legacy.py``); the CSV's header and (t, cell) columns
exactly."""

import functools
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.engine import legacy as jlegacy
from t3dct.engine.segmentation import UNetSegmenter as JSegmenter
from t3dct.models.unet3d import UNet3D as JUNet3D
from t3dct.models.unet3d import unet3_a as junet3_a
from t3dct.ops.subregions import build_subregion_atlas as jatlas
from t3dct.ops.subregions import move_cells_sampled as jmove
from t3dct.utils.checkpoint import save_pytree as jsave
from t3dct_torch.config import SegmentationConfig
from t3dct_torch.engine import legacy
from t3dct_torch.engine.segmentation import UNetSegmenter
from t3dct_torch.io.imageio import imread_stack, load_image, \
    save_label_slices
from t3dct_torch.models.ffn import feature_distance_ffn
from t3dct_torch.models.unet3d import UNet3D, get_unet, with_intensity_path
from t3dct_torch.ops import hopper_cc, hopper_conv, hopper_flood
from t3dct_torch.ops.subregions import SubregionAtlas, move_cells_sampled

from test_torch_legacy import (MAX_CELLS, SEG, SHAPE, TRACK, UNET,  # noqa
                               Z_SCALING, Z_XY_RATIO, to_jax, volume_at)

COORD_TOL = 1e-3
# the point sets' pad: 4 cells, and the scene's few spurious regions
FOLDER_MAX_CELLS = 16
IMAGE_NAME = "raw_t%03i_z%03i.tif"


class Float32Tracker(jlegacy.Tracker):
    """JAX's ``Tracker`` with its segmenter built in float32 (the port's
    precision; JAX's default is bfloat16, ``engine/segmentation.py:48``)."""

    def _build_segmenter(self):
        self.segmenter = self._f32_segmenter()

    def _f32_segmenter(self):
        from t3dct.config import SegmentationConfig as JSegConfig
        cfg = JSegConfig(
            noise_level=self.noise_level, min_size=self.min_size,
            cell_num=self.cell_num, z_xy_ratio=self.z_xy_ratio,
            z_scaling=self.z_scaling, shrink=self.shrink)
        return JSegmenter(
            self.unet_model, self.unet_params, self.unet_bn_state, cfg,
            (self.x_siz, self.y_siz, self.z_siz), max_cells=self.max_cells,
            compute_dtype=jnp.float32)


class PortFloat32Tracker(legacy.Tracker):
    """The port's ``Tracker`` with its segmenter built in float32, as
    ``Float32Tracker`` builds JAX's."""

    def _build_segmenter(self):
        self.segmenter = self._new_segmenter(torch.float32)


class SharedSegmenterTracker(Float32Tracker):
    """``Float32Tracker`` whose trackers share one segmenter (and its
    compiled programs) for equal weights and settings.  The runs below
    segment one scene, so the values a segmenter learns at vol 1 are the
    ones each fresh segmenter would learn."""
    _segmenters = {}

    def _build_segmenter(self):
        key = (id(self.unet_params), self.noise_level, self.min_size,
               self.cell_num, self.shrink, self.max_cells)
        if key not in self._segmenters:
            self._segmenters[key] = self._f32_segmenter()
        self.segmenter = self._segmenters[key]


def small_unet():
    """(port spec, params, state), (JAX spec, params, state): one set of
    numbers."""
    spec = UNet3D(**UNET)
    params, state = spec.init(torch.Generator().manual_seed(0), device="cpu")
    params = with_intensity_path(params, spec)
    return (spec, params, state), (JUNet3D(**UNET), to_jax(params),
                                   to_jax(state))


def write_folder(folder: Path, n_vols: int) -> Path:
    """The scene's raw slices, the vol-1 labels in ``manual_vol1/`` and
    the FFN in ``models/ffn.npz``."""
    for t in range(1, n_vols + 1):
        img, _, _ = volume_at(t)
        save_label_slices(img.astype(np.uint16), folder / "data", IMAGE_NAME,
                          t, use_8_bit=False, compression=None)
    save_label_slices(volume_at(1)[1], folder / "manual_vol1",
                      "manual_z%03i_x%03i.tif", 0, use_8_bit=True,
                      compression=None)
    params, state = feature_distance_ffn(torch.Generator().manual_seed(1),
                                         "cpu")
    (folder / "models").mkdir(parents=True, exist_ok=True)
    jsave((to_jax(params), to_jax(state)), folder / "models" / "ffn.npz")
    return folder


def tracker_kwargs(n_vols, folder, **kw):
    return dict(volume_num=n_vols, siz_xyz=SHAPE, z_xy_ratio=Z_XY_RATIO,
                z_scaling=Z_SCALING, noise_level=SEG["noise_level"],
                min_size=SEG["min_size"], beta_tk=TRACK["beta"],
                lambda_tk=TRACK["lambda_"], maxiter_tk=TRACK["max_iteration"],
                folder_path=str(folder), image_name=IMAGE_NAME,
                unet_model_file="unet.npz", ffn_model_file="ffn.npz",
                shrink=SEG["shrink"], max_cells=FOLDER_MAX_CELLS, **kw)


def run_example(tracker, unet):
    """``examples/use_unet_legacy.py``'s flow, the U-Net given."""
    tracker.load_unet_arrays(*unet)
    tracker.load_ffn()
    tracker.segment_vol1()
    tracker.load_manual_seg()
    tracker.interpolate_seg()
    tracker.cal_subregions()
    tracker.initiate_tracking()
    tracker.track(from_volume=2)
    tracker.save_coordinates()
    return tracker


MODES = {
    "single": (3, {}),
    "ensemble": (3, dict(ensemble=3)),
    "adjacent": (5, dict(ensemble=2, adjacent=True)),
    "miss_frame": (4, dict(miss_frame=[3])),
    "reference_paste": (3, dict(paste_mode="reference")),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mode through both packages, in two copies of one folder."""
    tm, jm = small_unet()
    out = {}
    for name, (n_vols, kw) in MODES.items():
        root = tmp_path_factory.mktemp(name)
        write_folder(root / "jax", n_vols)
        shutil.copytree(root / "jax", root / "port")
        jt = run_example(SharedSegmenterTracker(**tracker_kwargs(
            n_vols, root / "jax", **kw)), jm)
        pt = run_example(PortFloat32Tracker(**tracker_kwargs(
            n_vols, root / "port", **kw), device="cpu"), tm)
        out[name] = (jt, pt, root)
    return out


def label_files(folder: Path):
    return sorted(p.relative_to(folder) for p in folder.rglob("*.tif")
                  if p.parts[len(folder.parts)] != "data")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_folder_tracker_coordinates(runs, mode):
    jt, pt, _ = runs[mode]
    want = jt.history.r_tracked_coordinates
    got = pt.history.r_tracked_coordinates
    assert len(got) == len(want) == MODES[mode][0]
    for t, (g, w) in enumerate(zip(got, want), start=1):
        assert g.dtype == np.float64 and g.shape == w.shape == (4, 3)
        np.testing.assert_allclose(g, w, rtol=0, atol=COORD_TOL,
                                   err_msg=f"t={t}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_folder_tracker_writes_jax_files(runs, mode):
    """The same label files under the same names, equal voxel for voxel
    (``auto_vol1/``, ``track_results_*/``), and the same CSV."""
    _, _, root = runs[mode]
    names = label_files(root / "jax")
    assert names == label_files(root / "port")
    assert any(str(n).startswith("auto_vol1") for n in names)
    assert sum("track_results_" in str(n) for n in names) == \
        MODES[mode][0] * SHAPE[2]
    for n in names:
        want = imread_stack([root / "jax" / n])
        got = imread_stack([root / "port" / n])
        assert got.dtype == want.dtype, n
        np.testing.assert_array_equal(got, want, err_msg=str(n))
    csv = Path("track_information") / "tracked_coordinates.csv"
    head = [(root / d / csv).read_text().splitlines()[0]
            for d in ("jax", "port")]
    assert head[0] == head[1] == "cell,t,x(row),y(column),z(interpolated)"
    want = np.loadtxt(root / "jax" / csv, delimiter=",", skiprows=1)
    got = np.loadtxt(root / "port" / csv, delimiter=",", skiprows=1)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0,
                               atol=COORD_TOL)


def test_folder_tracker_modes(runs):
    """What each mode is for happened on both sides: the ensemble resets
    its boundary flags every volume and writes to its own folder; the miss
    frame repeats the last labels and displacement."""
    for mode in ("ensemble", "adjacent"):
        jt, pt, _ = runs[mode]
        assert pt.cells_on_boundary.sum() == jt.cells_on_boundary.sum() == 0
        assert pt.paths.track_results == jt.paths.track_results.replace(
            "/jax/", "/port/")
    assert "EnsembleAdjctMode" in runs["adjacent"][1].paths.track_results
    assert "EnsembleDstrbtMode" in runs["ensemble"][1].paths.track_results
    jt, pt, root = runs["miss_frame"]
    np.testing.assert_array_equal(pt.history.r_displacements[2],
                                  pt.history.r_displacements[1])
    res = Path(pt.paths.track_results)
    for z in range(1, SHAPE[2] + 1):
        np.testing.assert_array_equal(
            imread_stack([res / ("track_results_t000003_z%04i.tif" % z)]),
            imread_stack([res / ("track_results_t000002_z%04i.tif" % z)]))


def test_array_entry_still_writes_nothing(tmp_path, monkeypatch):
    """``legacy_segment_and_track_arrays`` runs on a tracker with no
    folder: nothing appears in the working directory."""
    monkeypatch.chdir(tmp_path)
    tm, _ = small_unet()
    ffn = feature_distance_ffn(torch.Generator().manual_seed(1), "cpu")
    vols = [volume_at(t)[0] for t in (1, 2)]
    from t3dct_torch.config import TrackingConfig
    res = legacy.legacy_segment_and_track_arrays(
        vols, tm, ffn, volume_at(1)[1], SegmentationConfig(**SEG),
        TrackingConfig(**TRACK), max_cells=MAX_CELLS, device="cpu")
    assert res.coords[2].shape == (4, 3)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("ensemble,adjacent", [
    (False, False), (3, False), (3, True), (5, False), (5, True),
    (20, False), (20, True)])
def test_reference_and_remote_vols(ensemble, adjacent):
    for vol in range(2, 60):
        assert legacy.get_reference_vols(ensemble, vol, adjacent) == \
            jlegacy.get_reference_vols(ensemble, vol, adjacent)
        if ensemble and vol - 1 >= ensemble:
            assert legacy.get_remote_vols(ensemble, vol) == \
                jlegacy.get_remote_vols(ensemble, vol)
    assert legacy.get_tracking_path(adjacent, ensemble, "f") == \
        jlegacy.get_tracking_path(adjacent, ensemble, "f")


def test_paths_make_jax_folders(tmp_path):
    legacy.Paths(str(tmp_path / "p"), IMAGE_NAME, "u.npz",
                 "f.npz").make_folders(True, 5)
    jlegacy.Paths(str(tmp_path / "j"), IMAGE_NAME, "u.npz",
                  "f.npz").make_folders(True, 5)
    names = [sorted(str(p.relative_to(tmp_path / d))
                    for p in (tmp_path / d).rglob("*")) for d in "pj"]
    assert names[0] == names[1] and len(names[0]) == 9


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_unet_cache_loads_in_the_other_package(tmp_path, writer):
    """The float16 ``unet_cache`` file one package writes, the other reads
    back as the same float32 probabilities; the writer returns its
    unrounded ones."""
    tm, jm = small_unet()
    cfg = SegmentationConfig(**SEG)
    from t3dct.config import SegmentationConfig as JSegConfig
    jseg = JSegmenter(*jm, JSegConfig(**SEG), SHAPE, max_cells=MAX_CELLS,
                      compute_dtype=jnp.float32)
    tseg = UNetSegmenter(*tm, cfg, SHAPE, max_cells=MAX_CELLS,
                         compute_dtype=torch.float32, device="cpu")
    raw = volume_at(2)[0]
    cache = tmp_path / "t000002.npy"
    if writer == "jax":
        first = np.asarray(jseg.predict_cellregions(raw, cache))
        again = tseg.predict_cellregions(raw, cache).numpy()
    else:
        first = tseg.predict_cellregions(raw, cache).numpy()
        again = np.asarray(jseg.predict_cellregions(raw, cache))
    stored = np.load(cache)
    assert stored.dtype == np.float16 and stored.shape == SHAPE
    np.testing.assert_array_equal(stored, first.astype(np.float16))
    assert again.dtype == np.float32
    np.testing.assert_array_equal(again, stored.astype(np.float32))
    # a segmentation through the cache equals JAX's through it
    want = jseg.segment(raw, cache_path=cache)
    got = tseg.segment(raw, cache_path=cache)
    np.testing.assert_array_equal(got.segmentation_auto.numpy(),
                                  want.segmentation_auto)


def test_load_unet_reads_a_jax_checkpoint(tmp_path):
    """``load_unet`` takes the ``(params, bn_state)`` ``.npz`` that JAX's
    ``save_pytree`` wrote (JAX's seeded init of ``unet3_a``): every leaf
    exact, copied to ``unet_weights/weights_initial.npz``; the same
    weights as a Keras ``.h5`` load to the same leaves, and ``load_ffn``
    takes a Keras FFN ``.h5`` (``tests/test_torch_keras.py`` holds both
    against JAX's loaders); the figures raise and cite A.9."""
    from t3dct_torch.utils.keras_import import _unet_block_specs
    from test_torch_keras import ffn_layers, write_keras2_h5
    params, state = junet3_a().init(jax.random.PRNGKey(3))
    state = jax.tree_util.tree_map(lambda a: a + 0.25, state)
    tr = legacy.Tracker(**tracker_kwargs(2, tmp_path), device="cpu")
    jsave((params, state), Path(tr.paths.models) / "unet.npz")
    tr.load_unet()
    assert tr.unet_model == get_unet("a")
    for got, want in zip(jax.tree_util.tree_leaves(
            (tr.unet_params, tr.unet_bn_state)),
            jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (Path(tr.paths.unet_weights) / "weights_initial.npz").is_file()
    layers = []
    for i, (name, _, _) in enumerate(_unet_block_specs(get_unet("a"))):
        conv = params[name]["conv"]
        layers.append((f"conv3d_{i}", [
            (f"conv3d_{i}/kernel:0", np.asarray(conv["w"])),
            (f"conv3d_{i}/bias:0", np.asarray(conv["b"]))]))
        if name != "out":
            bn, st = params[name]["bn"], state[name]
            layers.append((f"bn_{i}", [
                (f"bn_{i}/{k}:0", np.asarray(v)) for k, v in (
                    ("gamma", bn["scale"]), ("beta", bn["bias"]),
                    ("moving_mean", st["mean"]),
                    ("moving_variance", st["var"]))]))
    write_keras2_h5(Path(tr.paths.models) / "w.h5", layers)
    write_keras2_h5(Path(tr.paths.models) / "f.h5", ffn_layers(seed=6))
    tr.paths.unet_model_file, tr.paths.ffn_model_file = "w.h5", "f.h5"
    tr.load_unet()
    assert tr.unet_model == get_unet("a")
    for got, want in zip(jax.tree_util.tree_leaves(
            (tr.unet_params, tr.unet_bn_state)),
            jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tr.load_ffn()
    assert tr.ffn_params["comb"]["w"].shape == (1024, 512)
    with pytest.raises(NotImplementedError, match="A.9"):
        tr.draw_segresult()


def test_remove_2d_boundary_matches(tmp_path):
    lab = np.zeros((12, 12, 3), np.int32)
    lab[2:6, 2:6, :] = 1
    lab[2:6, 6:10, :2] = 2
    lab[6:9, 3:8, 1:] = 3
    jt = jlegacy.Tracker(1, (12, 12, 3), 1, 1, 1, 1, 1, 1, 2, str(tmp_path /
                         "j"), "r%i_%i.tif", "u.npz", "f.npz")
    pt = legacy.Tracker(1, (12, 12, 3), 1, 1, 1, 1, 1, 1, 2, str(tmp_path /
                        "p"), "r%i_%i.tif", "u.npz", "f.npz", device="cpu")
    np.testing.assert_array_equal(pt._remove_2d_boundary(lab),
                                  jt._remove_2d_boundary(lab))


@pytest.mark.parametrize("moves", [0, 1, 2])
def test_reference_paste_matches(moves):
    """``move_cells_sampled(overlap_mode="last", out_of_range="drop")``:
    id-order last write wins, cells leaving the canvas dropped, exactly
    JAX's on JAX's atlas (the blurs behind the two atlases sum in another
    order, ``ROADMAP.md`` C.5); and the default scatter unchanged."""
    _, lab, _ = volume_at(1)
    lab = lab.copy()
    lab[20:26, 20:26, 2:6] = 5          # a fifth cell touching others
    jat = jatlas(jnp.asarray(lab), n_cells=5, box_shape=(12, 12, 6),
                 interpolation_factor=Z_SCALING)
    atlas = SubregionAtlas(*(torch.from_numpy(np.asarray(a)) for a in (
        jat.boxes, jat.origins, jat.valid)), jat.interpolation_factor,
        jat.image_shape)
    rng = np.random.RandomState(moves)
    mv = rng.randint(-12, 12, (5, 3)).astype(np.int32) * moves
    mv[0] = [-40, 3, 0] if moves else 0          # off the canvas
    for kw in (dict(overlap_mode="last", out_of_range="drop"), {},
               dict(overlap_mode="last"), dict(out_of_range="drop")):
        got = move_cells_sampled(atlas, torch.from_numpy(mv), **kw)
        want = jmove(jat, jnp.asarray(mv), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_load_image_is_jax_frame(tmp_path):
    _, lab, _ = volume_at(2)
    save_label_slices(lab, tmp_path, "m_z%03i_x%03i.tif", 0, use_8_bit=True,
                      compression=None)
    from t3dct.io.imageio import load_image as jload
    np.testing.assert_array_equal(load_image(str(tmp_path)), jload(
        str(tmp_path)))
    assert load_image(str(tmp_path)).shape == SHAPE


def test_cpu_folder_run_launches_no_kernel(runs):
    counters = hopper_conv.KERNELS + (hopper_flood.flood_slices,
                                      hopper_cc.cc_label)
    assert [c.launches for c in counters] == [0] * len(counters)


def test_segment_vol1_learns_and_saves(runs):
    """``segment_vol1`` learned ``min_size`` / ``cell_num`` as JAX's did,
    and chose the label width JAX chose."""
    jt, pt, _ = runs["single"]
    assert (pt.min_size, pt.cell_num, pt.use_8_bit) == \
        (jt.min_size, jt.cell_num, jt.use_8_bit)
    assert os.path.isfile(os.path.join(pt.paths.unet_cache, "t000003.npy"))


def test_use_unet_legacy_script_two_phases(tmp_path, monkeypatch):
    """``scripts/use_unet_legacy.py`` with the example's flags on the CPU
    (``load_unet`` given the small spec, with a tile that fits the default
    shrink, in place of ``unet3_a``, and the pad of 16 cells the other
    tests use): the first
    run writes ``auto_vol1/`` and stops for proofreading; the second
    (``--skip-segmentation``) tracks every volume and writes the labels and
    the CSV of its coordinates."""
    from t3dct_torch.scripts import use_unet_legacy
    from t3dct_torch.utils.checkpoint import save_pytree
    import dataclasses
    (spec, params, state), _ = small_unet()
    spec = dataclasses.replace(spec, tile_shape=(64, 64, 8))
    monkeypatch.setattr(legacy, "get_unet", lambda variant: spec)
    monkeypatch.setattr(use_unet_legacy, "Tracker", functools.partial(
        legacy.Tracker, max_cells=FOLDER_MAX_CELLS))
    folder = write_folder(tmp_path / "f", 3)
    save_pytree((params, state), folder / "models" / "unet.npz")
    argv = ["--folder", str(folder), "--image-name", IMAGE_NAME,
            "--volume-num", "3", "--siz-xyz", *map(str, SHAPE),
            "--z-xy-ratio", str(Z_XY_RATIO), "--z-scaling", str(Z_SCALING),
            "--noise-level", str(SEG["noise_level"]),
            "--min-size", str(SEG["min_size"]), "--beta", str(TRACK["beta"]),
            "--lambda", str(TRACK["lambda_"]),
            "--maxiter", str(TRACK["max_iteration"]),
            "--unet-model", "unet.npz", "--ffn-model", "ffn.npz",
            "--device", "cpu"]
    first = use_unet_legacy.main(argv)
    assert len(list((folder / "auto_vol1").glob("*.tif"))) == SHAPE[2]
    assert not (folder / "track_information" /
                "tracked_coordinates.csv").exists()
    assert first.history.r_tracked_coordinates == []
    second = use_unet_legacy.main(argv + ["--skip-segmentation"])
    csv = np.loadtxt(folder / "track_information" / "tracked_coordinates.csv",
                     delimiter=",", skiprows=1)
    assert csv.shape == (3 * 4, 5)
    coords = second.history.r_tracked_coordinates
    assert len(coords) == 3 and all(np.isfinite(c).all() for c in coords)
    np.testing.assert_array_equal(csv[:, 2:].reshape(3, 4, 3),
                                  np.asarray(coords))


def test_host_building_blocks_match(runs):
    """The host-loop blocks of the legacy fit (``_initial_matching``,
    ``_fit_ffn_prgls``, ``_predict_one_rep``) on vol 2 from vol 1, against
    JAX's: scores to 1e-5, the rep coefficients and moved sets within the
    f32 EM's noise, the replayed prediction within ``COORD_TOL``."""
    jt, pt, _ = runs["single"]
    ref = jt.history.r_segmented_coordinates[0]
    pt.segresult = pt._segment(2)
    jt.segresult = jt._segment(2)
    tgt = jt.segresult.r_coordinates_segment
    np.testing.assert_allclose(
        pt._initial_matching(ref, tgt).numpy(),
        np.asarray(jt._initial_matching(ref, tgt)), rtol=0, atol=1e-5)
    got = pt._fit_ffn_prgls(2, ref)
    want = jt._fit_ffn_prgls(2, ref)
    assert got[1] == want[1]
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-2)
    pred = jt.history.r_tracked_coordinates[0]
    for c, beta in zip(want[0], want[1]):
        np.testing.assert_allclose(
            pt._predict_one_rep(pred, want[2][0], beta, c),
            jt._predict_one_rep(pred, want[2][0], beta, c), rtol=0,
            atol=COORD_TOL)


def test_match_matches(runs):
    """``match(2)``: vol 1's cells moved onto vol 2, the displacements and
    the prediction as JAX's; the port returns no animation (a figure,
    ``ROADMAP.md`` A.9)."""
    import matplotlib
    matplotlib.use("Agg")
    jt, pt, _ = runs["single"]
    anim, (local, t, i_disp, pred) = pt.match(2)
    _, (jlocal, jt_, ji_disp, jpred) = jt.match(2)
    assert anim is None and t == jt_ == 2
    np.testing.assert_array_equal(local, jlocal)
    np.testing.assert_allclose(pred, jpred, rtol=0, atol=1e-2)
    np.testing.assert_array_equal(i_disp, ji_disp)
    with pytest.raises(ValueError, match="miss_frame"):
        runs["miss_frame"][1].match(3)


def test_precompute_segmentation_fills_jax_cache(runs):
    """``precompute_segmentation`` over every volume from an emptied
    cache: one float16 file per volume, within a float16 step of the
    probabilities JAX cached in its own run."""
    jt, pt, _ = runs["single"]
    pt.set_segmentation(del_cache=True)
    assert os.listdir(pt.paths.unet_cache) == []
    pt.precompute_segmentation()
    names = sorted(os.listdir(pt.paths.unet_cache))
    assert names == sorted(os.listdir(jt.paths.unet_cache)) == \
        ["t%06i.npy" % t for t in (1, 2, 3)]
    for n in names:
        got = np.load(os.path.join(pt.paths.unet_cache, n))
        want = np.load(os.path.join(jt.paths.unet_cache, n))
        assert got.dtype == want.dtype == np.float16
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=1e-3,
                                   atol=1e-4)
