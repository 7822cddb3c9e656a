"""The workflow's readouts and host I/O against the JAX package, on the CPU:
activities (``topq_mean_intensity``, ``mean_excluding_bottom``,
``get_activities``, ``TrackerLite.activities``), the two CSV exports,
``TrackerLite.match_by_ffn``, ``read_image_ts``, and the transformer's
``get_cells_on_boundary``, ``load_prob_map`` and ``accurate_correction``.

Bounds: per-cell activities within 1e-5 relative (float32 sums in another
order; the selected voxels are the same); NaN where JAX gives NaN; label
counts, pairs, boundary flags and upsampled maps exact; the CSVs byte for
byte; corrected centres to 1e-3 real units and labels exactly on JAX's
atlas (``test_torch_tracking.py``'s bounds for the correction loop)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import t3dct_torch  # noqa: F401
from t3dct.coordinates import Coordinates as JCoordinates
from t3dct.engine.analyses import get_activities as j_get_activities
from t3dct.engine.analyses import mean_excluding_bottom as j_excl
from t3dct.engine.tracker import TrackerLite as JTrackerLite
from t3dct.engine.transformer import CoordsToImageTransformer as JTransformer
from t3dct.io.artifacts import ResultsTree as JResultsTree
from t3dct.io.imageio import read_image_ts as j_read_image_ts
from t3dct.ops.segment_reduce import label_counts as j_label_counts
from t3dct.ops.segment_reduce import topq_mean_intensity as j_topq
from t3dct_torch.coordinates import Coordinates
from t3dct_torch.engine.analyses import (get_activities,
                                         get_activities_quick,
                                         mean_excluding_bottom)
from t3dct_torch.engine.tracker import TrackerLite
from t3dct_torch.engine.transformer import CoordsToImageTransformer
from t3dct_torch.io import imageio
from t3dct_torch.io.artifacts import ResultsTree
from t3dct_torch.ops.segment_reduce import label_counts, topq_mean_intensity
from test_torch_scene import (INTERP, SHAPE, VOXEL_SIZE, ffn_pair,
                              recording, torch_threads)
from test_torch_tracking import _atlas_to_torch, _seg_candidates
from test_torch_viz import drawn, pixels

ACT_RTOL = 1e-5


def _cells(seed, n_labels=9, shape=(12, 10, 6)):
    """Raw intensities with ties and labels with tiny cells (1-5 voxels),
    an absent label and a constant cell."""
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 40, shape).astype(np.float32) + \
        rng.rand(*shape).astype(np.float32) * (seed % 2)
    lab = rng.randint(0, n_labels + 1, shape).astype(np.int32)
    lab[lab == 4] = 0                               # label 4 absent
    flat = lab.reshape(-1)
    for k, size in zip((5, 6, 7), (1, 2, 5)):       # tiny cells
        flat[flat == k] = 0
        flat[rng.choice(flat.size, size, replace=False)] = k
    raw[lab == 3] = 17.0                            # a constant cell
    return raw, lab


def _same_activity(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=ACT_RTOL, equal_nan=True)


@pytest.mark.parametrize("ratio", [0.1, 0.25, 0.5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topq_mean_intensity_matches_jax(seed, ratio):
    raw, lab = _cells(seed)
    want = np.asarray(j_topq(jnp.asarray(raw), jnp.asarray(lab), 10,
                             discard_ratio=ratio))
    got = topq_mean_intensity(torch.from_numpy(raw), torch.from_numpy(lab),
                              10, discard_ratio=ratio).numpy()
    _same_activity(got, want)
    assert np.isnan(got[3])                         # label 4 is absent


@pytest.mark.parametrize("ratio", [0.1, 0.3])
@pytest.mark.parametrize("seed", [3, 4])
def test_mean_excluding_bottom_matches_jax(seed, ratio):
    raw, lab = _cells(seed)
    want = np.asarray(j_excl(jnp.asarray(raw), jnp.asarray(lab), 10,
                             discard_ratio=ratio))
    got = mean_excluding_bottom(torch.from_numpy(raw), torch.from_numpy(lab),
                                10, discard_ratio=ratio).numpy()
    _same_activity(got, want)


def test_label_counts_matches_jax():
    _, lab = _cells(5)
    for n in (3, 9, 14):
        want = np.asarray(j_label_counts(jnp.asarray(np.minimum(lab, n)),
                                         n))
        got = label_counts(torch.from_numpy(np.minimum(lab, n)), n).numpy()
        np.testing.assert_array_equal(got, want)


def _write_ts(root, name, vol_xyz, t):
    imageio.save_label_slices(vol_xyz, root, name + "_t%04i_z%04i.tif", t,
                              use_8_bit=False, compression=None)
    return str(root / (name + "_t%04i_z%04i.tif"))


def test_read_image_ts_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    vol = rng.randint(0, 900, (10, 7, 5)).astype(np.uint16)
    pattern = _write_ts(tmp_path, "raw", vol, 3)
    got = imageio.read_image_ts(3, pattern, (1, 6))
    want = j_read_image_ts(3, pattern, (1, 6))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(imageio.read_image_ts(3, pattern, (2, 4)),
                                  vol[:, :, 1:3])


def test_get_activities_matches_jax(tmp_path):
    """Three volumes of per-(t, z) raw and label slices; a cell absent from
    a later volume reads 0.0 in both."""
    vols, _, lab = recording(3, seed=4)
    for t, v in enumerate(vols, start=1):
        raw_pattern = _write_ts(tmp_path, "raw", v.transpose(1, 2, 0), t)
        tl = np.roll(lab, t - 1, axis=0).astype(np.uint16)
        if t == 3:
            tl[tl == 5] = 0
        lab_pattern = _write_ts(tmp_path, "lab", tl, t)
    want = j_get_activities(raw_pattern, lab_pattern, 3, SHAPE[0])
    got = get_activities(raw_pattern, lab_pattern, 3, SHAPE[0],
                         device="cpu")
    assert get_activities_quick is get_activities
    assert got.shape == want.shape == (3, 12) and got.dtype == np.float64
    assert got[2, 4] == want[2, 4] == 0.0
    np.testing.assert_allclose(got, want, rtol=ACT_RTOL)


@pytest.fixture(scope="module")
def tracked_tree(tmp_path_factory):
    """A results tree holding three volumes' tracked labels (the vol-1
    labels moved along), seg coordinates, and the raw recording; the JAX
    and the port's trackers over it."""
    root = tmp_path_factory.mktemp("tracked")
    vols, centers, lab = recording(3, seed=3)
    for t, v in enumerate(vols, start=1):
        imageio.save_label_slices(v.transpose(1, 2, 0), root / "raw",
                                  "raw_t%03i_z%04i.tif", t, use_8_bit=False,
                                  compression=None)
    tree = ResultsTree(root)
    for t in (1, 2, 3):
        tree.save_tracked_labels(np.roll(lab, t - 1, axis=0), t, True)
        pts, kept, _ = _seg_candidates(centers[t], seed=t)
        tree.save_seg_coords(t, pts[kept][:, [1, 2, 0]])
    vol1 = (centers[1][:, [1, 2, 0]]).astype(np.float32)
    (jp, js), (tp, ts) = ffn_pair()
    jt = JTrackerLite(root, (jp, js),
                      JCoordinates.from_raw(vol1, INTERP, VOXEL_SIZE))
    tt = TrackerLite(root, (tp, ts), Coordinates.from_raw(
        vol1, INTERP, VOXEL_SIZE, device="cpu"))
    return root, jt, tt


@pytest.mark.parametrize("ratio", [0.1, 0.3])
def test_tracker_activities_match_jax(tracked_tree, ratio):
    """``TrackerLite.activities`` on equal labels: JAX's readout."""
    root, jt, tt = tracked_tree
    pattern = str(root / "raw" / "raw_t%03i_z*.tif")
    want = jt.activities(pattern, discard_ratio=ratio)
    got = tt.activities(pattern, discard_ratio=ratio)
    assert got.shape == want.shape == (3, 12) and got.dtype == np.float64
    _same_activity(got, want)


def test_tracker_activities_missing_labels(tracked_tree, tmp_path):
    """A volume without labels reads NaN; a missing raw volume ends the
    readout; as in JAX."""
    root, jt, tt = tracked_tree
    import shutil
    shutil.copytree(root, tmp_path / "t")
    for p in (tmp_path / "t/track_results/labels").glob("*t000002*"):
        p.unlink()
    for p in (tmp_path / "t/raw").glob("raw_t003*"):
        p.unlink()
    pattern = str(tmp_path / "t" / "raw" / "raw_t%03i_z*.tif")
    (jp, js), (tp, ts) = ffn_pair()
    jt2 = JTrackerLite(tmp_path / "t", (jp, js), jt.proofed_coords_vol1)
    tt2 = TrackerLite(tmp_path / "t", (tp, ts), tt.proofed_coords_vol1)
    want = jt2.activities(pattern)
    got = tt2.activities(pattern)
    assert np.isnan(got[1]).all() and (got[2] == 0).all()
    _same_activity(got, want)


def _figure_points(fig):
    """The scatters' offsets and the connection lines' ends of a matching
    figure."""
    from matplotlib.patches import ConnectionPatch
    ax1, ax2 = fig.axes
    lines = [np.r_[p.xy1, p.xy2] for p in ax2.get_children()
             if isinstance(p, ConnectionPatch)]
    return (ax1.collections[0].get_offsets(),
            ax2.collections[0].get_offsets(), np.asarray(lines))


def test_match_by_ffn_matches_jax(tracked_tree, capsys):
    """The (ref, tgt) pairs of the FFN's initial matching, exactly: from
    the seg cells of t1, and from given confirmed coordinates.  Each call
    draws JAX's matching figure, pixel for pixel, and leaves it open as
    JAX's does; nothing is skipped."""
    _, jt, tt = tracked_tree
    want, wfig = drawn(lambda: jt.match_by_ffn(1, 2))
    got, gfig = drawn(lambda: tt.match_by_ffn(1, 2))
    assert got.ndim == 2 and got.shape[1] == 2 and len(got) >= 8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pixels(gfig), pixels(wfig))
    conf = np.array(jt.proofed_coords_vol1.raw_f32)
    want, wfig = drawn(lambda: jt.match_by_ffn(
        2, 3, JCoordinates.from_raw(conf, INTERP, VOXEL_SIZE)))
    got, gfig = drawn(lambda: tt.match_by_ffn(
        2, 3, Coordinates.from_raw(conf, INTERP, VOXEL_SIZE, device="cpu")))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pixels(gfig), pixels(wfig))
    assert len(_figure_points(gfig)[2]) == len(got)
    assert "skipped" not in capsys.readouterr().out


def test_predict_cell_positions_matches_jax(tracked_tree):
    """The prediction within 1e-2 real units; ``draw_fig=True`` draws
    JAX's figure of it: the same size, the reference and segmented
    scatters exact, the lines' ends within the prediction's bound."""
    _, jt, tt = tracked_tree
    want = jt.predict_cell_positions(1, 2)
    got = tt.predict_cell_positions(1, 2)
    np.testing.assert_allclose(got.real.numpy(), np.asarray(want.real),
                               atol=1e-2)
    want, wfig = drawn(lambda: jt.predict_cell_positions(1, 2,
                                                          draw_fig=True))
    got, gfig = drawn(lambda: tt.predict_cell_positions(1, 2,
                                                         draw_fig=True))
    np.testing.assert_allclose(got.real.numpy(), np.asarray(want.real),
                               atol=1e-2)
    assert gfig.canvas.get_width_height() == wfig.canvas.get_width_height()
    g, w = _figure_points(gfig), _figure_points(wfig)
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_array_equal(g[1], w[1])
    assert g[2].shape == w[2].shape == (len(got.real), 4)
    np.testing.assert_allclose(g[2], w[2], atol=1e-2)


def test_predict_cell_positions_refine_matches_jax(tracked_tree):
    """``TrackerLite(m_step_refine=8)``: every prediction's EM runs the
    compensated M-step; within 1e-2 real units of JAX's tracker with the
    same option, from the seg cells and from given coordinates."""
    root, jt, tt = tracked_tree
    (jp, js), (tp, ts) = ffn_pair()
    jr = JTrackerLite(root, (jp, js), jt.proofed_coords_vol1,
                      m_step_refine=8)
    tr = TrackerLite(root, (tp, ts), tt.proofed_coords_vol1,
                     m_step_refine=8)
    assert tr.m_step_refine == jr.m_step_refine == 8
    for t1, t2, conf in ((1, 2, None), (2, 3, True)):
        want = jr.predict_cell_positions(
            t1, t2, jt.proofed_coords_vol1 if conf else None)
        with torch_threads(1):
            got = tr.predict_cell_positions(
                t1, t2, tt.proofed_coords_vol1 if conf else None)
        np.testing.assert_allclose(got.real.numpy(), np.asarray(want.real),
                                   atol=1e-2)


def test_coordinates_csv_is_jax_bytes(tmp_path):
    rng = np.random.RandomState(0)
    coords = {t: (rng.rand(5, 3) * 100).astype(np.float32)
              for t in (3, 1, 2)}
    coords[2][1, 0] = np.float32(1e-7)
    got = ResultsTree(tmp_path / "p").root
    got.mkdir()
    want_root = tmp_path / "j"
    want_root.mkdir()
    a = ResultsTree(got).export_coordinates_csv(coords)
    b = JResultsTree(want_root).export_coordinates_csv(coords)
    assert a.name == b.name == "tracked_coordinates.csv"
    assert a.read_bytes() == b.read_bytes()


def test_activities_csv_is_jax_bytes(tracked_tree, tmp_path):
    """The export of a readout with NaN rows, byte for byte."""
    root, _, tt = tracked_tree
    acts = tt.activities(str(root / "raw" / "raw_t%03i_z*.tif"))
    acts[1, 3] = np.nan
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    a = ResultsTree(tmp_path / "p").export_activities_csv(acts, "a.csv")
    b = JResultsTree(tmp_path / "j").export_activities_csv(acts, "a.csv")
    assert a.read_bytes() == b.read_bytes()
    assert a.read_text().splitlines()[0].startswith("t,cell_1,cell_2")


@pytest.fixture(scope="module")
def transformers(tmp_path_factory):
    """The JAX transformer and the port's holding JAX's atlas and vol-1
    centres, over one results tree with a seg prob map at t = 2."""
    root = tmp_path_factory.mktemp("corr")
    _, centers, lab = recording(3, seed=0)
    jt = JTransformer(root, VOXEL_SIZE)
    jt.load_segmentation_array(lab)
    jt.interpolate(INTERP)
    tt = CoordsToImageTransformer(root, VOXEL_SIZE, device="cpu")
    tt.load_segmentation_array(lab)
    tt.atlas = _atlas_to_torch(jt.atlas)
    tt.coord_vol1 = Coordinates.from_raw(np.array(jt.coord_vol1.raw_f32),
                                         INTERP, VOXEL_SIZE, device="cpu")
    tt.interpolation_factor = INTERP
    _, _, prob = _seg_candidates(centers[2])
    jt.tree.save_seg_prob(2, prob.astype(np.float32).transpose(1, 2, 0))
    return jt, tt, prob


def test_load_prob_map_matches_jax(transformers):
    jt, tt, _ = transformers
    got = tt.load_prob_map(2, (1, 2, 2))
    want = jt.load_prob_map(2, (1, 2, 2))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == jt.proofed_segmentation.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ensemble", [False, True])
def test_cells_on_boundary_matches_jax(transformers, ensemble):
    jt, tt, _ = transformers
    rng = np.random.RandomState(1)
    real = (rng.rand(40, 3) * np.float32([60, 80, 45]) - 6).astype(
        np.float32)
    got = tt.get_cells_on_boundary(real, ensemble)
    want = jt.get_cells_on_boundary(real, ensemble)
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0


@pytest.mark.parametrize("source", ["grid", "disk"])
@pytest.mark.parametrize("ensemble", [False, True])
def test_accurate_correction_matches_jax(transformers, ensemble, source):
    """From the grid map handed over (on the device) or from ``seg/`` on
    disk, single and ensemble mode; labels on the device or as numpy."""
    jt, tt, prob = transformers
    vol1 = np.asarray(jt.coord_vol1.raw_f32)
    rng = np.random.RandomState(4)
    start = vol1 + (rng.uniform(-2, 2, vol1.shape)
                    * np.float32([1, 1, 0.2])).astype(np.float32)
    start[0, 0] = 0.5                       # a cell at the x boundary
    kw = dict(prob_map_grid=prob.transpose(1, 2, 0)) \
        if source == "grid" else {}
    jc, jl = jt.accurate_correction(
        2, (1, 2, 2), JCoordinates.from_raw(start, INTERP, VOXEL_SIZE),
        ensemble=ensemble, **kw)
    tc, tl = tt.accurate_correction(
        2, (1, 2, 2), Coordinates.from_raw(start, INTERP, VOXEL_SIZE,
                                           device="cpu"),
        ensemble=ensemble, return_device=source == "grid", **kw)
    np.testing.assert_allclose(tc.real.numpy(), np.asarray(jc.real),
                               atol=1e-3)
    tl = tl.numpy() if source == "grid" else tl
    np.testing.assert_array_equal(tl, np.asarray(jl))
