"""Tiled StarDist prediction of the port against the JAX package on the
CPU (JAX ``engine/stardist.py:408-709``): ``StarDist3D.
predict_instances_tiled`` and ``predict_and_save(tile_shape=...)``, with
the same weights, at JAX's own test size (``tests/test_stardist_tiled.py::
_cfg_small``, (16, 96, 96) volumes, tiles of (None, 72, 72)).

The weights are a seeded init with ``with_intensity_path`` and the volumes
bright gaussian cells on noise, so detections follow the cells and no two
candidates' probabilities tie within the two frameworks' f32 rounding.
Tolerances: prob maps 1e-5 (f32 sums in another order, JAX's parity
bound); points, kept sets and labels exact."""

import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.config import StarDistConfig as JStarDistConfig
from t3dct.engine.stardist import StarDist3D as JStarDist3D
from t3dct_torch.config import StarDistConfig
from t3dct_torch.engine.stardist import StarDist3D
from t3dct_torch.models.stardist3d import StarDist3DNet, with_intensity_path
from t3dct_torch.ops.tiling import _reflect_index, pad_for_tiles
from test_torch_scene import to_jax

CFG = dict(n_rays=8, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0),
           unet_n_depth=1, unet_n_filter_base=4, net_conv_after_unet=8,
           train_patch_size=(16, 32, 32), prob_thresh=0.6, nms_thresh=0.3)
SHAPE = (16, 96, 96)
TILE = (None, 72, 72)
MODEL = dict(max_candidates=64, render_box=(9, 17, 17))
PROB_TOL = 1e-5


def raw_volume(seed, shape=SHAPE, n_cells=14):
    """uint16 gaussian cells on noise (z radius half the y/x one)."""
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    img = rng.rand(*shape) * 0.1
    lo = np.asarray([2, 4, 4])
    hi = np.asarray(shape) - lo
    for c in rng.uniform(lo, hi, (n_cells, 3)):
        d2 = (2 * (zz - c[0])) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        img += np.exp(-d2 / 18.0)
    return (img * 20000).astype(np.uint16)


def normalized(raw):
    mi, ma = np.percentile(raw, (1.0, 99.8))
    return ((raw.astype(np.float32) - np.float32(mi))
            / (np.float32(ma) - np.float32(mi) + np.float32(1e-20)))


@pytest.fixture(scope="module")
def models():
    cfg = StarDistConfig(**CFG)
    params = with_intensity_path(StarDist3DNet(cfg).init(
        torch.Generator().manual_seed(0), "cpu"), cfg)
    jm = JStarDist3D(JStarDistConfig(**CFG), params=to_jax(params), **MODEL)
    tm = StarDist3D(cfg, params=params, device="cpu", **MODEL)
    return jm, tm


def assert_same_instances(got, want, prob_tol=PROB_TOL):
    (g_lab, g_det), g_prob = got
    (w_lab, w_det), w_prob = want
    assert g_prob.dtype == np.float32 and g_prob.shape == w_prob.shape
    assert np.abs(g_prob - np.asarray(w_prob)).max() <= prob_tol
    np.testing.assert_array_equal(g_det["points"], w_det["points"])
    assert np.abs(g_det["prob"] - w_det["prob"]).max() <= prob_tol
    if w_lab is None:
        assert g_lab is None
    else:
        np.testing.assert_array_equal(np.asarray(g_lab, np.int64),
                                      np.asarray(w_lab, np.int64))


def test_tiled_matches_jax(models):
    jm, tm = models
    x = normalized(raw_volume(1))
    want = jm.predict_instances_tiled(x, tile_shape=TILE)
    got = tm.predict_instances_tiled(x, tile_shape=TILE)
    assert_same_instances(got, want)
    assert got[1].shape == (16, 48, 48)
    assert 8 <= len(got[0][1]["points"]) <= 64


def test_tiled_raw_uint16_matches_float(models):
    """Raw uint16 with its percentiles as ``norm_minmax`` gives the
    instances of the host-normalized float volume (JAX's bound on the prob
    map, 2e-6), and JAX's own raw run."""
    jm, tm = models
    raw = raw_volume(2)
    mi, ma = (float(v) for v in np.percentile(raw, (1.0, 99.8)))
    from_raw = tm.predict_instances_tiled(raw, tile_shape=TILE,
                                          norm_minmax=(mi, ma))
    from_float = tm.predict_instances_tiled(normalized(raw), tile_shape=TILE)
    assert_same_instances(from_raw, from_float, prob_tol=2e-6)
    assert_same_instances(from_raw, jm.predict_instances_tiled(
        raw, tile_shape=TILE, norm_minmax=(mi, ma)))


def test_tile_batch_does_not_change_the_instances(models):
    """1, 3 and 8 tiles a backbone call (36 tiles: the last batch of 8
    filled with copies): points and labels exact; the prob maps within
    ``PROB_TOL``, as the CPU's plain conv (oneDNN) sums in another order
    for another batch size (on the card the kernels' sums do not depend on
    the batch: ``chip_smoke.py`` phase 17 holds them bit for bit)."""
    _, tm = models
    x = normalized(raw_volume(3))
    runs = [tm.predict_instances_tiled(x, tile_shape=TILE, tile_batch=b)
            for b in (1, 3, 8)]
    for other in runs[1:]:
        assert_same_instances(other, runs[0])


def test_too_small_tiles_raise(models):
    _, tm = models
    with pytest.raises(ValueError, match="too small for shrink"):
        tm.predict_instances_tiled(np.zeros(SHAPE, np.float32),
                                   tile_shape=(None, 40, 40))


def test_tiled_interior_matches_whole_volume(models):
    """With the receptive-field shrink, the tiled prob map equals the
    port's whole-volume pass beyond the receptive field of the tiled faces
    (13 grid voxels), within ``PROB_TOL``: on the CPU the plain conv
    (oneDNN) picks its summation order by the input's shape (on the card
    ``chip_smoke.py`` phase 17 holds JAX's 1e-6)."""
    _, tm = models
    x = normalized(raw_volume(4))
    whole = tm.predict_sparse(x)[4].numpy()
    (_, _), tiled = tm.predict_instances_tiled(x, tile_shape=TILE,
                                               return_labels=False)
    m = -(-tm.net.receptive_field()[1] // CFG["grid"][1])
    assert m == 13
    assert np.abs(tiled[:, m:-m, m:-m] - whole[:, m:-m, m:-m]).max() \
        <= PROB_TOL


@pytest.mark.parametrize("n", [1, 2, 3, 5, 10])
@pytest.mark.parametrize("before", [0, 1, 4, 12, 28])
def test_reflect_index_is_numpys(n, before):
    """``ops.tiling._reflect_index`` gives ``np.pad(mode="reflect")``'s
    indices, also for pads several times wider than the axis."""
    after = 2 * before + 3
    want = np.pad(np.arange(n), (before, after), mode="reflect")
    np.testing.assert_array_equal(_reflect_index(n, before,
                                                 n + before + after), want)


@pytest.mark.parametrize("shape,tile,shrink", [
    (SHAPE, TILE, None),
    ((16, 96, 96), (None, 72, None), None),
    ((16, 10, 96), (None, 32, None), (0, 12, 0)),     # pad wider than y
    ((8, 50, 44), (6, 36, 40), (2, 8, 12)),
])
def test_plan_and_padding_match_jax(models, shape, tile, shrink):
    """Every plan these tests use: the port's origins, padded shape and
    reflect padding (on the device side, ``pad_for_tiles``) equal JAX's
    ``_plan_tiling``."""
    jm, tm = models
    x = np.random.RandomState(5).rand(*shape).astype(np.float32)
    _, _, tiles, shr, plan, padded, _, _ = jm._plan_tiling(x, tile, shrink)
    mine = tm.plan_tiling(shape, tile, shrink)
    assert mine.tile_shape == tuple(tiles) and mine.shrink == tuple(shr)
    assert mine.padded_shape == tuple(plan.padded_shape)
    np.testing.assert_array_equal(mine.origins, plan.origins)
    np.testing.assert_array_equal(
        pad_for_tiles(torch.from_numpy(x), mine).numpy(), padded)


def test_thin_axis_matches_jax(models):
    """A volume thinner than its shrink along a tiled axis: numpy's
    repeated reflection on both sides."""
    jm, tm = models
    x = normalized(raw_volume(6, shape=(16, 10, 96), n_cells=4))
    kw = dict(tile_shape=(None, 32, None), shrink=(0, 12, 0),
              prob_thresh=0.3)
    assert_same_instances(tm.predict_instances_tiled(x, **kw),
                          jm.predict_instances_tiled(x, **kw))


def write_recording(root, n_vols=3):
    """``n_vols`` raw volumes as per-(t, z) uint16 TIFF slices."""
    from t3dct_torch.io.imageio import save_label_slices
    for t in range(1, n_vols + 1):
        save_label_slices(raw_volume(10 + t).transpose(1, 2, 0), root,
                          "raw_t%03i_z%04i.tif", t, use_8_bit=False,
                          compression=None)
    return str(root / "raw_t%03i_z*.tif")


def test_predict_and_save_tiled_matches_jax(models, tmp_path):
    """The recording driver's tiled branch writes JAX's ``seg/`` (coords
    exact, float32 prob maps within 1e-5) and ``auto_vol1/`` labels."""
    from t3dct.engine.stardist import predict_and_save as j_predict_and_save
    from t3dct_torch.engine.stardist import predict_and_save
    from t3dct_torch.io.artifacts import ResultsTree
    from t3dct_torch.io.imageio import imread_stack
    jm, tm = models
    pattern = write_recording(tmp_path / "raw")
    kw = dict(tile_shape=TILE, tile_candidates=32, tile_batch=4)
    j_predict_and_save(pattern, jm, tmp_path / "jax", **kw)
    predict_and_save(pattern, tm, tmp_path / "port", **kw)
    mine, theirs = ResultsTree(tmp_path / "port"), ResultsTree(tmp_path /
                                                               "jax")
    for t in (1, 2, 3):
        np.testing.assert_array_equal(mine.load_seg_coords(t),
                                      theirs.load_seg_coords(t))
        prob = mine.load_seg_prob(t)
        assert prob.dtype == np.float32 and prob.shape == (48, 48, 16)
        assert np.abs(prob - theirs.load_seg_prob(t)).max() <= PROB_TOL
        assert len(mine.load_seg_coords(t)) >= 4
    labels = [imread_stack(sorted((tmp_path / side / "auto_vol1").glob(
        "*.tif"))) for side in ("port", "jax")]
    np.testing.assert_array_equal(labels[0], labels[1])


def test_predict_and_save_tiled_rejects_mesh_and_data_axis(models,
                                                           tmp_path):
    from t3dct_torch.engine.stardist import predict_and_save
    _, tm = models
    pattern = write_recording(tmp_path / "raw", n_vols=1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        predict_and_save(pattern, tm, tmp_path / "r", tile_shape=TILE,
                         mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        predict_and_save(pattern, tm, tmp_path / "r", data_axis="tiles",
                         mesh=object())
    # no process group here: the sharded path raises instead of running
    # on one process (tests/test_torch_mesh_tiles.py runs it)
    with pytest.raises(RuntimeError, match="not initialized"):
        tm.predict_instances_sharded(np.zeros(SHAPE, np.float32))


def test_segment_large_volume_script_at_small_size():
    """``scripts/segment_large_volume.py`` with the example's config and
    tiled settings on a small volume on the CPU; ``--sharded`` outside a
    process group raises (no fall back to one process; ``--cpu-mesh``
    runs are ``tests/test_torch_mesh_tiles.py``)."""
    from t3dct_torch.scripts import segment_large_volume as script
    out = script.main(["--shape", "16", "64", "64", "--tile", "112", "112",
                       "--repeat", "2", "--device", "cpu"])
    assert out["labels_shape"] == (16, 64, 64)
    assert out["prob_map_shape"] == (8, 16, 16)
    assert len(out["seconds"]) == 2 and out["instances"] >= 0
    with pytest.raises(RuntimeError, match="not initialized"):
        script.main(["--sharded", "--shape", "16", "64", "64", "--device",
                     "cpu"])


def test_segment_large_volume_script_sharded_cpu_mesh():
    """``--sharded --cpu-mesh 2``: two spawned ``gloo`` ranks split the
    36 tiles (``predict_instances_sharded``) and rank 0's result is the
    sequential tiled run's: labels and points equal, the prob map within
    ``PROB_TOL`` (the ranks run one thread each, this process its own
    count, and the CPU conv sums in another order on another count;
    ``tests/test_torch_mesh_tiles.py`` holds the two bit for bit on equal
    threads)."""
    from t3dct_torch.scripts import segment_large_volume as script
    args = ["--shape", "16", "96", "96", "--tile", "112", "112"]
    want = script.main(args + ["--device", "cpu"])
    got = script.main(args + ["--sharded", "--cpu-mesh", "2"])
    assert got["labels_shape"] == want["labels_shape"] == (16, 96, 96)
    assert np.abs(got["prob_map"] - want["prob_map"]).max() <= PROB_TOL
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["points"], want["points"])
