"""The legacy v0.4 tracking half of the port and the whole legacy slice
against the JAX package, on the CPU: ``legacy_init_match``,
``pr_gls_quick``, ``legacy_fit_and_predict``,
``legacy_correction_and_render``, the segmenter, and
``legacy_segment_and_track_arrays`` against the JAX ``Tracker`` driven as
``scripts/bench_legacy_track.py`` drives it (a results folder,
``load_ffn_arrays``, ``segresult=`` injection), on a 3-volume scene like
``tests/test_legacy_tracker.py``'s.  The U-Net weights are the port's seeded
init with ``with_intensity_path``, the FFN ``feature_distance_ffn``: one set
of numbers handed to both packages; the JAX segmenter computes in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.config import SegmentationConfig as JSegConfig
from t3dct.engine import legacy as jlegacy
from t3dct.engine.segmentation import UNetSegmenter as JSegmenter
from t3dct.engine.transformer import _relabel_sequential_np
from t3dct.models.unet3d import UNet3D as JUNet3D
from t3dct.ops.matching import legacy_init_match as jinit
from t3dct.ops.prgls import pr_gls_quick as jprgls
from t3dct.ops.subregions import build_subregion_atlas as jatlas
from t3dct_torch.config import SegmentationConfig, TrackingConfig
from t3dct_torch.engine import legacy
from t3dct_torch.engine.segmentation import UNetSegmenter
from t3dct_torch.models.ffn import feature_distance_ffn
from t3dct_torch.models.unet3d import UNet3D, with_intensity_path
from t3dct_torch.ops import hopper_cc, hopper_conv, hopper_flood
from t3dct_torch.ops.matching import legacy_init_match
from t3dct_torch.ops.numerics import float64_to_float16
from t3dct_torch.ops.prgls import pr_gls_quick
from t3dct_torch.ops.subregions import SubregionAtlas

# raw PR-GLS output: the f32 EM amplifies rounding noise through its M-step
# solve, so two summation orders agree only to ~1e-3 real units (the v1.0
# EM's bound, tests/test_torch_tracking.py); after the correction loop,
# which snaps to probability-weighted centres, coordinates agree to 1e-3
EM_TOL = 1e-2
COORD_TOL = 1e-3

SHAPE = (48, 48, 8)                     # (x, y, z)
Z_XY_RATIO = 2.0
Z_SCALING = 2
CENTERS0 = np.array([[12, 12, 4], [12, 36, 4], [36, 12, 4], [36, 36, 4]],
                    np.float32)
DRIFT = np.array([[1.5, 0.5, 0], [-1.0, 1.0, 0], [0.5, -1.5, 0],
                  [-0.5, -0.5, 0]], np.float32)
UNET = dict(variant="a", tile_shape=(24, 24, 8), pool=(2, 2, 1),
            down_filters=((4, 4), (4, 8)), up_filters=((8, 8), (4, 4)),
            head_filters=(4,))
SEG = dict(noise_level=20, min_size=20, z_xy_ratio=Z_XY_RATIO,
           z_scaling=Z_SCALING, shrink=(4, 4, 2))
TRACK = dict(beta=50.0, lambda_=0.1, max_iteration=10)
MAX_CELLS = 64


def T(a):
    return torch.from_numpy(np.array(a))


def to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.cpu().numpy()),
                                  tree)


def volume_at(t):
    """tests/test_legacy_tracker.py's scene: 4 cells drifting by
    (t - 1) * DRIFT; (raw float32, labels, centres), (x, y, z)."""
    centers = CENTERS0 + (t - 1) * DRIFT
    xx, yy, zz = np.mgrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    img = np.random.RandomState(t).rand(*SHAPE) * 100
    lab = np.zeros(SHAPE, np.int32)
    for i, (cx, cy, cz) in enumerate(centers):
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2 + ((zz - cz) * Z_XY_RATIO) ** 2
        img += 8000 * np.exp(-d2 / 18.0)
        lab[d2 < 16] = i + 1
    return img.astype(np.float32), lab, centers


def models():
    """(port spec, params, state), (JAX spec, params, state), FFN pair."""
    spec = UNet3D(**UNET)
    params, state = spec.init(torch.Generator().manual_seed(0), device="cpu")
    params = with_intensity_path(params, spec)
    ffn = feature_distance_ffn(torch.Generator().manual_seed(1), "cpu")
    return ((spec, params, state),
            (JUNet3D(**UNET), to_jax(params), to_jax(state)),
            (ffn, to_jax(ffn)))


def jax_tracker_run(vols, lab1, jm, jffn, folder):
    """The JAX Tracker over the same volumes, segmentation injected from a
    float32 JAX segmenter (bench_legacy_track.py:165-193)."""
    jseg = JSegmenter(*jm, JSegConfig(**SEG), SHAPE, max_cells=MAX_CELLS,
                      compute_dtype=jnp.float32)
    jt = jlegacy.Tracker(
        volume_num=len(vols), siz_xyz=SHAPE, z_xy_ratio=Z_XY_RATIO,
        z_scaling=Z_SCALING, noise_level=SEG["noise_level"],
        min_size=SEG["min_size"], beta_tk=TRACK["beta"],
        lambda_tk=TRACK["lambda_"], maxiter_tk=TRACK["max_iteration"],
        folder_path=str(folder), image_name="raw_t%03i_z%03i.tif",
        unet_model_file="unet.npz", ffn_model_file="ffn.npz",
        shrink=SEG["shrink"], max_cells=MAX_CELLS)
    jt.load_ffn_arrays(*jffn)
    s1 = jseg.segment(vols[0])
    jt.segresult = s1
    jt.r_coordinates_segment_t0 = s1.r_coordinates_segment.copy()
    jt.segmentation_manual_relabels = _relabel_sequential_np(
        lab1.astype(np.int32))
    jt.interpolate_seg()
    jt.initiate_tracking()
    labels = {1: jt.segmentation_manual_relabels}
    cells = {1: s1.r_coordinates_segment.shape[0]}
    for t in range(2, len(vols) + 1):
        st = jseg.segment(vols[t - 1])
        cells[t] = st.r_coordinates_segment.shape[0]
        jt.track_one_vol(t, segresult=st)
        labels[t] = jt.tracked_labels
    return jt, labels, cells, s1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tm, jm, (ffn, jffn) = models()
    vols = [volume_at(t)[0] for t in (1, 2, 3)]
    lab1 = volume_at(1)[1]
    jt, jlabels, jcells, s1 = jax_tracker_run(
        vols, lab1, jm, jffn, tmp_path_factory.mktemp("legacy"))
    got = legacy.legacy_segment_and_track_arrays(
        vols, tm, ffn, lab1, SegmentationConfig(**SEG),
        TrackingConfig(**TRACK), max_cells=MAX_CELLS, device="cpu")
    return dict(jt=jt, jlabels=jlabels, jcells=jcells, s1=s1, got=got)


def test_slice_coords_match(runs):
    """Tracked coordinates per volume to 1e-3 real units."""
    jt, got = runs["jt"], runs["got"]
    assert sorted(got.coords) == [1, 2, 3]
    for t, want in enumerate(jt.history.r_tracked_coordinates, start=1):
        assert got.coords[t].shape == want.shape == (4, 3)
        np.testing.assert_allclose(got.coords[t], want, atol=COORD_TOL)


def test_slice_labels_match(runs):
    for t, want in runs["jlabels"].items():
        assert runs["got"].labels[t].dtype == np.uint16
        np.testing.assert_array_equal(runs["got"].labels[t].astype(np.int64),
                                      np.asarray(want).astype(np.int64))


def test_slice_segmentation_matches(runs):
    got, s1 = runs["got"], runs["s1"]
    assert got.cells == runs["jcells"]
    np.testing.assert_array_equal(got.auto_vol1, s1.segmentation_auto)
    assert got.cells[1] >= 4


def test_slice_follows_the_cells(runs):
    """With the pass-through weights the tracked cells stay near the true
    centres (median under 1 real unit, all under 2.5); a sanity bound, not
    accuracy."""
    for t, c in runs["got"].coords.items():
        true = (CENTERS0 + (t - 1) * DRIFT) * np.array([1, 1, Z_XY_RATIO])
        err = np.linalg.norm(c - true, axis=1)
        assert np.median(err) < 1.0 and err.max() < 2.5


def test_slice_rejects_ensemble():
    with pytest.raises(ValueError):
        legacy.legacy_segment_and_track_arrays(
            [np.zeros(SHAPE, np.float32)], None, None,
            np.zeros(SHAPE, np.int32), SegmentationConfig(**SEG),
            TrackingConfig(ensemble=True), device="cpu")


def test_cpu_slice_launches_no_kernel():
    """On CPU tensors the four kernel wrappers run their plain versions:
    the launch counters stay 0 through the legacy slice."""
    counters = hopper_conv.KERNELS + (hopper_flood.flood_slices,
                                      hopper_cc.cc_label)
    before = [c.launches for c in counters]
    tm, _, (ffn, _) = models()
    vols = [volume_at(t)[0] for t in (1, 2)]
    res = legacy.legacy_segment_and_track_arrays(
        vols, tm, ffn, volume_at(1)[1], SegmentationConfig(**SEG),
        TrackingConfig(**TRACK), max_cells=MAX_CELLS, device="cpu")
    assert res.coords[2].shape == (4, 3)
    assert [c.launches for c in counters] == before == [0, 0, 0, 0]


def test_segment_matches():
    """``UNetSegmenter.segment``: probabilities to 1e-5, labels and the
    learned cell count exactly, centres to 1e-5, gcn exactly."""
    tm, jm, _ = models()
    raw = volume_at(2)[0]
    jseg = JSegmenter(*jm, JSegConfig(**SEG), SHAPE, max_cells=MAX_CELLS,
                      compute_dtype=jnp.float32)
    tseg = UNetSegmenter(*tm, SegmentationConfig(**SEG), SHAPE,
                         max_cells=MAX_CELLS, device="cpu")
    want = jseg.segment(raw)
    got = tseg.segment(raw)
    np.testing.assert_allclose(got.image_cell_bg.numpy(), want.image_cell_bg,
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.segmentation_auto.numpy(),
                                  want.segmentation_auto)
    np.testing.assert_allclose(got.r_coordinates_segment.numpy(),
                               want.r_coordinates_segment, atol=1e-5)
    np.testing.assert_array_equal(got.image_gcn.numpy(), want.image_gcn)
    assert (tseg.config.min_size, tseg.config.cell_num) == (
        jseg.config.min_size, jseg.config.cell_num)


def test_segment_raises_without_cells():
    tm, _, _ = models()
    tseg = UNetSegmenter(*tm, SegmentationConfig(**SEG), SHAPE,
                         max_cells=MAX_CELLS, device="cpu")
    with pytest.raises(ValueError, match="No cell was detected by 3D U-Net"):
        tseg.segment(np.zeros(SHAPE, np.float32))
    with pytest.raises(ValueError, match="cell_num"):
        tseg.segment(volume_at(1)[0], method="cell_num")


def point_sets(seed, n=30, m=34, pad=48):
    """Padded (ref, tgt) point sets of a drifting cloud with FFN-like
    scores: (x_ref, y_tgt, corr, ref_mask, tgt_mask)."""
    rng = np.random.RandomState(seed)
    ref = rng.uniform(0, 60, (n, 3)).astype(np.float32)
    tgt = np.concatenate([ref + rng.randn(n, 3) * 0.8 + [1.5, -1.0, 0.5],
                          rng.uniform(0, 60, (m - n, 3))]).astype(np.float32)
    perm = rng.permutation(m)
    tgt = tgt[perm]
    x = np.full((pad, 3), 1e6, np.float32)
    y = np.full((pad, 3), 1e6, np.float32)
    x[:n], y[:m] = ref, tgt
    corr = rng.rand(pad, pad).astype(np.float32) * 0.45
    for i, j in enumerate(perm):
        if j < n and rng.rand() < 0.8:
            corr[i, j] = 0.6 + 0.4 * rng.rand()
    return x, y, corr, np.arange(pad) < n, np.arange(pad) < m


@pytest.mark.parametrize("seed", [0, 1])
def test_legacy_init_match_exact(seed):
    _, _, corr, rm, tm_ = point_sets(seed)
    want = np.asarray(jinit(jnp.asarray(corr), 0.5, ref_mask=jnp.asarray(rm),
                            tgt_mask=jnp.asarray(tm_)))
    got = legacy_init_match(T(corr), 0.5, ref_mask=T(rm), tgt_mask=T(tm_))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        legacy_init_match(T(corr[:10, :12])).numpy(),
        np.asarray(jinit(jnp.asarray(corr[:10, :12]))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pr_gls_quick_matches(seed):
    x, y, corr, rm, tm_ = point_sets(seed)
    want = jprgls(jnp.asarray(x), jnp.asarray(y), jnp.asarray(corr),
                  beta=20.0, max_iteration=20, lambda_=0.1,
                  ref_mask=jnp.asarray(rm), tgt_mask=jnp.asarray(tm_))
    got = pr_gls_quick(T(x), T(y), T(corr), beta=20.0, max_iteration=20,
                       lambda_=0.1, ref_mask=T(rm), tgt_mask=T(tm_))
    np.testing.assert_allclose(got.moved_ref.numpy()[rm],
                               np.asarray(want.moved_ref)[rm], atol=EM_TOL)
    np.testing.assert_array_equal(got.moved_ref.numpy()[~rm],
                                  np.asarray(want.moved_ref)[~rm])
    np.testing.assert_allclose(got.posterior.numpy(),
                               np.asarray(want.posterior), atol=1e-3)
    assert not bool(got.solve_failed)
    # the motion follows the drift
    moved = got.moved_ref.numpy()[rm] - x[rm]
    assert np.abs(np.median(moved, axis=0) - [1.5, -1.0, 0.5]).max() < 0.5


def test_legacy_fit_and_predict_matches():
    _, _, (ffn, jffn) = models()
    x, y, _, rm, tm_ = point_sets(3)
    tracked0 = x[rm][:, :] + np.float32(0.25)
    want = jlegacy.legacy_fit_and_predict(
        *jffn, jnp.asarray(x), jnp.asarray(rm), jnp.asarray(y),
        jnp.asarray(tm_), jnp.asarray(tracked0), 30.0, 0.1,
        max_iteration=10)
    got = legacy.legacy_fit_and_predict(
        *ffn, T(x), T(rm), T(y), T(tm_), T(tracked0), 30.0, 0.1,
        max_iteration=10)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=EM_TOL)
    assert got[1].shape == (5, 48, 3) and got[2].shape == (5, 3, 48)


def test_legacy_fit_raises_on_a_failed_solve():
    """With lambda = 0 a padded ref's row of the M-step system is all zero,
    so every solve meets a zero pivot: ``pr_gls_quick`` flags it without a
    host sync, and the fit raises once, after its repetitions, instead of
    carrying the solver's garbage on."""
    _, _, (ffn, _) = models()
    x, y, corr, rm, tm_ = point_sets(3)
    res = pr_gls_quick(T(x), T(y), T(corr), beta=20.0, max_iteration=5,
                       lambda_=0.0, ref_mask=T(rm), tgt_mask=T(tm_))
    assert bool(res.solve_failed)
    with pytest.raises(torch.linalg.LinAlgError, match="M-step"):
        legacy.legacy_fit_and_predict(
            *ffn, T(x), T(rm), T(y), T(tm_), T(x[rm]), 30.0, 0.0,
            max_iteration=5)


@pytest.fixture(scope="module")
def atlas_case():
    """A JAX atlas of the vol-1 labels with its torch twin, vol-2 weights
    and the vol-1 centres (real units)."""
    _, lab, centers = volume_at(1)
    n = int(lab.max())
    atlas = jatlas(jnp.asarray(lab), n_cells=n, box_shape=(10, 10, 6),
                   interpolation_factor=Z_SCALING)
    tatlas = SubregionAtlas(T(atlas.boxes), T(atlas.origins),
                            T(atlas.valid), atlas.interpolation_factor,
                            atlas.image_shape)
    img2, _, _ = volume_at(2)
    weights = (img2 / img2.max()).astype(np.float16)
    tracked_t0 = (centers * np.array([1, 1, Z_XY_RATIO])).astype(np.float32)
    return atlas, tatlas, weights, tracked_t0, n


@pytest.mark.parametrize("start", [0, 1])
def test_legacy_correction_and_render_matches(atlas_case, start):
    """Coordinates to 1e-3, displacements and rendered labels exactly,
    including a boundary cell left out of the paste."""
    atlas, tatlas, weights, tracked_t0, n = atlas_case
    i_disp0 = (np.arange(n * 3).reshape(n, 3) % 3 - 1).astype(np.int32) \
        * start
    include = np.array([True, True, True, start == 0])
    want = jax.device_get(jlegacy.legacy_correction_and_render(
        atlas, weights, i_disp0, include, tracked_t0, Z_XY_RATIO,
        Z_SCALING, max_repetition=5))
    got = legacy.legacy_correction_and_render(
        tatlas, T(weights), T(i_disp0), T(include), T(tracked_t0),
        Z_XY_RATIO, Z_SCALING, max_repetition=5)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=COORD_TOL)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_float64_to_float16_is_numpys_cast():
    """PyTorch rounds float64 -> float16 through float32 (twice); the
    weight map must round as numpy does, once."""
    rng = np.random.RandomState(9)
    h = rng.rand(50000).astype(np.float16).astype(np.float64)
    ulp = np.float64(2.0 ** -11) * 2.0 ** np.floor(np.log2(h + 1e-3))
    x = h + ulp / 2 + rng.choice([-1, 1], h.size) * rng.rand(h.size) \
        * 2.0 ** -36
    want = x.astype(np.float16)
    assert (T(x).to(torch.float16).numpy() != want).any()
    np.testing.assert_array_equal(float64_to_float16(T(x)).numpy(), want)


def test_tracker_pads_and_refuses_too_many_cells():
    tr = legacy.Tracker(3, SHAPE, Z_XY_RATIO, Z_SCALING, 20, 20, 50.0, 0.1,
                        10, max_cells=4, device="cpu")
    pts, mask = tr._pad_pts(np.ones((3, 3)))
    assert pts.shape == (4, 3) and mask.tolist() == [True] * 3 + [False]
    assert float(pts[3, 0]) == legacy.PARK
    with pytest.raises(ValueError, match="max_cells"):
        tr._pad_pts(np.ones((5, 3)))


def test_legacy_posterior_zero_denominator_is_an_outlier():
    """The fault the port repairs: once gamma rounds to exactly 0 in
    float32 and a target's likelihoods all underflow, the JAX E-step
    (``ops/prgls.py:298-304``, written out here) divides 0 by 0 and the NaN
    row poisons the M-step's solve for every cell.  The port gives that row
    0 and agrees with JAX everywhere else."""
    from t3dct_torch.ops.prgls import legacy_posterior
    rng = np.random.RandomState(10)
    init = rng.rand(5, 4).astype(np.float32)
    d2 = rng.rand(5, 4).astype(np.float32) * 4
    d2[2] = 1e4                                  # far from every ref
    valid = np.ones((5, 4), bool)
    valid[4, :] = False                          # a padded target
    sigma_sq, gamma, vol = np.float32(1.0), np.float32(0.0), 1e8
    p1 = init * np.exp(-np.where(valid, d2, 0) / (2.0 * sigma_sq))
    p1 = jnp.where(valid, p1, 0.0)
    denom = jnp.sum(p1, axis=1) + gamma * (2.0 * jnp.pi * sigma_sq) ** 1.5 \
        / ((1.0 - gamma) * vol)
    want = np.asarray(jnp.where(valid, p1 / denom[:, None], 0.0))
    assert np.isnan(want[2]).all()
    got = legacy_posterior(T(init), T(d2), T(valid), T(sigma_sq), T(gamma),
                           T(np.float32(vol))).numpy()
    np.testing.assert_array_equal(got[2], 0.0)
    ok = np.arange(5) != 2
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6)
