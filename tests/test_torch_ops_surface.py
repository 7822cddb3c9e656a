"""The operator library's options and the public names below the entry
points, in the port against the JAX package on the CPU, on the same seeded
inputs (at most (16, 24, 8)): ``gaussian_filter``'s modes and truncation
(its default is scipy's ``"reflect"``, as JAX's), ``lcn`` /
``normalize_image`` padding and ``config``, the envelope EDT,
``threshold_abs``, ``max_iters`` on an unfinished chain,
``move_cells_full``'s modes, the neighbourhood reductions,
``rays_volume_weights``, ``overlap_matrix``'s sampling, the chunked
``star_dist3d`` and ``ffn_pair_scores``, the initialisers, the fused
track steps under JAX's names, ``legacy_correction_and_render(labels_u8)``,
``upsample_prob_pipeline(xp)``, ``save_merged_labels`` on a results tree
and ``make_mesh(devices)``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct  # noqa: F401
import t3dct_torch  # noqa: F401
from t3dct.config import LcnConfig as JLcnConfig
from t3dct.engine import legacy as jlegacy
from t3dct.engine import pipeline as jpipeline
from t3dct.engine.transformer import CoordsToImageTransformer as JTransformer
from t3dct.engine.transformer import upsample_prob_pipeline as jupsample
from t3dct.models import ffn as jffn
from t3dct.models import layers as JL
from t3dct.ops import connected as jconnected
from t3dct.ops import edt as jedt
from t3dct.ops import filters as jfilters
from t3dct.ops import neighborhood as jneighborhood
from t3dct.ops import nms as jnms
from t3dct.ops import peaks as jpeaks
from t3dct.ops import rays as jrays
from t3dct.ops import stardist_gt as jgt
from t3dct.ops import subregions as jsubregions
from t3dct_torch.config import LcnConfig
from t3dct_torch.engine import legacy, pipeline
from t3dct_torch.engine.transformer import upsample_prob_pipeline
from t3dct_torch.models import ffn, layers
from t3dct_torch.ops import (connected, edt, filters, neighborhood, nms,
                             peaks, rays, stardist_gt, subregions)
from t3dct_torch.ops.lcn import lcn, normalize_image
from t3dct_torch.utils.synthetic import serpentine
from test_torch_legacy import (COORD_TOL, Z_SCALING, Z_XY_RATIO,  # noqa
                               atlas_case)
from test_torch_scene import INTERP, VOXEL_SIZE, ffn_pair, recording
from test_torch_tracking import _atlas_to_torch, _seg_candidates

# ops.lcn is the function in both packages; the modules by their paths
jlcn = importlib.import_module("t3dct.ops.lcn")

SHAPE = (16, 24, 8)
BLUR_ATOL = 1e-6
LCN_RTOL = 1e-5
EDT_RTOL = 1e-6
OVERLAP_ATOL = 1e-6
SCORE_ATOL = 1e-6        # tests/test_torch_tracking.py's FFN scores


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    """The seeded inputs every test here shares."""
    rng = np.random.default_rng(0)
    blur = rng.random((12, 20, 16), dtype=np.float32)
    image = (rng.random(SHAPE, dtype=np.float32) * 200).astype(np.float32)
    mask = rng.random(SHAPE) > 0.2
    plateaus = np.round(rng.random(SHAPE) * 20).astype(np.float32)
    values = rng.integers(0, 4, SHAPE).astype(np.int32)
    # four blobs, labels 1..4, in an (x, y, z) volume
    xx, yy, zz = np.mgrid[:SHAPE[0], :SHAPE[1], :SHAPE[2]]
    labels = np.zeros(SHAPE, np.int32)
    for i, (cx, cy, cz) in enumerate([(4, 5, 3), (4, 17, 4), (11, 6, 4),
                                      (11, 17, 3)]):
        labels[(xx - cx) ** 2 + (yy - cy) ** 2 + 4 * (zz - cz) ** 2
               < 12] = i + 1
    return dict(blur=blur, image=image, mask=mask, plateaus=plateaus,
                values=values, labels=labels)


# ---- ops.filters -------------------------------------------------------------


def test_gaussian_filter_default_is_jax_s(data):
    """JAX's default padding is scipy's ``"reflect"``: the same call gives
    the same blur (the zero-padded one is 0.44 off at the edges)."""
    x = data["blur"]
    want = np.asarray(jfilters.gaussian_filter(jnp.asarray(x), 1.5))
    got = filters.gaussian_filter(T(x), 1.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BLUR_ATOL)
    zero = filters.gaussian_filter(T(x), 1.5, "zero").numpy()
    assert np.abs(zero - want).max() > 0.4


@pytest.mark.parametrize("truncate", [4.0, 2.2])
@pytest.mark.parametrize("mode", ["reflect", "zero", "mirror"])
def test_gaussian_filter_modes(data, mode, truncate):
    x = data["blur"]
    for sigma in (1.5, (2.5, 0.0, 9.0)):    # a kernel wider than an axis
        want = np.asarray(jfilters.gaussian_filter(jnp.asarray(x), sigma,
                                                   mode, truncate))
        got = filters.gaussian_filter(T(x), sigma, mode, truncate).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=BLUR_ATOL)
    np.testing.assert_array_equal(filters.gaussian_kernel_1d(1.7, truncate),
                                  jfilters.gaussian_kernel_1d(1.7, truncate))


def test_gaussian_filter_batch_and_bad_mode(data):
    """``batch_ndim`` (keyword-only) blurs each slice alone, as JAX's
    vmap; an unknown mode raises."""
    x = data["blur"]
    want = np.asarray(jax.vmap(lambda v: jfilters.gaussian_filter(
        v, 2.0, "mirror"))(jnp.asarray(x)))
    got = filters.gaussian_filter(T(x), 2.0, "mirror", batch_ndim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BLUR_ATOL)
    with pytest.raises(ValueError):
        filters.gaussian_filter(T(x), 1.0, "wrap")


# ---- ops.lcn -------------------------------------------------------------------


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("padding", ["zero", "reflect"])
def test_lcn_padding_and_config(data, padding):
    x = data["image"]
    want = np.asarray(jlcn.lcn(jnp.asarray(x), 7.0, (9, 7, 1), padding))
    _close(lcn(T(x), 7.0, (9, 7, 1), padding).numpy(), want, LCN_RTOL)
    cfg = dict(noise_level=3.0, filter_size=(5, 9, 3), padding=padding)
    want = np.asarray(jlcn.lcn(jnp.asarray(x), config=JLcnConfig(**cfg)))
    _close(lcn(T(x), config=LcnConfig(**cfg)).numpy(), want, LCN_RTOL)
    want = np.asarray(jlcn.normalize_image(jnp.asarray(x), 5.0, (9, 7, 1),
                                           padding, 7))
    _close(normalize_image(T(x), 5.0, (9, 7, 1), padding, 7).numpy(), want,
           LCN_RTOL)


def test_ops_lcn_is_the_function():
    from t3dct_torch import ops
    assert ops.lcn is lcn and "lcn" in ops.__all__


# ---- ops.edt -------------------------------------------------------------------


@pytest.mark.parametrize("sampling", [None, (1.0, 0.7, 2.5)])
def test_edt_envelope(data, sampling):
    """``"envelope"`` against JAX's envelope and the port's dense pass;
    ``window`` by position; an unknown method raises as JAX's."""
    m = data["mask"]
    want = np.asarray(jedt.distance_transform_edt(jnp.asarray(m), sampling,
                                                  None, "envelope"))
    got = edt.distance_transform_edt(T(m), sampling, None, "envelope")
    _close(got.numpy(), want, EDT_RTOL)
    _close(got.numpy(), edt.distance_transform_edt(T(m), sampling).numpy(),
           EDT_RTOL)
    want = np.asarray(jedt.distance_transform_edt(jnp.asarray(m), sampling,
                                                  2))
    np.testing.assert_array_equal(
        edt.distance_transform_edt(T(m), sampling, 2).numpy(), want)
    with pytest.raises(ValueError):
        edt.distance_transform_edt(T(m), sampling, None, "exact")


def test_edt_envelope_batched_and_long_lines():
    """Per slice as JAX's vmap; lines of 1000 with few zeros, whose hulls
    pop many parabolas."""
    rng = np.random.default_rng(3)
    m = rng.random((3, 5, 1000)) > 0.003
    want = np.asarray(jax.vmap(lambda v: jedt.distance_transform_edt(
        v, (1.0, 0.5), method="envelope"))(jnp.asarray(m)))
    got = edt.distance_transform_edt(T(m), (1.0, 0.5), method="envelope",
                                     batch_ndim=1)
    _close(got.numpy(), want, EDT_RTOL)


# ---- ops.peaks -----------------------------------------------------------------


@pytest.mark.parametrize("threshold", [None, 9.5])
def test_peak_local_max_threshold_abs(data, threshold):
    x = data["plateaus"]
    want = np.asarray(jpeaks.peak_local_max_mask(jnp.asarray(x), 1, None,
                                                 threshold))
    got = peaks.peak_local_max_mask(T(x), 1, None, threshold)
    np.testing.assert_array_equal(got.numpy(), want)
    # a batch of images, each with its own minimum (or the threshold)
    want = np.asarray(jax.vmap(lambda v: jpeaks.peak_local_max_mask(
        v, 2, 0, threshold), in_axes=2, out_axes=2)(jnp.asarray(x)))
    got = peaks.peak_local_max_mask(T(x).permute(2, 0, 1), 2, 0, threshold,
                                    batch_ndim=1).permute(1, 2, 0)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- ops.connected -------------------------------------------------------------


@pytest.mark.parametrize("max_iters", [0, 4, 9, 256])
@pytest.mark.parametrize("conn", [None, 1])
def test_label_components_max_iters(max_iters, conn):
    """A serpentine takes one hook round a voxel: a small ``max_iters``
    leaves it unfinished, where both packages stop at the same labels."""
    m = serpentine((16, 24, 2))
    want = np.asarray(jconnected.label_components_raw(jnp.asarray(m), conn,
                                                      max_iters))
    got = connected.label_components_raw(T(m), conn, max_iters)
    np.testing.assert_array_equal(got.numpy(), want)
    if max_iters < 256:
        assert len(np.unique(want)) > 2          # unfinished
    want = np.asarray(jconnected.label_components(jnp.asarray(m), conn, 7,
                                                  max_iters))
    got = connected.label_components(T(m), conn, 7, max_iters)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_iters", [2, 256])
def test_label_components_values_max_iters(data, max_iters):
    v = np.where(serpentine((16, 24, 8)), 3, data["values"]).astype(
        np.int32)
    for fn in ("label_components_values_raw", "label_components_values"):
        args = (None, max_iters) if fn.endswith("raw") else (None, 9,
                                                              max_iters)
        want = np.asarray(getattr(jconnected, fn)(jnp.asarray(v), *args))
        got = getattr(connected, fn)(T(v), *args)
        np.testing.assert_array_equal(got.numpy(), want)
    lab = data["values"] * 3
    np.testing.assert_array_equal(
        connected.relabel_sequential(T(lab), 2).numpy(),
        np.asarray(jconnected.relabel_sequential(jnp.asarray(lab), 2)))


# ---- ops.subregions ------------------------------------------------------------


@pytest.fixture(scope="module")
def atlas(data):
    j = jsubregions.build_subregion_atlas(jnp.asarray(data["labels"]), 4,
                                          (8, 8, 4), 2)
    return j, _atlas_to_torch(j)


@pytest.mark.parametrize("out_of_range", ["clip", "drop"])
@pytest.mark.parametrize("overlap_mode", ["add", "last"])
def test_move_cells_full_modes(atlas, overlap_mode, out_of_range):
    """Cells moved onto each other and past the canvas, one left out."""
    j, t = atlas
    # cell 1 onto cell 2, cell 3 past the canvas, cell 4 left out
    mv = np.array([[0, 12, 2], [1, -1, 0], [-25, 2, -12], [2, 30, 1]],
                  np.int32)
    include = np.array([True, True, True, False])
    want = jsubregions.move_cells_full(j, jnp.asarray(mv),
                                       jnp.asarray(include), overlap_mode,
                                       out_of_range)
    got = subregions.move_cells_full(t, T(mv), T(include), overlap_mode,
                                     out_of_range)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].max()) > 1                 # an overlap
    with pytest.raises(ValueError):
        subregions.move_cells_full(t, T(mv), T(include), "max")


# ---- ops.neighborhood, ops.rays ------------------------------------------------


@pytest.mark.parametrize("include_self", [False, True])
def test_neighbor_reductions(data, include_self):
    x = data["image"]
    for name, conn in (("neighbor_max", 1), ("neighbor_min", 3)):
        want = getattr(jneighborhood, name)(jnp.asarray(x), conn,
                                            include_self=include_self)
        got = getattr(neighborhood, name)(T(x), conn,
                                          include_self=include_self)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    offsets = [(1, 0, 0), (0, -2, 1)]
    v = data["values"]
    want = jneighborhood.neighbor_reduce(jnp.asarray(v), offsets, -1,
                                         jnp.maximum, include_self)
    got = neighborhood.neighbor_reduce(T(v), offsets, -1, torch.maximum,
                                       include_self)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rays_volume_weights():
    r = rays.rays_golden_spiral(40, (2.0, 1.0, 1.0))
    got = rays.rays_volume_weights(r)
    want = jrays.rays_volume_weights(r)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---- ops.nms -------------------------------------------------------------------


@pytest.mark.parametrize("n_samples,n_fracs", [(32, 2), (128, 8)])
def test_overlap_matrix_sampling(n_samples, n_fracs):
    rng = np.random.RandomState(2)
    k = 24
    centers = np.stack([rng.randint(1, 7, k), rng.randint(2, 30, k),
                        rng.randint(2, 22, k)], 1).astype(np.float32)
    dists = (rng.rand(k, 32) * 3 + 1.5).astype(np.float32)
    prob = rng.rand(k).astype(np.float32)
    valid = rng.rand(k) < 0.9
    r = rays.rays_golden_spiral(32, (4.0, 1, 1))
    for limit in (0, 8):
        want = jnms.overlap_matrix(
            jnp.asarray(centers), jnp.asarray(dists), jnp.asarray(r),
            jnp.asarray(valid), n_samples, n_fracs, limit,
            jnp.asarray(prob))
        got = nms.overlap_matrix(T(centers), T(dists), T(r), T(valid),
                                 n_samples, n_fracs, limit, T(prob))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=OVERLAP_ATOL)


# ---- chunked star_dist3d and ffn_pair_scores ----------------------------------


@pytest.mark.parametrize("ray_chunk", [1, 5, 16])
def test_star_dist3d_ray_chunk(data, ray_chunk):
    """Ignored, as JAX ignores it: equal to the one-pass march and to
    JAX's."""
    lab = data["labels"].transpose(2, 0, 1).copy()        # (z, y, x)
    r = rays.rays_golden_spiral(24, (2.0, 1.0, 1.0))
    whole = stardist_gt.star_dist3d(T(lab), r, 10, 0)
    got = stardist_gt.star_dist3d(T(lab), r, 10, ray_chunk)
    assert torch.equal(got, whole)
    want = np.asarray(jgt.star_dist3d(jnp.asarray(lab), r, 10, ray_chunk))
    np.testing.assert_array_equal(got.numpy(), want)
    grid = stardist_gt.star_dist3d(T(lab), r, 10, ray_chunk, grid=(1, 2, 2))
    assert torch.equal(grid, whole[:, ::2, ::2])


@pytest.mark.parametrize("row_chunk", [1, 7, 64])
def test_ffn_pair_scores_row_chunk(row_chunk):
    (jp, js), (tp, ts) = ffn_pair()
    rng = np.random.RandomState(5)
    f1 = rng.randn(23, 61).astype(np.float32)
    f2 = rng.randn(19, 61).astype(np.float32)
    whole = ffn.ffn_pair_scores(tp, ts, T(f1), T(f2))
    got = ffn.ffn_pair_scores(tp, ts, T(f1), T(f2), row_chunk)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                               atol=SCORE_ATOL)
    want = np.asarray(jffn.ffn_pair_scores(jp, js, jnp.asarray(f1),
                                           jnp.asarray(f2), row_chunk))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCORE_ATOL)
    # with a member axis, each member chunked alike
    fe = np.stack([f1, f1[::-1].copy()])
    stacked = ffn.ffn_pair_scores(tp, ts, T(fe), T(fe), row_chunk)
    np.testing.assert_allclose(
        stacked.numpy(), ffn.ffn_pair_scores(tp, ts, T(fe), T(fe)).numpy(),
        rtol=0, atol=SCORE_ATOL)


# ---- the initialisers --------------------------------------------------------


def test_initialisers_match_jax_s_trees():
    """Shapes, dtypes and glorot bounds; the numbers cannot match across
    frameworks."""
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for use_bias in (True, False):
        got = layers.init_conv3d(g, (3, 3, 1), 4, 6, use_bias,
                                 device="cpu")
        want = JL.init_conv3d(key, (3, 3, 1), 4, 6, use_bias)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        got = layers.init_dense(g, 5, 7, use_bias, device="cpu")
        want = JL.init_dense(key, 5, 7, use_bias)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    limit = np.sqrt(6.0 / (40 + 30))
    w = layers.glorot_uniform(g, (40, 30), 40, 30, torch.float64,
                              device="cpu")
    assert w.dtype == torch.float64 and tuple(w.shape) == (40, 30)
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > \
        0.9 * limit and abs(float(w.mean())) < 0.1 * limit
    for got, want in zip(layers.init_bn(9, device="cpu"), JL.init_bn(9)):
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            assert got[k].dtype == torch.float32
    params, state = ffn.FFN(5, 16).init(g, device="cpu")
    jparams, jstate = jffn.FFN(5, 16).init(key)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    (jparams, jstate))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                  (params, state)) == shapes
    assert ffn.State == jffn.State


# ---- engine: the fused steps, labels_u8, xp -----------------------------------


@pytest.fixture(scope="module")
def track_scene(tmp_path_factory):
    _, centers, lab = recording(3)
    jt = JTransformer(tmp_path_factory.mktemp("res"), VOXEL_SIZE)
    jt.load_segmentation_array(lab)
    jt.interpolate(INTERP)
    return centers, jt


def test_fused_track_twins_match_jax(track_scene):
    """``fused_track_from_seg`` and ``fused_track_and_correct`` under
    JAX's names, argument lists and return values (coords to 1e-3 real
    units, the f32 EM's bound; labels exactly, in JAX's dtypes)."""
    centers, jt = track_scene
    (jp, js), (tp, ts) = ffn_pair()
    p1, k1, _ = _seg_candidates(centers[1], seed=1)
    p2, k2, prob = _seg_candidates(centers[2], seed=2)
    raw = np.asarray(jt.coord_vol1.raw_f32)
    shape = jt.proofed_segmentation.shape
    tatlas = _atlas_to_torch(jt.atlas)
    vs = np.float32(VOXEL_SIZE)
    args = (VOXEL_SIZE, shape, 3.0, 3.0)
    want = jpipeline.fused_track_from_seg(
        jp, js, jnp.asarray(raw), jnp.asarray(raw), jnp.asarray(p1),
        jnp.asarray(k1), jnp.asarray(p2), jnp.asarray(k2),
        jnp.asarray(prob), jt.atlas, *args, prob_grid=(1, 2, 2), pad_n=64)
    got = pipeline.fused_track_from_seg(
        tp, ts, T(raw), T(raw), T(p1), T(k1), T(p2), T(k2), T(prob),
        tatlas, *args, prob_grid=(1, 2, 2), pad_n=64)
    np.testing.assert_allclose(got[0].numpy() * vs, np.asarray(want[0]) * vs,
                               atol=COORD_TOL)
    assert got[1].dtype == torch.uint16
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # from padded point sets, in ensemble mode, u8 labels
    sets = [pipeline.seg_candidates_to_padded_real(T(p), T(k), 64,
                                                   VOXEL_SIZE)
            for p, k in ((p1, k1), (p2, k2))]
    grid_prob = prob.transpose(1, 2, 0).copy()
    want = jpipeline.fused_track_and_correct(
        jp, js, jnp.asarray(raw), jnp.asarray(raw),
        *[jnp.asarray(a.numpy()) for s in sets for a in s],
        jnp.asarray(grid_prob), jt.atlas, *args, True,
        prob_grid=(1, 2, 2), labels_u8=True)
    got = pipeline.fused_track_and_correct(
        tp, ts, T(raw), T(raw), *[a for s in sets for a in s],
        T(grid_prob), tatlas, *args, True, prob_grid=(1, 2, 2),
        labels_u8=True)
    np.testing.assert_allclose(got[0].numpy() * vs, np.asarray(want[0]) * vs,
                               atol=COORD_TOL)
    assert got[1].dtype == torch.uint8
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_legacy_correction_and_render_labels_u8(atlas_case):  # noqa: F811
    atlas, tatlas, weights, tracked_t0, n = atlas_case
    i_disp0 = (np.arange(n * 3).reshape(n, 3) % 3 - 1).astype(np.int32)
    include = np.ones(n, bool)
    want = jax.device_get(jlegacy.legacy_correction_and_render(
        atlas, weights, i_disp0, include, tracked_t0, Z_XY_RATIO,
        Z_SCALING, max_repetition=5, labels_u8=True))
    got = legacy.legacy_correction_and_render(
        tatlas, T(weights), T(i_disp0), T(include), T(tracked_t0),
        Z_XY_RATIO, Z_SCALING, max_repetition=5, labels_u8=True)
    assert got[2].dtype == torch.uint8 and want[2].dtype == np.uint8
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_upsample_prob_pipeline_xp():
    """numpy in, numpy out (JAX's ``xp=np``); torch in, torch out."""
    prob = np.random.RandomState(1).rand(5, 7, 4).astype(np.float32)
    grid, out_shape = (2, 2, 3), (9, 20, 7)
    want = jupsample(prob, grid, out_shape, xp=np)
    for xp in (None, np):
        got = upsample_prob_pipeline(prob, grid, out_shape, xp)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
    for xp in (None, torch):
        got = upsample_prob_pipeline(T(prob), grid, out_shape, xp)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)


def test_save_merged_labels_takes_the_tree(tmp_path):
    """JAX's parameters: a ``ResultsTree`` writes what its root does."""
    from t3dct_torch import viz
    from t3dct_torch.io.artifacts import (MERGED_LABELS, MERGED_LABELS_XZ,
                                          TRACK_RESULTS, ResultsTree)
    from t3dct_torch.io.imageio import save_label_slices
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 50000, (12, 10, 3)).astype(np.uint16)
    save_label_slices(raw, tmp_path / "raw", "raw_t%03i_z%04i.tif", 1,
                      use_8_bit=False, compression=None)
    pattern = str(tmp_path / "raw" / "raw_t%03i_z*.tif")
    lab = rng.randint(0, 5, (12, 10, 3)).astype(np.int32)
    viz.save_merged_labels(ResultsTree(tmp_path / "tree"), lab, pattern, 1,
                           2)
    viz.save_merged_labels(tmp_path / "root", lab, pattern, 1, 2)
    for sub, name in ((MERGED_LABELS, "merged_labels_t000001.png"),
                      (MERGED_LABELS_XZ, "merged_labels_xz_t000001.png")):
        a = tmp_path / "tree" / TRACK_RESULTS / sub / name
        b = tmp_path / "root" / TRACK_RESULTS / sub / name
        assert a.read_bytes() == b.read_bytes()


# ---- parallel.mesh -------------------------------------------------------------


def test_make_mesh_devices(tmp_path):
    """``devices``: the global ranks of the mesh, JAX's device list; too
    few raise ``ValueError`` as JAX's does."""
    import torch.distributed as dist
    from t3dct_torch.config import MeshConfig
    from t3dct_torch.parallel.mesh import make_mesh, make_mesh_from_config
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, [0], ("a", "b"), device_type="cpu")
        assert mesh.mesh.tolist() == [[0]]
        assert mesh.mesh_dim_names == ("a", "b")
        mesh = make_mesh_from_config(MeshConfig(), [0], device_type="cpu")
        assert mesh.mesh.tolist() == [[0]]
        with pytest.raises(ValueError):
            make_mesh(2, 1, [0], device_type="cpu")
        with pytest.raises(ValueError):
            make_mesh(1, 1, [3], device_type="cpu")
    finally:
        dist.destroy_process_group()
