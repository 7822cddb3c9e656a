"""The rest of the v1.0 public API the port carries (``ROADMAP.md`` A.10),
each name against its JAX twin on the CPU: the transformer's
``move_cells`` / ``move_cells_in_3d_image`` with
``ops.subregions.move_cells_full``; ``Coordinates.from_interp``, ``make``,
``interp_f32``, ``with_raw`` and ``+`` / ``-``; the trackerlite
normalizers; ``prgls_quick``; ``uniform_filter``; the point-set
normalization's apply and invert; ``imwrite_volume``;
``save_arrays_to_folder`` and ``save_auto_seg_vol1``; and the exports.

Integer and label results are held exactly; float32 results to 1e-6
unless a test says otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch
from t3dct.coordinates import Coordinates as JCoordinates
from t3dct.engine.stardist import save_arrays_to_folder as j_save_arrays
from t3dct.engine.stardist import save_auto_seg_vol1 as j_save_auto
from t3dct.engine.transformer import CoordsToImageTransformer as JTransformer
from t3dct.io.imageio import imread_volume as j_imread_volume
from t3dct.io.imageio import imwrite_volume as j_imwrite_volume
from t3dct.ops import filters as jfilters
from t3dct.ops import matching as jmatching
from t3dct.ops import pointset as jpointset
from t3dct.ops.matching import simple_match as j_simple_match
from t3dct.ops.prgls import prgls_quick as j_prgls_quick
from t3dct.ops.subregions import move_cells_full as j_move_full
from t3dct_torch.coordinates import Coordinates
from t3dct_torch.engine.stardist import (save_arrays_to_folder,
                                         save_auto_seg_vol1)
from t3dct_torch.engine.transformer import CoordsToImageTransformer
from t3dct_torch.io.imageio import imread_stack, imread_volume, \
    imwrite_volume
from t3dct_torch.ops import filters, matching, pointset, prgls
from t3dct_torch.ops.subregions import SubregionAtlas, move_cells_full
from test_torch_scene import INTERP, VOXEL_SIZE, recording


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def transformers(tmp_path_factory):
    """JAX's interpolated transformer, and the port's holding JAX's atlas
    (the atlas build is held by ``tests/test_torch_tracking.py``)."""
    _, _, lab = recording(2, seed=0)
    jt = JTransformer(tmp_path_factory.mktemp("jax"), VOXEL_SIZE)
    jt.load_segmentation_array(lab)
    jt.interpolate(INTERP)
    tt = CoordsToImageTransformer(None, VOXEL_SIZE, device="cpu")
    tt.load_segmentation_array(lab)
    a = jt.atlas
    tt.atlas = SubregionAtlas(T(a.boxes), T(a.origins), T(a.valid),
                              a.interpolation_factor, a.image_shape)
    tt.interpolation_factor = INTERP
    return jt, tt


def _movements(n, seed, spread=6):
    return np.random.RandomState(seed).randint(
        -spread, spread + 1, (n, 3)).astype(np.int32)


@pytest.mark.parametrize("full_resolution", [False, True])
def test_move_cells_matches_jax(transformers, full_resolution):
    jt, tt = transformers
    mv = _movements(jt.atlas.n_cells, 1)
    for movements, missed in ((None, None), (mv, {2, 5, 99})):
        want = jt.move_cells(movements, missed, full_resolution)
        got = tt.move_cells(movements, missed, full_resolution)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_move_cells_in_3d_image_matches_jax(transformers):
    jt, tt = transformers
    mv = _movements(jt.atlas.n_cells, 2)
    got = tt.move_cells_in_3d_image(mv, {3})
    want = jt.move_cells_in_3d_image(mv, {3})
    assert got.shape == jt.proofed_segmentation.shape
    np.testing.assert_array_equal(got, want)


def test_move_cells_full_clips_far_moves(transformers):
    """Movements that push cells past the padded canvas: JAX's default
    clamp."""
    jt, tt = transformers
    mv = _movements(jt.atlas.n_cells, 3, spread=40)
    include = np.random.RandomState(4).rand(jt.atlas.n_cells) < 0.9
    want = j_move_full(jt.atlas, jnp.asarray(mv), jnp.asarray(include))
    got = move_cells_full(tt.atlas, T(mv), T(include))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_coordinates_frames_match_jax():
    pts = np.random.RandomState(5).rand(9, 3).astype(np.float32) * 40
    for dtype in ("raw", "real", "interp"):
        got = Coordinates.make(pts, INTERP, VOXEL_SIZE, dtype, device="cpu")
        want = JCoordinates.make(pts, INTERP, VOXEL_SIZE, dtype)
        np.testing.assert_allclose(got.raw_f32.numpy(),
                                   np.asarray(want.raw_f32), rtol=1e-6)
        np.testing.assert_allclose(got.interp_f32.numpy(),
                                   np.asarray(want.interp_f32), rtol=1e-6)
        np.testing.assert_array_equal(got.interp.numpy(),
                                      np.asarray(want.interp))
    got = Coordinates.from_interp(pts, INTERP, VOXEL_SIZE, device="cpu")
    want = JCoordinates.from_interp(pts, INTERP, VOXEL_SIZE)
    np.testing.assert_array_equal(got.raw_f32.numpy(),
                                  np.asarray(want.raw_f32))


def test_coordinates_algebra_checks_the_frame():
    rng = np.random.RandomState(6)
    a_np, b_np = (rng.rand(7, 3).astype(np.float32) * 20 for _ in range(2))
    a = Coordinates.from_raw(a_np, INTERP, VOXEL_SIZE, device="cpu")
    b = Coordinates.from_raw(b_np, INTERP, VOXEL_SIZE, device="cpu")
    ja = JCoordinates.from_raw(a_np, INTERP, VOXEL_SIZE)
    jb = JCoordinates.from_raw(b_np, INTERP, VOXEL_SIZE)
    np.testing.assert_array_equal((a + b).raw_f32.numpy(),
                                  np.asarray((ja + jb).raw_f32))
    np.testing.assert_array_equal((a - b).raw_f32.numpy(),
                                  np.asarray((ja - jb).raw_f32))
    moved = a.with_raw(b_np)
    assert moved.interpolation_factor == INTERP
    assert moved.voxel_size == tuple(VOXEL_SIZE)
    np.testing.assert_array_equal(moved.raw_f32.numpy(), b_np)
    for other in (Coordinates.from_raw(b_np, INTERP + 1, VOXEL_SIZE,
                                       device="cpu"),
                  Coordinates.from_raw(b_np, INTERP, (1, 1, 1),
                                       device="cpu")):
        with pytest.raises(ValueError, match="frame mismatch"):
            a + other
        with pytest.raises(ValueError, match="frame mismatch"):
            a - other


def test_similarity_normalizers_match_jax():
    rng = np.random.RandomState(7)
    sim = rng.rand(12, 9).astype(np.float32)
    sim[3, 4] = sim[7, 1] = 0.99              # clear matches to peel
    np.testing.assert_array_equal(
        matching.non_max_suppression_normalize(T(sim), 0.5).numpy(),
        np.asarray(jmatching.non_max_suppression_normalize(
            jnp.asarray(sim), 0.5)))
    np.testing.assert_allclose(
        matching.softmax_normalize(T(sim)).numpy(),
        np.asarray(jmatching.softmax_normalize(jnp.asarray(sim))),
        rtol=1e-6)
    np.testing.assert_allclose(
        matching.row_wise_normalize(T(sim)).numpy(),
        np.asarray(jmatching.row_wise_normalize(jnp.asarray(sim))),
        rtol=1e-6)


def test_prgls_quick_matches_jax(monkeypatch):
    """The single-reference EM: JAX's iteration count, and the moved
    points within the f32 EM's 1e-3 (``tests/test_torch_tracking.py``'s
    bound, normalized units)."""
    rng = np.random.RandomState(8)
    ref = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    tgt = (ref * 1.05 + 0.02 * rng.randn(30, 3)).astype(np.float32)
    tgt = tgt[rng.permutation(30)]
    d2 = ((tgt[:, None] - ref[None]) ** 2).sum(-1)
    prior, _ = j_simple_match(jnp.asarray(np.exp(-d2 / 0.01)), 0.1)
    want = j_prgls_quick(prior, jnp.asarray(tgt), jnp.asarray(ref))
    monkeypatch.setattr(prgls, "CHECK_EVERY", 5)
    got = prgls.prgls_quick(T(prior), T(tgt), T(ref))
    assert int(got.n_iterations) == int(want.n_iterations)
    np.testing.assert_allclose(got.tracked.numpy(), np.asarray(want.tracked),
                               atol=1e-3)
    np.testing.assert_allclose(got.tracked.numpy(),
                               got.moved_ref.numpy(), atol=0)


@pytest.mark.parametrize("mode", ["reflect", "zero"])
def test_uniform_filter_matches_jax(mode):
    x = np.random.RandomState(9).rand(6, 9, 11).astype(np.float32)
    size = (3, 5, 2)
    want = np.asarray(jfilters.uniform_filter(jnp.asarray(x), size, mode))
    got = filters.uniform_filter(T(x), size, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if mode == "reflect":     # scipy's, for odd sizes (even ones centre
        import scipy.ndimage as ndi     # as scipy's convolve does)
        odd = (3, 5, 3)
        np.testing.assert_allclose(
            filters.uniform_filter(T(x), odd).numpy(),
            ndi.uniform_filter(x, odd), atol=1e-6)


def test_point_normalization_apply_and_invert():
    pts = np.random.RandomState(10).rand(20, 3).astype(np.float32) * 50
    norm, (mean, scale) = pointset.normalize_points(T(pts))
    again = pointset.apply_normalization(T(pts), mean, scale)
    np.testing.assert_array_equal(again.numpy(), norm.numpy())
    jmean, jscale = jnp.asarray(mean.numpy()), jnp.asarray(scale.numpy())
    np.testing.assert_array_equal(again.numpy(), np.asarray(
        jpointset.apply_normalization(jnp.asarray(pts), jmean, jscale)))
    back = pointset.invert_normalization(norm, mean, scale)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jpointset.invert_normalization(jnp.asarray(norm.numpy()), jmean,
                                       jscale)))
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("compression", [None, "tiff_lzw"])
def test_imwrite_volume_both_ways(tmp_path, dtype, compression):
    """A multi-page TIFF written by the port reads back in JAX's reader
    and the port's, and JAX's file in the port's."""
    top = 250 if dtype == np.uint8 else 60000
    vol = (np.random.RandomState(11).rand(5, 33, 47) * top).astype(dtype)
    imwrite_volume(str(tmp_path / "p.tif"), vol, compression=compression)
    j_imwrite_volume(str(tmp_path / "j.tif"), vol, compression=compression)
    for got in (j_imread_volume(str(tmp_path / "p.tif")),
                imread_volume(str(tmp_path / "p.tif")),
                imread_volume(str(tmp_path / "j.tif"))):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, vol)
    imwrite_volume(str(tmp_path / "s.tif"), vol[0])
    np.testing.assert_array_equal(imread_volume(str(tmp_path / "s.tif")),
                                  vol[0])
    with pytest.raises(ValueError, match="compression"):
        imwrite_volume(str(tmp_path / "x.tif"), vol, compression="zip")


def test_seg_helpers_write_jax_files(tmp_path):
    rng = np.random.RandomState(12)
    arrays = [rng.rand(n, 3) for n in (4, 7)]
    save_arrays_to_folder(arrays, tmp_path / "p")
    j_save_arrays(arrays, tmp_path / "j")
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        ["coords0001.npy", "coords0002.npy"]
    for name in ("coords0001.npy", "coords0002.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "p" / name),
                                      np.load(tmp_path / "j" / name))
    labels = rng.randint(0, 300, (20, 16, 5)).astype(np.int32)
    save_auto_seg_vol1(labels, tmp_path / "p")
    j_save_auto(labels, tmp_path / "j")
    names = [sorted(p.name for p in (tmp_path / s / "auto_vol1").iterdir())
             for s in ("p", "j")]
    assert names[0] == names[1] and len(names[0]) == 5
    got, want = (imread_stack(sorted((tmp_path / s / "auto_vol1").glob(
        "*.tif"))) for s in ("p", "j"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.transpose(1, 2, 0), labels)


def test_exported_where_jax_exports_them():
    import t3dct
    for name in ("uniform_filter", "non_max_suppression_normalize",
                 "softmax_normalize", "row_wise_normalize", "prgls_quick",
                 "move_cells_full"):
        assert name in t3dct.ops.__all__
        assert name in t3dct_torch.ops.__all__
        assert callable(getattr(t3dct_torch.ops, name))
    assert t3dct_torch.Coordinates is Coordinates
