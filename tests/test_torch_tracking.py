"""Vol-1 interpolation and the tracking step of the port against the JAX
package, on the CPU, with the same weights and inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import t3dct_torch  # noqa: F401
from t3dct.engine.correction import accurate_correction_loop as jcorrect
from t3dct.engine.correction import get_cells_on_boundary as jboundary
from t3dct.engine.pipeline import fused_track_from_seg
from t3dct.engine.pipeline import seg_candidates_to_padded_real as jpad
from t3dct.engine.tracker import track_step as jtrack_step
from t3dct.engine.transformer import CoordsToImageTransformer as JTransformer
from t3dct.models.ffn import ffn_apply as jffn_apply
from t3dct.models.ffn import ffn_pair_scores as jscores
from t3dct.ops.knn import knn_feature_vectors as jfeatures
from t3dct.ops.matching import simple_match as jsimple_match
from t3dct.ops.pointset import normalize_points as jnormalize
from t3dct.ops.prgls import prgls_with_two_ref as jprgls
from t3dct.ops.subregions import move_cells_sampled as jmove
from t3dct_torch.engine import correction
from t3dct_torch.engine.correction import (accurate_correction_loop,
                                           get_cells_on_boundary)
from t3dct_torch.engine.pipeline import (seg_candidates_to_padded_real,
                                         track_from_seg)
from t3dct_torch.engine.tracker import track_step
from t3dct_torch.engine.transformer import CoordsToImageTransformer
from t3dct_torch.models.ffn import ffn_apply, ffn_pair_scores
from t3dct_torch.ops.knn import knn_feature_vectors
from t3dct_torch.ops.matching import simple_match
from t3dct_torch.ops.pointset import normalize_points
from t3dct_torch.ops import prgls
from t3dct_torch.ops.prgls import prgls_with_two_ref
from t3dct_torch.ops.subregions import SubregionAtlas, move_cells_sampled
from test_torch_scene import INTERP, SHAPE, VOXEL_SIZE, ffn_pair, recording

# corrected coords (after the correction loop, which snaps to
# prob-weighted centres): 1e-3 real units
COORD_TOL = 1e-3
# raw PR-GLS output: the f32 EM amplifies rounding noise through its
# M-step solve (cond ~1e5 at the solve floor); a 1-ulp change of one input
# moves the JAX result itself by 2.1e-3 real units on this scene, so the
# two frameworks' summation orders cannot agree closer than that
EM_TOL = 1e-2


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    vols, centers, lab = recording(3)
    jt = JTransformer(tmp_path_factory.mktemp("res"), VOXEL_SIZE)
    jt.load_segmentation_array(lab)
    jt.interpolate(INTERP)
    tt = CoordsToImageTransformer(VOXEL_SIZE, device="cpu")
    tt.load_segmentation_array(lab)
    tt.interpolate(INTERP)
    return dict(centers=centers, jt=jt, tt=tt, ffn=ffn_pair())


def _seg_candidates(centers_zyx, k=40, seed=0):
    """Seg-program-like outputs from true centres: (points (k, 3) int32 zyx
    on the (1, 2, 2) grid, kept (k,), grid prob map (z, y/2, x/2) f16)."""
    rng = np.random.RandomState(seed)
    n = centers_zyx.shape[0]
    pts = np.round(centers_zyx / (1, 2, 2)).astype(np.int32) * (1, 2, 2)
    extra = np.stack([rng.randint(0, SHAPE[0], k - n),
                      rng.randint(0, SHAPE[1] // 2, k - n) * 2,
                      rng.randint(0, SHAPE[2] // 2, k - n) * 2], 1)
    order = rng.permutation(k)
    points = np.concatenate([pts, extra])[order].astype(np.int32)
    kept = np.concatenate([np.ones(n, bool), np.zeros(k - n, bool)])[order]
    zz, yy, xx = np.meshgrid(np.arange(SHAPE[0]),
                             np.arange(0, SHAPE[1], 2),
                             np.arange(0, SHAPE[2], 2), indexing="ij")
    prob = np.zeros(zz.shape, np.float32)
    for cz, cy, cx in centers_zyx:
        prob = np.maximum(prob, np.exp(-0.5 * (((zz - cz) / 1.3) ** 2
                                               + ((yy - cy) / 3.5) ** 2
                                               + ((xx - cx) / 3.5) ** 2)))
    return points, kept, prob.astype(np.float16)


def _atlas_to_torch(atlas):
    return SubregionAtlas(T(atlas.boxes), T(atlas.origins), T(atlas.valid),
                          atlas.interpolation_factor, atlas.image_shape)


def test_interpolate_labels_and_coords(scene):
    """Vol-1 auto-corrected labels exactly, centres to 1e-4; the atlas
    boxes agree but for voxels whose blurred value sits on the cell's
    threshold (the blur's f32 sum order differs), at most 0.1%."""
    jt, tt = scene["jt"], scene["tt"]
    np.testing.assert_array_equal(tt.auto_corrected_segmentation,
                                  jt.auto_corrected_segmentation)
    np.testing.assert_allclose(tt.coord_vol1.raw_f32.numpy(),
                               np.asarray(jt.coord_vol1.raw_f32), atol=1e-4)
    jb, tb = np.asarray(jt.atlas.boxes), tt.atlas.boxes.numpy()
    assert jb.shape == tb.shape
    assert (jb != tb).mean() <= 1e-3
    np.testing.assert_array_equal(tt.atlas.origins.numpy(),
                                  np.asarray(jt.atlas.origins))
    assert tt.coord_vol1.cell_num == 12


def test_move_cells_sampled_exact(scene):
    jt = scene["jt"]
    rng = np.random.RandomState(3)
    mv = rng.randint(-6, 7, (jt.atlas.n_cells, 3)).astype(np.int32)
    include = rng.rand(jt.atlas.n_cells) < 0.8
    jl, jo = jmove(jt.atlas, jnp.asarray(mv), jnp.asarray(include))
    tl, to = move_cells_sampled(_atlas_to_torch(jt.atlas), T(mv), T(include))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_pad_candidates_exact(scene):
    pts, kept, _ = _seg_candidates(scene["centers"][2])
    jr, jm = jpad(jnp.asarray(pts), jnp.asarray(kept), 32, VOXEL_SIZE)
    tr, tm = seg_candidates_to_padded_real(T(pts), T(kept), 32, VOXEL_SIZE)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _padded_sets(scene, t1=1, t2=2):
    out = []
    for t in (t1, t2):
        pts, kept, _ = _seg_candidates(scene["centers"][t], seed=t)
        out.append(jpad(jnp.asarray(pts), jnp.asarray(kept), 32, VOXEL_SIZE))
    return out


def test_features_scores_match(scene):
    (jp, js), (tp, ts) = scene["ffn"]
    (r1, m1), (r2, m2) = _padded_sets(scene)
    norm, (mean, scale) = jnormalize(r1, m1)
    tnorm, (tmean, tscale) = normalize_points(T(r1), T(m1))
    np.testing.assert_allclose(tnorm.numpy(), np.asarray(norm), atol=1e-5)
    f1 = jfeatures((r1 - mean) / scale, m1, 20)
    f2 = jfeatures((r2 - mean) / scale, m2, 20)
    g1 = knn_feature_vectors((T(r1) - tmean) / tscale, T(m1), 20)
    g2 = knn_feature_vectors((T(r2) - tmean) / tscale, T(m2), 20)
    np.testing.assert_allclose(g1.numpy(), np.asarray(f1), atol=1e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(f2), atol=1e-5)
    sc = jscores(jp, js, f1, f2)
    tsc = ffn_pair_scores(tp, ts, T(f1), T(f2))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(sc), atol=1e-5)
    # the pairwise form equals the row-wise forward of the same network
    rows = np.concatenate([np.repeat(np.asarray(f1)[None], 32, 0),
                           np.repeat(np.asarray(f2)[:, None], 32, 1)],
                          axis=-1).reshape(-1, 122)
    want = np.asarray(jffn_apply(jp, js, jnp.asarray(rows))[0])
    got = ffn_apply(tp, ts, T(rows)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got.reshape(32, 32), tsc.numpy(), atol=1e-5)
    prior, pairs = jsimple_match(sc, 0.1, ref_mask=m1, tgt_mask=m2)
    tprior, tpairs = simple_match(T(sc), 0.1, ref_mask=T(m1), tgt_mask=T(m2))
    np.testing.assert_array_equal(tpairs.numpy(), np.asarray(pairs))
    np.testing.assert_array_equal(tprior.numpy(), np.asarray(prior))
    # the matching follows the cells: most true pairs are peeled
    assert np.asarray(pairs).sum() >= 8


def test_prgls_matches_same_inputs(scene, monkeypatch):
    (jp, js), _ = scene["ffn"]
    (r1, m1), (r2, m2) = _padded_sets(scene)
    conf = np.asarray(scene["jt"].coord_vol1.real)
    cn, (mean, scale) = jnormalize(jnp.asarray(conf))
    a1, a2 = (r1 - mean) / scale, (r2 - mean) / scale
    sc = jscores(jp, js, jfeatures(a1, m1, 20), jfeatures(a2, m2, 20))
    prior, _ = jsimple_match(sc, 0.1, ref_mask=m1, tgt_mask=m2)
    want = jprgls(prior, a2, a1, cn, tgt_mask=m2, ref_mask=m1)
    # stops at JAX's iteration whatever the host's check interval
    monkeypatch.setattr(prgls, "CHECK_EVERY", 5)
    got = prgls_with_two_ref(T(prior), T(a2), T(a1), T(cn), tgt_mask=T(m2),
                             ref_mask=T(m1))
    assert int(got.n_iterations) == int(want.n_iterations)
    np.testing.assert_allclose(got.tracked.numpy(), np.asarray(want.tracked),
                               atol=EM_TOL / float(scale))


def test_track_step_matches(scene):
    (jp, js), (tp, ts) = scene["ffn"]
    (r1, m1), (r2, m2) = _padded_sets(scene)
    conf = np.asarray(scene["jt"].coord_vol1.real)
    want = np.asarray(jtrack_step(jp, js, jnp.asarray(conf), r1, m1, r2, m2))
    got = track_step(tp, ts, T(conf), T(r1), T(m1), T(r2), T(m2))
    np.testing.assert_allclose(got.tracked.numpy(), want, atol=EM_TOL)


def test_correction_loop_matches(scene, monkeypatch):
    jt = scene["jt"]
    atlas = _atlas_to_torch(jt.atlas)
    _, _, prob = _seg_candidates(scene["centers"][2])
    prob_img = np.repeat(np.repeat(prob.astype(np.float32).transpose(1, 2, 0),
                                   2, 0), 2, 1)
    vol1 = np.asarray(jt.coord_vol1.raw_f32)
    rng = np.random.RandomState(4)
    start = vol1 + rng.uniform(-2, 2, vol1.shape).astype(np.float32) \
        * np.float32([1, 1, 0.2])
    real = start * np.float32(VOXEL_SIZE)
    bj = jboundary(jnp.asarray(real), jt.proofed_segmentation.shape,
                   VOXEL_SIZE)
    bt = get_cells_on_boundary(T(real), jt.proofed_segmentation.shape,
                               VOXEL_SIZE)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    jc, jl, jo, jit_ = jcorrect(jt.atlas, jnp.asarray(vol1),
                                jnp.asarray(start), jnp.asarray(prob_img), bj)
    monkeypatch.setattr(correction, "CHECK_EVERY", 3)
    tc, tl, to, tit = accurate_correction_loop(atlas, T(vol1), T(start),
                                               T(prob_img), bt)
    assert int(tit) == int(jit_)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=COORD_TOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("t2", [2, 3])
def test_track_from_seg_matches(scene, t2):
    """``fused_track_from_seg`` twin on the JAX atlas: coords to 1e-3 real
    units (f32 EM), labels exactly."""
    (jp, js), (tp, ts) = scene["ffn"]
    jt = scene["jt"]
    p1, k1, _ = _seg_candidates(scene["centers"][t2 - 1], seed=t2 - 1)
    p2, k2, prob = _seg_candidates(scene["centers"][t2], seed=t2)
    raw = np.asarray(jt.coord_vol1.raw_f32)
    cr, lab = fused_track_from_seg(
        jp, js, jnp.asarray(raw), jnp.asarray(raw), jnp.asarray(p1),
        jnp.asarray(k1), jnp.asarray(p2), jnp.asarray(k2), jnp.asarray(prob),
        jt.atlas, VOXEL_SIZE, jt.proofed_segmentation.shape, beta=3.0,
        lambda_=3.0, prob_grid=(1, 2, 2), pad_n=64)
    out = track_from_seg(tp, ts, T(raw), T(raw), T(p1), T(k1), T(p2), T(k2),
                         T(prob), _atlas_to_torch(jt.atlas), VOXEL_SIZE,
                         jt.proofed_segmentation.shape, beta=3.0,
                         lambda_=3.0, prob_grid=(1, 2, 2), pad_n=64)
    vs = np.float32(VOXEL_SIZE)
    np.testing.assert_allclose(out.corrected_raw.numpy() * vs,
                               np.asarray(cr) * vs, atol=COORD_TOL)
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(lab))
    assert int(out.prgls_iterations) > 1


def test_coordinates_views_match():
    from t3dct.coordinates import Coordinates as JC
    from t3dct_torch.coordinates import Coordinates as TC
    rng = np.random.RandomState(9)
    raw = (rng.rand(6, 3) * 40).astype(np.float32)
    vs = (1.0, 1.13, 4.7)
    j = JC.from_raw(raw, INTERP, vs)
    t = TC.from_raw(raw, INTERP, vs, device="cpu")
    for view in ("real", "interp", "raw"):
        np.testing.assert_array_equal(getattr(t, view).numpy(),
                                      np.asarray(getattr(j, view)))
    jr_ = JC.from_real(np.asarray(j.real), INTERP, vs)
    tr_ = TC.from_real(t.real, INTERP, vs, device="cpu")
    np.testing.assert_array_equal(tr_.raw_f32.numpy(),
                                  np.asarray(jr_.raw_f32))
    assert t.cell_num == 6 and t.voxel_size == vs


@pytest.mark.parametrize("case", ["singular", "rank_deficient"])
def test_m_step_solve_is_non_finite_on_a_singular_system(case):
    """Where LU meets a zero pivot, the v1.0 M-step's solve gives NaN as
    ``jnp.linalg.solve`` gives a non-finite result, and raises nothing
    (``torch.linalg.solve`` raises there)."""
    rng = np.random.RandomState(3)
    coeff = rng.rand(5, 5).astype(np.float32)
    if case == "singular":
        coeff[:, 2] = 0.0
    else:           # row 3 is twice row 1: an exact zero pivot in LU
        coeff = np.array([[1, 2, 0, 0, 0], [2, 4, 0, 0, 0], [0, 0, 1, 0, 0],
                          [0, 0, 0, 3, 1], [0, 0, 0, 1, 3]], np.float32)
    dep = rng.rand(3, 5).astype(np.float32)
    want = np.asarray(jnp.linalg.solve(jnp.asarray(coeff.T),
                                       jnp.asarray(dep.T))).T
    got = prgls.solve_m_step(T(coeff), T(dep))
    assert got.shape == (3, 5)
    assert not np.isfinite(want).all()
    assert not torch.isfinite(got).any()


def test_m_step_solve_matches_on_a_regular_system():
    rng = np.random.RandomState(4)
    coeff = (rng.rand(6, 6) + 6 * np.eye(6)).astype(np.float32)
    dep = rng.rand(3, 6).astype(np.float32)
    want = np.asarray(jnp.linalg.solve(jnp.asarray(coeff.T),
                                       jnp.asarray(dep.T))).T
    np.testing.assert_allclose(prgls.solve_m_step(T(coeff), T(dep)).numpy(),
                               want, rtol=1e-5, atol=1e-6)


def test_v1_em_reads_no_solve_status(scene, monkeypatch):
    """The v1.0 EM solves with ``solve_ex`` and reads its status on the
    device only: ``torch.linalg.solve``, which checks it on the host (a
    sync per iteration on the card), is never called."""
    (jp, js), _ = scene["ffn"]
    (r1, m1), (r2, m2) = _padded_sets(scene)
    conf = np.asarray(scene["jt"].coord_vol1.real)
    cn, (mean, scale) = jnormalize(jnp.asarray(conf))
    a1, a2 = (r1 - mean) / scale, (r2 - mean) / scale
    sc = jscores(jp, js, jfeatures(a1, m1, 20), jfeatures(a2, m2, 20))
    prior, _ = jsimple_match(sc, 0.1, ref_mask=m1, tgt_mask=m2)

    def no_solve(*args, **kwargs):
        raise AssertionError("torch.linalg.solve syncs on its status")

    monkeypatch.setattr(torch.linalg, "solve", no_solve)
    got = prgls_with_two_ref(T(prior), T(a2), T(a1), T(cn), tgt_mask=T(m2),
                             ref_mask=T(m1))
    assert torch.isfinite(got.tracked).all()
    assert int(got.n_iterations) > 1
