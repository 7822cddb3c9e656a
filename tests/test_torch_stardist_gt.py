"""The StarDist trainer's targets, data and layers in the port against the
JAX package, on the CPU: ``star_dist3d`` and ``edt_prob`` (exact), the FFN's
training features (1e-6) and synthesis (exact), the augmenter and the
patch sampler (exact), the conv's autograd Function against autograd
through the plain version (1e-5), the max-pool's gradient on ties and
train-mode batchnorm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.config import StarDistConfig as JStarDistConfig
from t3dct.models import layers as JL
from t3dct.models import synthesize as jsyn
from t3dct.models.train_stardist import TrainStarDist3D as JTrainer
from t3dct.models.train_stardist import augmenter as jaugmenter
from t3dct.ops.knn import knn_feature_vectors_cross as jcross
from t3dct.ops.stardist_gt import edt_prob as jedt_prob
from t3dct.ops.stardist_gt import star_dist3d as jstar_dist3d
from t3dct_torch.config import StarDistConfig
from t3dct_torch.models import layers as L
from t3dct_torch.models import synthesize as syn
from t3dct_torch.models.train_stardist import TrainStarDist3D, augmenter
from t3dct_torch.ops.hopper_conv import (Conv3x3x3BiasReLU,
                                         conv3x3x3_bias_relu_plain,
                                         flipped_weights)
from t3dct_torch.ops.knn import knn_feature_vectors_cross
from t3dct_torch.ops.rays import rays_golden_spiral
from t3dct_torch.ops.stardist_gt import edt_prob, ray_offsets, star_dist3d

# f32 sums in another order (XLA's, PyTorch's), relative to max |ref|
GRAD_TOL = 1e-5
KNN_TOL = 1e-6


def labels_batch(seed, shape=(8, 16, 16), n=7, b=2, aniso=2):
    """``b`` label volumes of ``n`` touching and clipped ellipsoids."""
    rng = np.random.RandomState(seed)
    out = np.zeros((b,) + shape, np.int32)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    for k in range(b):
        for i in range(1, n + 1):
            c = rng.randint(0, shape)
            r = rng.randint(2, 6)
            out[k][((zz - c[0]) * aniso) ** 2 + (yy - c[1]) ** 2
                   + (xx - c[2]) ** 2 <= r * r] = i
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_rays,max_dist,aniso", [(8, 6, (2.0, 1.0, 1.0)),
                                                   (32, 9, (1.0, 1.0, 1.0)),
                                                   (96, 12, (9.2, 1.0,
                                                             1.0))])
def test_star_dist3d_matches_jax(seed, n_rays, max_dist, aniso):
    """Every volume of the batch at full resolution and at the grid's
    voxels equals JAX's ``star_dist3d`` (and its grid slice) exactly."""
    lab = labels_batch(seed)
    rays = rays_golden_spiral(n_rays, aniso)
    full = star_dist3d(torch.from_numpy(lab), rays, max_dist).numpy()
    grid = star_dist3d(torch.from_numpy(lab), rays, max_dist,
                       grid=(1, 2, 2)).numpy()
    for k in range(lab.shape[0]):
        want = np.asarray(jstar_dist3d(jnp.asarray(lab[k]),
                                       jnp.asarray(rays), max_dist))
        np.testing.assert_array_equal(full[k], want)
        np.testing.assert_array_equal(grid[k], want[:, ::2, ::2])
    single = star_dist3d(torch.from_numpy(lab[1]), rays, max_dist).numpy()
    np.testing.assert_array_equal(single, full[1])


def test_ray_offsets_are_shared():
    """The recipe's 96 rays x 12 steps take 695 distinct offsets of 1152,
    each (ray, step) mapped to its own."""
    rays = rays_golden_spiral(96, (9.2, 1.0, 1.0))
    offsets, index = ray_offsets(rays, 12)
    assert index.shape == (96, 12)
    assert len(offsets) == 695
    assert len(np.unique(offsets, axis=0)) == len(offsets)
    want = np.round(rays.astype(np.float64)[:, None, :]
                    * np.arange(1, 13)[None, :, None])
    np.testing.assert_array_equal(offsets[index], want)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("aniso", [(2.0, 1.0, 1.0), (9.2, 1.0, 1.0)])
def test_edt_prob_matches_jax(window, aniso):
    lab = labels_batch(3)
    got = edt_prob(torch.from_numpy(lab), max_labels=512, anisotropy=aniso,
                   window=window).numpy()
    for k in range(lab.shape[0]):
        want = np.asarray(jedt_prob(jnp.asarray(lab[k]), max_labels=512,
                                    anisotropy=aniso, window=window))
        np.testing.assert_array_equal(got[k], want)


def test_edt_prob_shares_the_last_label_slot():
    """Labels above ``max_labels`` share its normalization slot, as in
    JAX."""
    lab = labels_batch(4, n=9, b=1)[0]
    got = edt_prob(torch.from_numpy(lab), max_labels=4).numpy()
    want = np.asarray(jedt_prob(jnp.asarray(lab), max_labels=4))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k", [(40, 20), (12, 20), (3, 20), (60, 5)])
def test_knn_feature_vectors_cross_matches_jax(n, k):
    rng = np.random.RandomState(n)
    base = rng.rand(n, 3).astype(np.float32)
    query = (base + 0.05 * rng.randn(n, 3)).astype(np.float32)
    for q in (base, query):
        want = np.asarray(jcross(jnp.asarray(base), jnp.asarray(q), k))
        got = knn_feature_vectors_cross(torch.from_numpy(base),
                                        torch.from_numpy(q), k).numpy()
        assert got.shape == want.shape == (n, 3 * k + 1)
        np.testing.assert_allclose(got, want, rtol=KNN_TOL, atol=KNN_TOL)


def test_synthesis_matches_jax():
    """The same RandomState stream gives the same clouds, exactly."""
    pts = np.random.RandomState(0).rand(50, 3)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(3):
        a = jsyn.affine_transform(pts, 0.2, 0.001, r1)
        b = syn.affine_transform(pts, 0.2, 0.001, r2)
        np.testing.assert_array_equal(a, b)
        (wa, ra), (wb, rb) = (jsyn.add_seg_errors(a, 0.15, 0.1, r1),
                              syn.add_seg_errors(b, 0.15, 0.1, r2))
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(jsyn.no_match_points(50, wa, r1),
                                      syn.no_match_points(50, wb, r2))
    assert r1.rand() == r2.rand()
    with pytest.raises(ValueError):
        syn.add_seg_errors(pts, 1.5)


def test_augmenter_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(4, 6, 6).astype(np.float32)
    y = (rng.rand(4, 6, 6) * 5).astype(np.int32)
    r1, r2 = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(8):
        xa, ya = jaugmenter(x, y, r1)
        xb, yb = augmenter(x, y, r2)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def _tiny(patch=(8, 16, 16)):
    kw = dict(n_rays=8, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0),
              unet_n_filter_base=4, net_conv_after_unet=8,
              train_patch_size=patch)
    return JStarDistConfig(**kw), StarDistConfig(**kw)


@pytest.mark.parametrize("fg_prob", [0.9, 1.0, 0.0])
def test_patch_sampler_matches_jax(tmp_path, fg_prob):
    """The foreground-biased sampler and its augmentation draw the same
    patches from the same seed, over two volumes of other shapes."""
    lab = labels_batch(6, shape=(12, 40, 24), n=5, b=2)
    img = [(v > 0).astype(np.float32) + 0.01 * i for i, v in enumerate(lab)]
    jcfg, tcfg = _tiny()
    jt = JTrainer(jcfg, basedir=tmp_path / "j", max_dist=6, seed=3,
                  foreground_prob=fg_prob)
    tt = TrainStarDist3D(tcfg, basedir=tmp_path / "t", max_dist=6, seed=3,
                         foreground_prob=fg_prob, device="cpu")
    for _ in range(12):
        xa, ya = jt._sample_patch(img, list(lab))
        xb, yb = tt._sample_patch(img, list(lab))
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_make_gt_matches_jax(tmp_path):
    lab = labels_batch(7)
    jcfg, tcfg = _tiny()
    jt = JTrainer(jcfg, basedir=tmp_path / "j", max_dist=6)
    tt = TrainStarDist3D(tcfg, basedir=tmp_path / "t", max_dist=6,
                         device="cpu")
    pj, dj = jt._make_gt(jnp.asarray(lab))
    pt, dt = tt.make_gt(torch.from_numpy(lab))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("c_in,c_out,relu,batch", [
    (1, 4, True, True), (4, 8, True, True), (12, 8, False, False),
    (8, 3, True, True)])
def test_conv_function_gradients_match_plain_autograd(c_in, c_out, relu,
                                                      batch):
    """dX (a SAME conv with the flipped, swapped weights through the
    router), dW and db against autograd through the plain version."""
    rng = np.random.RandomState(c_in * 10 + c_out)
    shape = ((2,) if batch else ()) + (5, 6, 7, c_in)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, c_in, c_out).astype(
        np.float32) * 0.3)
    b = torch.from_numpy(rng.randn(c_out).astype(np.float32) * 0.1)
    g = torch.from_numpy(rng.randn(*shape[:-1], c_out).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = Conv3x3x3BiasReLU.apply(*leaves, relu)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, g)
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    yr = conv3x3x3_bias_relu_plain(*ref_leaves, relu)
    want = torch.autograd.grad(yr, ref_leaves, g)
    assert torch.equal(y, yr)
    for a, r in zip(got, want):
        assert _rel(a.numpy(), r.numpy()) <= GRAD_TOL


def test_conv_function_skips_the_stem_input_gradient():
    """An input that needs no gradient (the stem's image) gets no dX."""
    x = torch.rand(1, 4, 4, 4, 1)
    w = torch.rand(3, 3, 3, 1, 8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    y = L.conv3d({"w": w, "b": b}, x, relu=True)
    assert y.grad_fn is not None
    dw, db = torch.autograd.grad(y.sum(), [w, b])
    assert dw.shape == w.shape and db.shape == b.shape
    with torch.no_grad():
        assert L.conv3d({"w": w, "b": b}, x, relu=True).grad_fn is None


def test_flipped_weights():
    w = torch.arange(3 * 3 * 3 * 2 * 5, dtype=torch.float32).reshape(
        3, 3, 3, 2, 5)
    wt = flipped_weights(w)
    assert wt.shape == (3, 3, 3, 5, 2) and wt.is_contiguous()
    assert wt[0, 1, 2, 4, 1] == w[2, 1, 0, 1, 4]


def test_conv_gradient_matches_jax():
    """``layers.conv3d`` + ReLU's gradient against JAX's
    ``lax.conv_general_dilated`` + relu under ``jax.grad``."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 6, 5, 8).astype(np.float32)
    w = (rng.randn(3, 3, 3, 8, 16) * 0.2).astype(np.float32)
    b = (rng.randn(16) * 0.1).astype(np.float32)
    g = rng.randn(2, 4, 6, 5, 16).astype(np.float32)

    def jf(x, w, b):
        return jnp.sum(jax.nn.relu(JL.conv3d({"w": w, "b": b}, x)) * g)

    want = jax.grad(jf, argnums=(0, 1, 2))(x, w, b)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    y = L.conv3d({"w": leaves[1], "b": leaves[2]}, leaves[0], relu=True)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    for a, r in zip(got, want):
        assert _rel(a.numpy(), np.asarray(r)) <= GRAD_TOL


def test_max_pool_gradient_follows_jax_on_ties():
    """A window with tied maxima sends its gradient to one element, the
    first in (z, y, x) order, as JAX's ``reduce_window`` max does."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 3, size=(2, 4, 6, 4, 3)).astype(np.float32)
    g = rng.randn(2, 2, 3, 2, 3).astype(np.float32)

    def jf(x):
        return jnp.sum(JL.max_pool3d(x, (2, 2, 2)) * g)

    want = np.asarray(jax.grad(jf)(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = L.max_pool3d(xt, (2, 2, 2))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(JL.max_pool3d(x, (2, 2, 2))))
    got = torch.autograd.grad(y, xt, torch.from_numpy(g))[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != 0).sum() == g.size


def test_batchnorm_train_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(64, 16) * 3 + 1).astype(np.float32)
    p, s = JL.init_bn(16)
    p = {"scale": jnp.asarray(rng.rand(16).astype(np.float32) + 0.5),
         "bias": jnp.asarray(rng.randn(16).astype(np.float32))}
    want, ws = JL.batchnorm(p, s, jnp.asarray(x), train=True)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    ts = {k: torch.from_numpy(np.array(v)) for k, v in s.items()}
    got, gs = L.batchnorm(tp, ts, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]),
                                   rtol=1e-6, atol=1e-6)
    eval_y = L.batchnorm(tp, ts, torch.from_numpy(x), False)
    assert isinstance(eval_y, torch.Tensor)
