"""The port's FFN trainer against the JAX package's, on the CPU: the BCE
and its clip, the synthesized batches (the same RandomState stream, kNN
features to 1e-6), five training steps from JAX's initial parameters
(losses, batchnorm state and parameters), the vol-1 segmentation route,
the checkpoints both ways and the training script."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.config import TrainFfnConfig as JTrainFfnConfig
from t3dct.models.train_ffn import DataGeneratorFFN as JGenerator
from t3dct.models.train_ffn import TrainFFN as JTrainFFN
from t3dct.models.train_ffn import bce_loss as jbce
from t3dct.utils.checkpoint import load_pytree as jload
from t3dct_torch.config import TrainFfnConfig
from t3dct_torch.io.imageio import save_label_slices
from t3dct_torch.models.train_ffn import DataGeneratorFFN, TrainFFN, bce_loss
from t3dct_torch.scripts import train_ffn as train_script
from t3dct_torch.utils.checkpoint import leaves_with_paths

# f32 sums in another order (the kNN features' distances, the batchnorm
# statistics, the dense products)
TOL = 1e-5
KNN_TOL = 1e-6


def cloud(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(n, 3) * np.array([120.0, 60.0, 25.0])


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_bce_and_its_clip_match_jax():
    """Values and gradients, with outputs exactly at the clip's bounds
    (JAX's max/min halve the gradient of a tie there)."""
    eps = np.float32(1e-7)
    p = np.array([eps, 1 - eps, 0.0, 1.0, 0.3, 0.9, 1e-9],
                 np.float32)[:, None]
    y = np.array([1, 0, 0, 1, 1, 0, 1], np.float32)[:, None]
    jv, jg = jax.value_and_grad(jbce)(jnp.asarray(p), jnp.asarray(y))
    pt = torch.from_numpy(p).requires_grad_(True)
    tv = bce_loss(pt, torch.from_numpy(y))
    tg = torch.autograd.grad(tv, pt)[0]
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("use_config", [False, True])
def test_generator_batches_match_jax(use_config):
    pts = (cloud() / 100.0).astype(np.float32)
    cfg = dict(batch_size=32, num_sets=3, affine_level=0.3,
               random_movement_level=0.002, ratio_seg_error=0.2,
               kde_bandwidth=0.05)
    jg = JGenerator(pts, seed=4, config=JTrainFfnConfig(**cfg)
                    if use_config else None)
    tg = DataGeneratorFFN(pts, seed=4, config=TrainFfnConfig(**cfg)
                          if use_config else None, device="cpu")
    n_batches = 2 * (3 * 2 * 40 // 32 if use_config else 1)
    for (xa, ya), (xb, yb), _ in zip(iter(jg), iter(tg), range(n_batches)):
        assert xb.shape == xa.shape and xb.dtype == torch.float32
        np.testing.assert_allclose(xb.numpy(), xa, rtol=KNN_TOL,
                                   atol=KNN_TOL)
        np.testing.assert_array_equal(yb.numpy(), ya)


def trainers(tmp_path, points_file, **kw):
    jt = JTrainFFN("m", points1_path=str(points_file),
                   basedir=tmp_path / "jax", **kw)
    init = jax.tree_util.tree_map(np.asarray, (jt.params, jt.bn_state))
    tt = TrainFFN("m", points1_path=str(points_file),
                  basedir=tmp_path / "port", device="cpu", **kw)
    tt.start_from(init)
    return jt, tt


def test_five_steps_match_jax(tmp_path):
    """Five steps (five one-step epochs, so each loss is a step's) from
    JAX's initial parameters and seed: losses, batchnorm running
    statistics and parameters."""
    np.savetxt(tmp_path / "pts.txt", cloud())
    jt, tt = trainers(tmp_path, tmp_path / "pts.txt", seed=3)
    np.testing.assert_allclose(tt.points_t1, jt.points_t1, rtol=1e-6,
                               atol=1e-6)
    jl = jt.train(num_epochs=5, iteration=0, verbose=False)
    tl = tt.train(num_epochs=5, iteration=0, verbose=False)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    for tree_t, tree_j in ((tt.params, jt.params),
                           (tt.bn_state, jt.bn_state)):
        got = [v.detach().numpy() for _, v in leaves_with_paths(tree_t)]
        want = [np.asarray(v) for _, v in leaves_with_paths(tree_j)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert rel(a, b) <= TOL


def test_checkpoints_both_ways(tmp_path):
    """Each epoch's weights and the final file are JAX's layout: JAX's
    ``load_pytree`` reads them; ``select_ffn_weights`` reads them back."""
    np.savetxt(tmp_path / "pts.txt", cloud())
    jt, tt = trainers(tmp_path, tmp_path / "pts.txt")
    tt.train(num_epochs=2, iteration=1, verbose=False)
    template = (jt.params, jt.bn_state)
    final = jload(template, tmp_path / "port" / "m.npz")
    for a, (_, b) in zip(jax.tree_util.tree_leaves(final),
                         leaves_with_paths((tt.params, tt.bn_state))):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    first = jload(template, tmp_path / "port" / "weights" /
                  "weights_training__epoch1.npz")
    tt.select_ffn_weights(1)
    for a, (_, b) in zip(jax.tree_util.tree_leaves(first),
                         leaves_with_paths((tt.params, tt.bn_state))):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    with pytest.raises(ValueError):
        tt.select_ffn_weights(0)


def test_segmentation_route_matches_jax(tmp_path):
    """``segmentation1_path``: the proofed vol-1 label slices, their
    centres of mass times the voxel size, normalized, as JAX's."""
    lab = np.zeros((40, 30, 6), np.int32)          # (x, y, z)
    rng = np.random.RandomState(0)
    for i in range(1, 13):
        c = rng.randint(2, [38, 28, 5])
        lab[c[0] - 2:c[0] + 2, c[1] - 2:c[1] + 2, c[2] - 1:c[2] + 1] = i
    save_label_slices(lab, tmp_path / "seg", "seg_t%04i_z%04i.tif", 1,
                      use_8_bit=False)
    pattern = str(tmp_path / "seg" / "*.tif")
    jt = JTrainFFN("m", segmentation1_path=pattern, voxel_size=(1, 1, 4.5),
                   basedir=tmp_path / "jax")
    tt = TrainFFN("m", segmentation1_path=pattern, voxel_size=(1, 1, 4.5),
                  basedir=tmp_path / "port", device="cpu")
    np.testing.assert_allclose(tt.points_t1, jt.points_t1, rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(FileNotFoundError):
        TrainFFN("m", segmentation1_path=str(tmp_path / "none" / "*.tif"),
                 basedir=tmp_path / "p2", device="cpu")
    with pytest.raises(ValueError):
        TrainFFN("m", basedir=tmp_path / "p3", device="cpu")


def test_train_ffn_script(tmp_path):
    np.savetxt(tmp_path / "pts.txt", cloud())
    losses = train_script.main([
        "--points", str(tmp_path / "pts.txt"), "--basedir",
        str(tmp_path / "ffn"), "--model-name", "f", "--epochs", "2",
        "--iterations", "2", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (tmp_path / "ffn" / "f.npz").exists()
    assert (tmp_path / "ffn" / "weights" /
            "weights_training__epoch2.npz").exists()
