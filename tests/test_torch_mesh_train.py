"""Data-parallel training on the port over a mesh of four ``gloo`` ranks on
the CPU (``tests/torch_mesh_ranks.py::train_cases``, one spawned world for
the file), held to JAX's sharded trainers over four of conftest's CPU
devices and to the port's own runs without a mesh on rank 0.

- (a) ``make_sharded_unet_train_step`` over (2, 2) and (1, 4) meshes: one
  Adam step of JAX's ``tiny_unet`` (``tests/test_parallel.py:25-31``) from
  JAX's init, against JAX's step over the same meshes and the port's step
  without a mesh, with JAX's tolerances (``tests/test_parallel.py:62-67``:
  loss ``LOSS_RTOL``, parameters and BatchNorm state ``PARAM_RTOL`` /
  ``PARAM_ATOL``), and through ``DTensor`` inputs bit for bit;
- (b) ``TrainStarDist3D(mesh=)`` over (4, 1) and (2, 2) (the spatial ranks
  replicas): 3 steps (epochs of one) from JAX's init at JAX's config
  (``tests/test_train_stardist.py:163-169``), losses within ``SD_RTOL``
  of the run without a mesh and of JAX's mesh run;
- (c) ``TrainFFN(mesh=)`` over (4, 1): 3 steps (epochs of one), losses
  within ``FFN_RTOL`` of JAX's mesh run and of the run without a mesh,
  parameters and batchnorm state within ``FFN_PARAM_RTOL`` /
  ``FFN_PARAM_ATOL`` element by element and ``FFN_NORM_TOL`` by leaf of
  both (``tests/test_train_ffn.py:88-95``); JAX's ``ValueError`` on a batch
  that does not divide by 4;
- ``TrainingUNet3D(mesh=)`` over (2, 2): ``train`` and ``select_weights``
  against the run without a mesh on the same draws;
- (d) parameters and BatchNorm state equal on every rank, bit for bit, and
  every trainer's files in the lead rank's folder alone;
- (e) two 3x3x3 convs over 4 x shards: dx, dw and db within
  ``chip_smoke.py``'s ``CONV_RTOL`` / ``CONV_ATOL`` of the unsharded
  stack's (the halo exchange's adjoint);
- (f) ``global_batch_from_local``: a ``DTensor`` whose ``full_tensor()``
  is the blocks put together;
- (g) ``ValueError`` where the batch or the tile's x does not split."""

import jax
import numpy as np
import optax
import pytest
import torch

import t3dct_torch  # noqa: F401
import torch_mesh_ranks as ranks
from t3dct.config import StarDistConfig as JStarDistConfig
from t3dct.models.train_ffn import TrainFFN as JTrainFFN
from t3dct.models.train_stardist import TrainStarDist3D as JTrainer
from t3dct.models.unet3d import UNet3D as JUNet3D
from t3dct.parallel.mesh import make_mesh as jmake_mesh
from t3dct.parallel.training import make_sharded_unet_train_step as jstep
from t3dct_torch.utils.checkpoint import leaves_with_paths
from t3dct_torch.utils.convert import (ffn_from_numpy,
                                       stardist_params_from_numpy,
                                       unet_from_numpy)
from test_torch_legacy import UNET, volume_at
from test_torch_train_unet import small_model

WORLD = 4
TINY = dict(variant="a", tile_shape=(16, 16, 4), pool=(2, 2, 1),
            down_filters=((4, 4),), up_filters=((4, 4),), head_filters=(4,))
LR = 1e-3
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
SD_CFG = dict(n_rays=8, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0),
              unet_n_filter_base=4, net_conv_after_unet=8,
              train_patch_size=(8, 16, 16))
SD_TRAINER = dict(max_dist=6, seed=0, batch_size=8)
SD_STEPS, SD_RTOL = 3, 1e-3
FFN_EPOCHS = 3                    # of one step each
# the FFN's losses (``tests/test_train_ffn.py:88``); its parameters and
# batchnorm state element by element within JAX's rtol and a hundredth of
# one Adam step (the learning rate, 1e-3), and each leaf within
# ``tests/test_torch_train_ffn.py``'s ``TOL`` in its norm.  JAX's test
# holds its own two runs to atol 1e-6; here a handful of the combine
# layer's 524288 weights have gradients near Adam's eps (|g| ~ 1e-8, where
# float32 sums in another order part by percents), so Adam's step on them
# parts by a few 1e-6
FFN_RTOL, FFN_PARAM_RTOL, FFN_PARAM_ATOL, FFN_NORM_TOL = 2e-5, 1e-4, 1e-5, \
    1e-5
CONV_RTOL, CONV_ATOL = 1e-5, 1e-6
# TrainingUNet3D over (2, 2) against the run without a mesh: validation
# losses and parameters after 4 Adam steps (the BatchNorm statistics and
# gradients summed in another order)
UNET_VAL_RTOL, UNET_PARAM_RTOL = 1e-4, 1e-3


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def unet_inputs():
    """JAX's tiny U-Net at its init and a seeded batch."""
    params, state = np_tree(JUNet3D(**TINY).init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16, 16, 4, 1).astype(np.float32)
    y = (rng.rand(4, 16, 16, 4, 1) > 0.5).astype(np.float32)
    tp, ts = unet_from_numpy(params, state, device="cpu")
    return dict(spec=TINY, params=tp, state=ts, x=torch.from_numpy(x),
                y=torch.from_numpy(y), lr=LR)


def jax_unet_steps(unet):
    """JAX's one Adam step of ``unet`` over each mesh."""
    jm = JUNet3D(**TINY)
    x, y = unet["x"].numpy(), unet["y"].numpy()
    want = {}
    for name, shape in (("2x2", (2, 2)), ("1x4", (1, 4))):
        opt = optax.adam(LR)
        step, sharding = jstep(jm, opt, jmake_mesh(*shape))
        p, s = (jax.tree_util.tree_map(lambda t: jax.numpy.asarray(
            t.numpy()), unet[k]) for k in ("params", "state"))
        p2, s2, _, loss = step(p, s, opt.init(p), jax.device_put(x, sharding),
                               jax.device_put(y, sharding))
        want[name] = {"loss": float(loss), "params": np_tree(p2),
                      "state": np_tree(s2)}
    return want


def halo_inputs():
    rng = np.random.RandomState(2)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return dict(x=t(2, 16, 6, 5, 3), w1=t(3, 3, 3, 3, 4) * 0.3, b1=t(4),
                w2=t(3, 3, 3, 4, 2) * 0.3, b2=t(2), r=t(2, 16, 6, 5, 2))


def sd_scene():
    """``tests/test_train_stardist.py:161-166``'s image and labels."""
    rng = np.random.RandomState(7)
    shape = (8, 16, 16)
    lab = np.zeros(shape, np.int32)
    lab[2:6, 4:10, 4:10] = 1
    img = (lab > 0).astype(np.float32) + rng.rand(*shape).astype(
        np.float32) * 0.1
    return img, lab


def sd_inputs(tmp):
    """JAX's StarDist trainer over a (4, 1) mesh at its init, and the
    port's inputs."""
    img, lab = sd_scene()
    jt = JTrainer(JStarDistConfig(**SD_CFG), basedir=tmp / "jsd",
                  mesh=jmake_mesh(4, 1), **SD_TRAINER)
    return jt, dict(cfg=SD_CFG, trainer=SD_TRAINER, steps=SD_STEPS,
                    img=img, lab=lab, params=stardist_params_from_numpy(
                        np_tree(jt.params), "cpu"))


def ffn_inputs(tmp):
    """JAX's FFN trainer over a (4, 1) mesh at its init
    (``tests/test_train_ffn.py:77-86``'s cloud), and the port's
    inputs."""
    pts = np.random.RandomState(7).randn(24, 3).astype(np.float32) * 0.3
    np.savetxt(tmp / "points.txt", pts)
    jt = JTrainFFN("ffn", points1_path=str(tmp / "points.txt"),
                   basedir=tmp / "jffn", seed=0, mesh=jmake_mesh(4, 1))
    tp, ts = ffn_from_numpy(*np_tree((jt.params, jt.bn_state)),
                            device="cpu")
    return jt, dict(points=str(tmp / "points.txt"), params=tp, state=ts,
                    epochs=FFN_EPOCHS)


def trainer_inputs():
    spec, params, state = small_model()
    img, lab, _ = volume_at(1)
    return dict(spec=UNET, params=params, state=state, img=img, lab=lab,
                noise=20.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results and JAX's runs (made while the world works)."""
    root = tmp_path_factory.mktemp("mesh_train")
    jsd, sd = sd_inputs(root)
    jffn, ffn = ffn_inputs(root)
    inputs = dict(unet=unet_inputs(), halo=halo_inputs(), sd=sd, ffn=ffn,
                  trainer=trainer_inputs())
    for k, v in inputs.items():
        torch.save(v, root / f"{k}.pt")
    run = ranks.World(WORLD, "train_cases", root / "w",
                      **{k: str(root / f"{k}.pt") for k in inputs})
    img, lab = sd_scene()
    want = dict(
        step=jax_unet_steps(inputs["unet"]),
        sd=jsd.train([img], [lab], epochs=SD_STEPS, steps_per_epoch=1,
                     verbose=False),
        ffn=dict(losses=jffn.train(num_epochs=FFN_EPOCHS, iteration=0,
                                   verbose=False)),
        halo=inputs["halo"], unet=inputs["unet"])
    want["ffn"].update(params=np_tree(jffn.params),
                       state=np_tree(jffn.bn_state))
    return run.results(), want


def leaves(tree):
    return [np.asarray(v, np.float64) for _, v in leaves_with_paths(tree)]


def assert_trees_close(got, want, rtol, atol):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def assert_same_on_every_rank(results, key):
    """Every rank's ``results[rank][key]`` equal to rank 0's, bit for bit
    (tensors by ``torch.equal``)."""
    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b
    for rank in range(1, WORLD):
        assert same(results[rank][key], results[0][key]), (key, rank)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_unet_step_matches_jax_and_one_rank(world, mesh):
    """(a, d)"""
    results, want = world
    got = results[0][f"step_{mesh}"]
    assert_same_on_every_rank(results, f"step_{mesh}")
    for ref in (want["step"][mesh], results[0]["step_plain"]):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
        assert_trees_close(got["params"], ref["params"], PARAM_RTOL,
                           PARAM_ATOL)
        assert_trees_close(got["state"], ref["state"], PARAM_RTOL,
                           PARAM_ATOL)


def test_dtensor_batch_and_step(world):
    """(f): ``global_batch_from_local`` of each rank's (2, 2) block is a
    ``DTensor`` sharded (data, spatial) whose full tensor is the global
    batch; the step on it equals the step on the blocks, bit for bit."""
    results, want = world
    x = want["unet"]["x"]
    for rank in range(WORLD):
        dt = results[rank]["dtensor"]
        assert torch.equal(dt["full"], x)
        assert torch.equal(dt["local"], dt["block"])
        assert dt["placements"] == ["S(0)", "S(1)"]
    assert torch.equal(torch.cat([torch.cat(
        [results[2 * d + s]["dtensor"]["block"] for s in range(2)], dim=1)
        for d in range(2)]), x)
    for rank in range(WORLD):
        got, ref = results[rank]["step_dtensor"], results[rank]["step_2x2"]
        assert got["loss"] == ref["loss"]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves_with_paths(got["params"]),
            leaves_with_paths(ref["params"])))


def test_halo_conv_gradients_match_unsharded(world):
    """(e): dx gathered and dw, db summed over 4 x shards against the
    unsharded stack's."""
    results, want = world
    ref = ranks.halo_grads_case(None, **want["halo"])
    assert_same_on_every_rank(results, "halo")
    for k, r in ref.items():
        g = results[0]["halo"][k]
        assert g.shape == r.shape, k
        err = float((g - r).abs().max())
        assert err <= CONV_RTOL * float(r.abs().max()) + CONV_ATOL, (k, err)


def test_misaligned_shapes_raise(world):
    """(g): an x shard off the pooling grid (12 over 4, the tiny U-Net's
    pool 2), an x that does not split (14 over 4), a batch of 3 over 2
    data ranks, a trainer whose tile does not split, and JAX's FFN
    ``ValueError`` (a batch of 30 over 4)."""
    results, _ = world
    errors = results[0]["errors"]
    assert "the x shard 3 (tile x 12 over 4 spatial ranks) is not a " \
        "multiple of 2" in errors["x_shard"]
    assert "the tile x size 14 must divide by the mesh axis's 4 ranks" in \
        errors["x_split"]
    assert "the batch size 3 must divide by the mesh axis's 2 ranks" in \
        errors["batch"]
    assert "is not a multiple of 2" in errors["trainer_tile"]
    assert "divide" in errors["ffn_batch"]
    assert_same_on_every_rank(results, "errors")


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_stardist_trainer_over_a_mesh(world, mesh):
    """(b, d): losses against the run without a mesh and JAX's (4, 1) mesh
    run; the same parameters on every rank; the model folder in the lead
    rank's folder alone."""
    results, want = world
    got = results[0][f"sd_{mesh}"]
    assert len(got["losses"]) == SD_STEPS
    np.testing.assert_allclose(got["losses"],
                               results[0]["sd_plain"]["losses"],
                               rtol=SD_RTOL)
    np.testing.assert_allclose(got["losses"], want["sd"], rtol=SD_RTOL)
    for rank in range(1, WORLD):
        assert results[rank][f"sd_{mesh}"]["losses"] == got["losses"]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves_with_paths(results[rank][f"sd_{mesh}"]["params"]),
            leaves_with_paths(got["params"])))
        assert results[rank][f"sd_{mesh}"]["files"] == []
    assert got["files"] == results[0]["sd_plain"]["files"] != []


def test_ffn_trainer_over_a_mesh(world):
    """(c, d): losses, parameters and batchnorm state against JAX's (4, 1)
    mesh run and the run without a mesh; the same on every rank; the
    weight files in the lead rank's folder alone."""
    results, want = world
    got, plain = results[0]["ffn_4x1"], results[0]["ffn_plain"]
    for ref in (want["ffn"], plain):
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=FFN_RTOL)
    for ref in (want["ffn"], plain):
        for key in ("params", "state"):
            assert_trees_close(got[key], ref[key], FFN_PARAM_RTOL,
                               FFN_PARAM_ATOL)
            g, w = leaves(got[key]), leaves(ref[key])
            for a, b in zip(g, w):
                assert np.linalg.norm(a - b) <= FFN_NORM_TOL * \
                    np.linalg.norm(b)
    for rank in range(1, WORLD):
        mine = results[rank]["ffn_4x1"]
        assert mine["losses"] == got["losses"]
        for key in ("params", "state"):
            assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(mine[key]), leaves_with_paths(got[key])))
        assert mine["files"] == []
    assert got["files"] == results[0]["ffn_plain"]["files"] != []


def test_unet_trainer_over_a_mesh(world):
    """``TrainingUNet3D(mesh=)`` over (2, 2): validation losses and the
    selected weights against the run without a mesh; the same on every
    rank; the weight files in the lead rank's folder alone."""
    results, _ = world
    got, ref = results[0]["unet_2x2"], results[0]["unet_plain"]
    np.testing.assert_allclose(got["val"], ref["val"], rtol=UNET_VAL_RTOL)
    g, w = leaves(got["params"]), leaves(ref["params"])
    diff = np.sqrt(sum(float(np.sum((a - b) ** 2)) for a, b in zip(g, w)))
    assert diff <= UNET_PARAM_RTOL * np.sqrt(sum(float(np.sum(b ** 2))
                                                 for b in w))
    assert_trees_close(got["state"], ref["state"], UNET_PARAM_RTOL, 1e-6)
    for rank in range(1, WORLD):
        mine = results[rank]["unet_2x2"]
        assert mine["val"] == got["val"]
        for key in ("params", "state"):
            assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_paths(mine[key]), leaves_with_paths(got[key])))
        assert mine["files"] == []
    assert got["files"] == ref["files"]
    assert "models/weights_initial.npz" in got["files"]
    assert "models/unet3_pretrained.npz" in got["files"]
