"""The port's U-Net trainer (``models/train_unet.py``) and the legacy
retraining (``Tracker.retrain_unet`` / ``select_unet_weights``) against
JAX's, on the CPU, with a small variant-a spec (tile (24, 24, 8)) and the
3-volume scene of ``tests/test_legacy_tracker.py``.

JAX's affines come from its PRNG stream, which torch cannot reproduce: the
tests draw JAX's (``jax_draws``, the stream of JAX's ``_train_batch``) and
hand them to the port's trainer (``_draw_affines``), so both packages train
on the same batches.  Tolerances: the warp of one image given one matrix
within ``WARP_TOL`` (both packages' float32 bilinear sums, in one order);
the warped labels exactly; a loss within ``LOSS_RTOL`` relative (the
normalized patches part by an ulp, the BatchNorms carry it); the
parameters after one Adam step within ``PARAM_RTOL`` in the norm of the
whole tree, after several within ``RUN_RTOL`` (a first Adam step moves a
weight by the sign of its gradient, and a gradient that nearly cancels
takes its sign from rounding, ``ROADMAP.md`` C.5); BatchNorm statistics
within ``STATE_TOL``."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.config import TrainUnetConfig as JTrainUnetConfig
from t3dct.models import train_unet as jtu
from t3dct.models.unet3d import UNet3D as JUNet3D
from t3dct.models.unet3d import get_unet as jget_unet
from t3dct.ops.lcn import normalize_label as jnormalize_label
from t3dct.ops.tiling import tiled_apply as jtiled_apply
from t3dct.parallel.training import make_unet_train_step
from t3dct.utils.checkpoint import load_pytree as jload
from t3dct.utils.checkpoint import save_pytree as jsave
from t3dct_torch.config import LcnConfig, TrainUnetConfig
from t3dct_torch.models import train_unet as tu
from t3dct_torch.models.unet3d import UNet3D, get_unet
from t3dct_torch.ops.lcn import normalize_label
from t3dct_torch.ops.tiling import tiled_apply
from t3dct_torch.utils.checkpoint import leaves_with_paths

from test_torch_legacy import UNET, to_jax, volume_at
from test_torch_legacy_folder import (Float32Tracker, PortFloat32Tracker,
                                      tracker_kwargs, write_folder)

WARP_TOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_RTOL = 1e-4
RUN_RTOL = 1e-3
STATE_TOL = 1e-6
NOISE = 20.0


def T(a):
    return torch.from_numpy(np.array(a))


def jax_draws(seed, batch_sizes, hw, **kw):
    """The affines JAX's ``TrainingUNet3D(seed=seed)`` draws for batches of
    ``batch_sizes`` samples: its key ``PRNGKey(seed + 1)`` split once per
    batch, the subkey split per sample, as ``_train_batch`` and
    ``augment_batch`` do."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for b in batch_sizes:
        key, sub = jax.random.split(key)
        ms, offs = jax.vmap(lambda k: jtu._affine_matrix(k, hw=hw, **kw))(
            jax.random.split(sub, b))
        out.append([(T(m), T(o)) for m, o in zip(ms, offs)])
    return out


def replay(monkeypatch, draws):
    """Make every port trainer take ``draws`` in order."""
    queue = list(draws)
    monkeypatch.setattr(tu.TrainingUNet3D, "_draw_affines",
                        lambda self, b, hw: queue.pop(0))
    return queue


def small_model():
    spec = UNet3D(**UNET)
    params, state = spec.init(torch.Generator().manual_seed(4), device="cpu")
    # non-trivial running statistics, so eval and train mode differ
    state = {k: {"mean": v["mean"] + 0.1, "var": v["var"] * 1.5}
             for k, v in state.items()}
    return spec, params, state


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_affine_2d_given_a_matrix(order, seed):
    """The warp of one (h, w) image given JAX's matrix and offset (large
    shifts reach the reflect borders), and of a (h, w, z) stack at once."""
    rng = np.random.RandomState(seed)
    img = rng.rand(37, 29).astype(np.float32) * 3
    (m, off), = jax_draws(seed, [1], (37, 29), shift_range=0.6)[0]
    want = np.asarray(jtu._apply_affine_2d(jnp.asarray(img), jnp.asarray(m),
                                           jnp.asarray(off), order))
    got = tu._apply_affine_2d(T(img), m, off, order).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_TOL)
    stack = np.stack([img, img[::-1]], axis=2)
    got3 = tu._apply_affine_2d(T(stack), m, off, order).numpy()
    np.testing.assert_allclose(got3[..., 1], np.asarray(jtu._apply_affine_2d(
        jnp.asarray(img[::-1]), jnp.asarray(m), jnp.asarray(off), order)),
        rtol=0, atol=WARP_TOL)


def test_warped_labels_are_jax_labels():
    """Labels through JAX's per-sample transform (every z layer, ``+ 1e-4``,
    truncated) and the port's, given the same draws: equal."""
    _, lab, _ = volume_at(2)
    labs = np.stack([lab[:24, :24], lab[24:, 24:], lab[12:36, 6:30]]) > 0
    labs = labs.astype(np.int32)[..., None]
    imgs = labs.astype(np.float32) * 2.5
    draws = jax_draws(0, [3], (24, 24))[0]
    x, y = tu.augment_with(T(imgs), T(labs), draws)
    for i, (m, off) in enumerate(draws):
        def warp(a):
            return jax.vmap(lambda sl: jtu._apply_affine_2d(
                sl, jnp.asarray(m.numpy()), jnp.asarray(off.numpy()), 1),
                in_axes=2, out_axes=2)(a)
        want_y = (warp(jnp.asarray(labs[i, ..., 0], jnp.float32)) + 1e-4
                  ).astype(jnp.int32)
        np.testing.assert_array_equal(y[i, ..., 0].numpy(),
                                      np.asarray(want_y))
        np.testing.assert_allclose(x[i, ..., 0].numpy(), np.asarray(
            warp(jnp.asarray(imgs[i, ..., 0]))), rtol=0, atol=WARP_TOL)
    assert y.dtype == torch.int32 and x.shape == (3, 24, 24, 8, 1)


@pytest.mark.parametrize("shape,tile", [((48, 48, 8), (24, 24, 8)),
                                        ((50, 37, 9), (24, 16, 4))])
def test_divide_img_is_jax(shape, tile):
    img = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    np.testing.assert_array_equal(tu.divide_img(img, tile),
                                  jtu.divide_img(img, tile))


def test_normalize_label_receptive_radius_tiled_apply():
    lab = np.random.RandomState(0).randint(-2, 4, (6, 5, 3))
    np.testing.assert_array_equal(normalize_label(T(lab)).numpy(),
                                  np.asarray(jnormalize_label(lab)))
    assert normalize_label(T(lab)).dtype == torch.int32
    for v in "abc":
        assert get_unet(v).receptive_radius() == \
            jget_unet(v).receptive_radius()
    assert UNet3D(**UNET).receptive_radius() == \
        JUNet3D(**UNET).receptive_radius()
    img = np.random.RandomState(1).rand(30, 21, 7).astype(np.float32)
    for tile_batch in (0, 4):
        got = tiled_apply(lambda b: b * 2 + 1, T(img), (16, 12, 4),
                          (2, 2, 1), tile_batch).numpy()
        want = np.asarray(jtiled_apply(lambda b: b * 2 + 1, jnp.asarray(img),
                                       (16, 12, 4), (2, 2, 1), tile_batch))
        np.testing.assert_array_equal(got, want)
    assert LcnConfig() == LcnConfig(5.0, (27, 27, 1), "zero")
    assert TrainUnetConfig().__dict__ == JTrainUnetConfig().__dict__


def trainers(tmp_path, monkeypatch, config=None):
    """JAX's and the port's trainer on vol 1 of the scene, from the same
    parameters; the port replays JAX's affine draws."""
    spec, params, state = small_model()
    img, lab, _ = volume_at(1)
    jt = jtu.TrainingUNet3D(NOISE, tmp_path / "jax", JUNet3D(**UNET),
                            batch_size=4, config=config)
    jt.params, jt.bn_state = to_jax(params), to_jax(state)
    jt.opt_state = jt.optimizer.init(jt.params)
    jsave((jt.params, jt.bn_state), jt.models_path / "weights_initial.npz")
    pt = tu.TrainingUNet3D(NOISE, tmp_path / "port", spec, batch_size=4,
                           config=config, device="cpu")
    pt.start_from(params, state)
    jsave((jt.params, jt.bn_state), pt.models_path / "weights_initial.npz")
    for t in (jt, pt):
        t.load_dataset_arrays(img, lab, img, lab)
        t.preprocess()
    n = jt.train_subimage.shape[0]
    replay(monkeypatch, jax_draws(0, [min(4, n)] * 64, (24, 24)))
    return jt, pt


def assert_params_close(got_tree, want_tree, rtol=PARAM_RTOL):
    """Every leaf's shape, and the whole tree within ``rtol`` in the
    norm."""
    diff = norm = 0.0
    for (path, g), w in zip(leaves_with_paths(got_tree),
                            jax.tree_util.tree_leaves(want_tree)):
        g, w = g.detach().double().numpy(), np.asarray(w, np.float64)
        assert g.shape == w.shape, path
        diff += float(np.sum((g - w) ** 2))
        norm += float(np.sum(w ** 2))
    assert np.sqrt(diff) <= rtol * np.sqrt(norm)


def test_one_step_and_validation_loss_match(tmp_path, monkeypatch):
    """The same augmented batch (JAX's draw, the same patch start): the
    loss, the parameters and the BatchNorm state after one step, and the
    validation loss before and after."""
    jt, pt = trainers(tmp_path, monkeypatch)
    # the normalization's box sums part by an ulp
    np.testing.assert_allclose(pt.train_subimage, jt.train_subimage, rtol=0,
                               atol=WARP_TOL)
    np.testing.assert_array_equal(pt.train_subcells, jt.train_subcells)
    np.testing.assert_allclose(pt.validation_loss(), jt.validation_loss(),
                               rtol=LOSS_RTOL)
    jx, jy = jt._train_batch(np.random.RandomState(5))
    px, py = pt._train_batch(np.random.RandomState(5))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=0,
                               atol=WARP_TOL)
    step = jax.jit(make_unet_train_step(jt.model, optax.adam(1e-3)))
    jp, jbn, _, jloss = step(jt.params, jt.bn_state, jt.opt_state, jx,
                             jy.astype(jnp.float32))
    loss = pt.train_step(px, py)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert_params_close(pt.params, jp)
    for g, w in zip(jax.tree_util.tree_leaves(pt.bn_state),
                    jax.tree_util.tree_leaves(jbn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=STATE_TOL)
    jt.params, jt.bn_state = jp, jbn
    np.testing.assert_allclose(pt.validation_loss(), jt.validation_loss(),
                               rtol=LOSS_RTOL)


def test_train_and_select_weights_match(tmp_path, monkeypatch):
    """``train`` (2 epochs of 3 steps, a checkpoint at each improvement)
    and ``select_weights``, with ``TrainUnetConfig``'s affine ranges."""
    cfg = JTrainUnetConfig(batch_size=4, steps_per_epoch=3,
                           rotation_range=30.0)
    jt, pt = trainers(tmp_path, monkeypatch, config=cfg)
    kw = dict(rotation_range=30.0, shift_range=0.2, shear_range=0.2,
              horizontal_flip=True)
    replay(monkeypatch, jax_draws(0, [4] * 6, (24, 24), **kw))
    want = jt.train(iteration=2, verbose=False)
    got = pt.train(iteration=2, verbose=False)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    names = [sorted(p.name for p in t.models_path.iterdir()) for t in
             (jt, pt)]
    assert names[0] == names[1]
    best = int(np.argmin(want)) + 1
    jt.select_weights(best)
    pt.select_weights(best)
    want_tree = jload((jt.params, jt.bn_state),
                      jt.models_path / "unet3_pretrained.npz")
    assert_params_close(pt.params, want_tree[0], rtol=RUN_RTOL)
    assert (pt.models_path / "unet3_pretrained.npz").is_file()


def folder_trackers(tmp_path):
    """JAX's and the port's folder ``Tracker`` on vol 1 of the scene with
    the same small U-Net, ``weights_initial.npz`` written as
    ``load_unet`` does, and the proofed labels loaded."""
    spec, params, state = small_model()
    out = []
    for name, make in (("jax", lambda kw: Float32Tracker(**kw)),
                       ("port", lambda kw: PortFloat32Tracker(
                           **kw, device="cpu"))):
        folder = write_folder(tmp_path / name, 1)
        tr = make(tracker_kwargs(1, folder))
        model = JUNet3D(**UNET) if name == "jax" else spec
        p, s = (to_jax(params), to_jax(state)) if name == "jax" else \
            (params, state)
        tr.load_unet_arrays(model, p, s)
        jsave((to_jax(params), to_jax(state)),
              Path(tr.paths.unet_weights) / "weights_initial.npz")
        tr.load_manual_seg()
        out.append(tr)
    return out


def test_retrain_unet_and_select_match(tmp_path, monkeypatch):
    """``retrain_unet`` (2 epochs of 3 steps on the proofed vol 1 with the
    touching cells' boundaries removed) on JAX's draws: the validation
    losses, the checkpoints; ``select_unet_weights`` of the best step and
    of step 0."""
    jt, pt = folder_trackers(tmp_path)
    replay(monkeypatch, jax_draws(0, [8] * 6, (24, 24)))
    want = jt.retrain_unet(iteration=2, steps_per_epoch=3, verbose=False)
    got = pt.retrain_unet(iteration=2, steps_per_epoch=3, verbose=False)
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    names = [sorted(os.listdir(t.paths.unet_weights)) for t in (jt, pt)]
    assert names[0] == names[1]
    best = int(np.argmin(want))
    for step in sorted({best, 0}):
        jt.select_unet_weights(step)
        pt.select_unet_weights(step)
        assert_params_close(pt.unet_params, jt.unet_params, rtol=RUN_RTOL)
    assert os.path.isfile(os.path.join(pt.paths.unet_weights,
                                       "unet3_retrained.npz")) == (best > 0)
    with pytest.raises(ValueError):
        pt.select_unet_weights(-1)


def test_not_ported_raise(tmp_path):
    spec, _, _ = small_model()
    with pytest.raises(NotImplementedError, match="A.5"):
        tu.TrainingUNet3D(NOISE, tmp_path, spec, mesh=object(),
                          device="cpu")
    tr = tu.TrainingUNet3D(NOISE, tmp_path, spec, device="cpu")
    for draw in (tr.draw_dataset, tr.draw_norm_dataset,
                 tr.draw_divided_train_data, tr.draw_prediction):
        with pytest.raises(NotImplementedError, match="A.9"):
            draw()
    assert (tmp_path / "models" / "weights_initial.npz").is_file()
    for sub in ("train_image", "train_label", "valid_image", "valid_label"):
        assert (tmp_path / sub).is_dir()


def test_load_dataset_reads_the_folders(tmp_path):
    img, lab, _ = volume_at(1)
    from t3dct_torch.io.imageio import save_label_slices
    spec, _, _ = small_model()
    tr = tu.TrainingUNet3D(NOISE, tmp_path, spec, device="cpu")
    for sub, vol in (("train_image", img), ("valid_image", img),
                     ("train_label", lab), ("valid_label", lab)):
        save_label_slices(vol.astype(np.uint16), tmp_path / sub,
                          "s_t%03i_z%03i.tif", 0, use_8_bit=False,
                          compression=None)
    tr.load_dataset()
    np.testing.assert_array_equal(tr.train_image, img.astype(np.uint16))
    np.testing.assert_array_equal(tr.valid_label, lab)

