"""The port's StarDist trainer and its workflow helpers against the JAX
package, on the CPU, at JAX's tiny test config (``n_rays`` 8, grid
(1, 2, 2), patch (8, 16, 16), ``tests/test_train_stardist.py``): the loss
and its gradient from converted parameters, three and more training
steps from JAX's initial parameters and seed, the model folder both ways,
``optimize_thresholds``, the training volumes' loader over multi-page
TIFFs, ``configure`` and the training script."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.config import StarDistConfig as JStarDistConfig
from t3dct.engine import metrics as jmetrics
from t3dct.engine.stardist import StarDist3D as JStarDist3D
from t3dct.engine.stardist import calculate_extents as jextents
from t3dct.engine.stardist import configure as jconfigure
from t3dct.engine.stardist import fill_label_holes as jfill
from t3dct.engine.stardist import load_training_images as jload_training
from t3dct.io.imageio import imwrite_volume
from t3dct.models.train_stardist import TrainStarDist3D as JTrainer
from t3dct_torch.config import StarDistConfig
from t3dct_torch.engine import metrics
from t3dct_torch.engine.stardist import (StarDist3D, calculate_extents,
                                         configure, fill_label_holes,
                                         load_training_images)
from t3dct_torch.io.imageio import imread_volume
from t3dct_torch.models.stardist3d import StarDist3DNet, with_intensity_path
from t3dct_torch.models.train_stardist import TrainStarDist3D
from t3dct_torch.scripts import train_stardist as train_script
from t3dct_torch.utils.checkpoint import leaves_with_paths

# f32 sums in another order: the loss, and each gradient relative in the
# norm of its tensor
TOL = 1e-5
# parameters after training steps: relative in the norm of all of them
# together, and each element within STEP_TOL of one Adam step (the
# learning rate).  Adam divides by the gradient's own scale, so a bias
# whose gradient nearly cancels between steps turns the gradients' 5e-7
# into 2e-5 of its own (tiny) norm, while staying 1e-4 of a step away
STEP_TOL = 1e-2
CFG = dict(n_rays=8, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0),
           unet_n_filter_base=4, net_conv_after_unet=8,
           train_patch_size=(8, 16, 16))


def scene(seed, shape=(8, 32, 32), n=8):
    """An image and labels of ``n`` ellipsoids (touching, some clipped)."""
    rng = np.random.RandomState(seed)
    lab = np.zeros(shape, np.int32)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    for i in range(1, n + 1):
        c = rng.randint(0, shape)
        r = rng.randint(3, 6)
        lab[((zz - c[0]) * 2) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
            <= r * r] = i
    img = (lab > 0).astype(np.float32) + 0.2 * rng.rand(*shape).astype(
        np.float32)
    return img, lab


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def trainers(tmp_path, **kw):
    """JAX's trainer and the port's from JAX's initial parameters."""
    jt = JTrainer(JStarDistConfig(**CFG), basedir=tmp_path / "jax",
                  max_dist=6, **kw)
    init = jax.tree_util.tree_map(np.asarray, jt.params)
    tt = TrainStarDist3D(StarDistConfig(**CFG), basedir=tmp_path / "port",
                         max_dist=6, device="cpu", **kw)
    tt.start_from(init)
    return jt, tt


def assert_params_close(jparams, tparams, lr):
    want = [np.asarray(v) for _, v in leaves_with_paths(jparams)]
    got = [v.detach().numpy() for _, v in leaves_with_paths(tparams)]
    assert rel(np.concatenate([g.ravel() for g in got]),
               np.concatenate([w.ravel() for w in want])) <= TOL
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= STEP_TOL * lr


@pytest.mark.parametrize("fg_weight,reg", [(1.0, 1e-4), (64.0, 1e-4),
                                           (8.0, 0.0)])
def test_loss_and_gradient_match_jax(tmp_path, fg_weight, reg):
    """The composite loss and its gradient at every parameter against
    ``jax.value_and_grad`` of JAX's ``_loss``, on one GT batch."""
    img, lab = scene(0)
    jt, tt = trainers(tmp_path, prob_fg_weight=fg_weight,
                      background_reg=reg)
    x = np.stack([img[:, :16, :16], img[:, 16:, 16:]])
    y = np.stack([lab[:, :16, :16], lab[:, 16:, 16:]])
    pg, dg = jt._make_gt(jnp.asarray(y))
    jl, jg = jax.value_and_grad(jt._loss)(jt.params, jnp.asarray(x), pg, dg)
    tpg, tdg = tt.make_gt(torch.from_numpy(y))
    np.testing.assert_array_equal(tdg.numpy(), np.asarray(dg))
    loss = tt.loss(tt.params, torch.from_numpy(x), tpg, tdg)
    grads = torch.autograd.grad(loss, tt.optimizer.params)
    assert abs(float(loss.detach()) - float(jl)) <= TOL * abs(float(jl))
    jleaves = [v for _, v in leaves_with_paths(jg)]
    for a, b in zip(grads, jleaves):
        assert rel(a.numpy(), b) <= TOL


def test_three_steps_match_jax(tmp_path):
    """Three steps from JAX's initial parameters and the same seed: the
    same patches, losses and parameters."""
    img, lab = scene(1)
    jt, tt = trainers(tmp_path, prob_fg_weight=8.0, seed=2)
    jl = jt.train([img], [lab], epochs=3, steps_per_epoch=1, verbose=False)
    tl = tt.train([img], [lab], epochs=3, steps_per_epoch=1, verbose=False)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert_params_close(jt.params, tt.params, 3e-4)
    assert jt.rng.rand() == tt.rng.rand()


def test_validation_plateau_and_keep_best_match_jax(tmp_path):
    """With validation volumes: the fixed val patches (seed 12345), the
    val losses, ReduceLROnPlateau's halving after one flat epoch and the
    best-val weights restored at the end, as JAX's loop does them."""
    img, lab = scene(2)
    vimg, vlab = scene(3)
    jt, tt = trainers(tmp_path, learning_rate=5e-2)
    kw = dict(epochs=6, steps_per_epoch=1, X_val=[vimg], Y_val=[vlab],
              lr_patience=1, n_val_batches=2, verbose=False)
    jl = jt.train([img], [lab], **kw)
    tl = tt.train([img], [lab], **kw)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    np.testing.assert_allclose(tt.val_losses, jt.val_losses, rtol=TOL)
    # the rate halved after each flat epoch; the best epoch was not last
    assert tt.learning_rate == jt.learning_rate < 5e-2
    assert int(np.argmin(tt.val_losses)) < len(tt.val_losses) - 1
    assert_params_close(jt.params, tt.params, 5e-2)


def test_model_folder_both_ways(tmp_path):
    """The port's ``save`` (through the trainer) is read by JAX's
    ``StarDist3D.load``, and JAX's by the port's load and the trainer's
    ``load``: the same numbers, config and thresholds, exactly."""
    jt, tt = trainers(tmp_path)
    with torch.no_grad():
        for p in tt.optimizer.params:
            p.add_(0.25)
    tt.save()
    jm = JStarDist3D.load(tmp_path / "port" / "stardist")
    assert jm.config == JStarDistConfig(**CFG)
    assert jm._thresholds == {"prob": 0.5, "nms": 0.3}
    for name, layer in jm.params.items():
        for k, v in layer.items():
            np.testing.assert_array_equal(
                np.asarray(v), tt.params[name][k].detach().numpy())
    jt.save()
    tt.basedir = jt.basedir
    tt.load()
    pm = StarDist3D.load(tmp_path / "jax" / "stardist", device="cpu")
    assert pm.config == StarDistConfig(**CFG)
    for name, layer in jt.params.items():
        for k, v in layer.items():
            np.testing.assert_array_equal(
                tt.params[name][k].detach().numpy(), np.asarray(v))
            np.testing.assert_array_equal(pm.params[name][k].numpy(),
                                          np.asarray(v))


def test_optimize_thresholds_matches_jax(monkeypatch):
    """The port's seeded weights with the intensity pass-through path
    (``with_intensity_path``, the same numbers in both packages): the F1
    of every grid point (recorded as each ``instance_matching`` returns
    it) and the chosen pair equal JAX's, on two validation volumes.  IoU
    0.3: the pass-through's fixed 3-voxel rays reach 0.5 on no cell."""
    cfg = StarDistConfig(**CFG)
    params = with_intensity_path(StarDist3DNet(cfg).init(
        torch.Generator().manual_seed(0), device="cpu"), cfg)
    jmodel = JStarDist3D(JStarDistConfig(**CFG), params={
        k: {s: v.numpy() for s, v in d.items()} for k, d in params.items()})
    tmodel = StarDist3D(cfg, params=params, device="cpu")
    X = [scene(5)[0], scene(4)[0]]
    Y = [scene(5)[1], scene(4)[1]]
    f1 = {"jax": [], "port": []}

    def record(module, key):
        inner = module.instance_matching

        def wrapped(*a, **kw):
            out = inner(*a, **kw)
            f1[key].append(out["f1"])
            return out
        monkeypatch.setattr(module, "instance_matching", wrapped)

    record(jmetrics, "jax")
    record(metrics, "port")
    grid = dict(prob_grid=(0.2, 0.6, 0.95), nms_grid=(0.2, 0.5),
                iou_thresh=0.3, verbose=False)
    want = jmetrics.optimize_thresholds(jmodel, X, Y, **grid)
    got = metrics.optimize_thresholds(tmodel, X, Y, **grid)
    assert got == want
    assert tmodel.thresholds == jmodel._thresholds
    assert len(f1["port"]) == len(f1["jax"]) == 12
    np.testing.assert_allclose(f1["port"], f1["jax"], rtol=1e-6, atol=1e-6)
    assert len(set(f1["port"])) > 1


def write_training_folder(root: Path, n: int, shape=(8, 32, 32)):
    """``n`` (image, label) pairs as multi-page uint16 TIFFs with matching
    names, written by the JAX package's writer (PIL): the port's codec
    reads them."""
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    for i in range(n):
        img, lab = scene(10 + i, shape)
        lab[3, 14:17, 14:17] = 0        # a hole for fill_label_holes
        lab[3, 15, 15] = 0
        imwrite_volume(str(root / "images" / f"vol{i}.tif"),
                       (img * 1000).astype(np.uint16))
        imwrite_volume(str(root / "masks" / f"vol{i}.tif"),
                       lab.astype(np.uint16), compression="tiff_lzw")
    return str(root / "images" / "*.tif"), str(root / "masks" / "*.tif")


@pytest.mark.parametrize("n", [1, 3, 8])
def test_load_training_images_matches_jax(tmp_path, n):
    """Every page of each volume, normalized, holes filled, the same
    split as JAX's loader (which reads the files with PIL)."""
    xs, ys = write_training_folder(tmp_path, n)
    want = jload_training(xs, ys, plot=False)
    got = load_training_images(xs, ys, plot=False)
    assert got[-1] == want[-1] == 1
    for a_list, b_list in zip(got[:-1], want[:-1]):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            assert a.shape == (8, 32, 32)
            np.testing.assert_array_equal(a, b)


def test_imread_volume_reads_every_page(tmp_path):
    """The trap of ``examples/train_stardist.py:33-35``: a reader of page
    0 alone would hand the trainer one z-slice per volume.  8- and 16-bit,
    plain and LZW pages, and a single page (a 2-D slice)."""
    from t3dct_torch.io.imageio import imread
    vol = np.arange(5 * 6 * 7, dtype=np.uint16).reshape(5, 6, 7) * 97
    for v, comp in ((vol, None), (vol, "tiff_lzw"),
                    ((vol % 251).astype(np.uint8), None)):
        imwrite_volume(str(tmp_path / "v.tif"), v, comp)
        got = imread_volume(tmp_path / "v.tif")
        assert got.shape == (5, 6, 7) and got.dtype == v.dtype
        np.testing.assert_array_equal(got, v)
        assert imread(tmp_path / "v.tif").shape == (6, 7)    # page 0 only
    imwrite_volume(str(tmp_path / "s.tif"), vol[:1])
    np.testing.assert_array_equal(imread_volume(tmp_path / "s.tif"), vol[0])


def write_rgb_volume(path, vol, compression=None):
    """A (z, h, w, 3) uint8 volume as a multi-page RGB TIFF written by PIL
    (chunky pages: the samples of a pixel interleaved)."""
    from PIL import Image
    frames = [Image.fromarray(z, "RGB") for z in vol]
    kwargs = {"compression": compression} if compression else {}
    frames[0].save(str(path), save_all=True, append_images=frames[1:],
                   **kwargs)


def write_chunky16(path, vol, planar=1):
    """A (z, h, w, c) uint16 volume as a multi-page TIFF of c interleaved
    16-bit samples a pixel, uncompressed, one strip a page (PIL writes no
    such file); ``planar=2`` labels the same bytes as separate planes,
    which the port's codec refuses."""
    import struct
    z, h, w, c = vol.shape
    out = bytearray(b"II*\0\0\0\0\0")
    prev = 4
    for page in vol:
        data = np.ascontiguousarray(page, "<u2").tobytes()
        data_at = len(out)
        out += data
        bits = struct.pack(f"<{c}H", *([16] * c))
        if len(bits) > 4:               # out of line: the entry's offset
            bits_at = len(out)
            out += bits
            bits = struct.pack("<I", bits_at)
        # (tag, type, count, the value field's 4 bytes)
        tags = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, c, bits),
                (259, 3, 1, 1), (262, 3, 1, 1), (273, 4, 1, data_at),
                (277, 3, 1, c), (278, 3, 1, h), (279, 4, 1, len(data)),
                (284, 3, 1, planar)]
        struct.pack_into("<I", out, prev, len(out))
        out += struct.pack("<H", len(tags))
        for tag, typ, count, value in tags:
            if isinstance(value, int):
                value = struct.pack("<HH" if typ == 3 else "<I",
                                    *((value, 0) if typ == 3 else (value,)))
            out += struct.pack("<HHI", tag, typ, count) + \
                value.ljust(4, b"\0")
        prev = len(out)
        out += b"\0\0\0\0"
    Path(path).write_bytes(bytes(out))


def test_imread_volume_reads_channels(tmp_path):
    """Pages of interleaved samples read as (z, y, x, c), as JAX's PIL read
    gives them: RGB written by PIL, plain and LZW, every page and a single
    page; 16-bit pages of two samples exactly (PIL reads 16-bit RGB as
    8-bit, so these are held to the written values); separate planes
    (``PlanarConfiguration`` 2) raise."""
    from t3dct.io.imageio import imread_volume as j_imread_volume
    rng = np.random.RandomState(5)
    rgb = rng.randint(0, 256, (4, 9, 11, 3)).astype(np.uint8)
    for comp in (None, "tiff_lzw"):
        write_rgb_volume(tmp_path / "rgb.tif", rgb, comp)
        got = imread_volume(tmp_path / "rgb.tif")
        assert got.shape == (4, 9, 11, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, rgb)
        np.testing.assert_array_equal(got,
                                      j_imread_volume(tmp_path / "rgb.tif"))
    write_rgb_volume(tmp_path / "one.tif", rgb[:1])
    np.testing.assert_array_equal(imread_volume(tmp_path / "one.tif"),
                                  j_imread_volume(tmp_path / "one.tif"))
    two = rng.randint(0, 65536, (3, 5, 7, 2)).astype(np.uint16)
    write_chunky16(tmp_path / "c16.tif", two)
    got = imread_volume(tmp_path / "c16.tif")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, two)
    write_chunky16(tmp_path / "planes.tif", two, planar=2)
    with pytest.raises(OSError, match="codec error 6"):
        imread_volume(tmp_path / "planes.tif")


def test_load_training_images_multichannel_matches_jax(tmp_path):
    """RGB training volumes: JAX's loader and the port's give equal arrays,
    each channel normalized on its own, and ``n_channel`` 3, which
    ``configure`` turns into ``n_channel_in``."""
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    for i in range(3):
        img, lab = scene(20 + i, (8, 32, 32))
        rgb = np.stack([img * 200, img[::-1] * 90, img * 40 + 30], -1)
        write_rgb_volume(tmp_path / "images" / f"vol{i}.tif",
                         rgb.clip(0, 255).astype(np.uint8))
        imwrite_volume(str(tmp_path / "masks" / f"vol{i}.tif"),
                       lab.astype(np.uint16))
    xs, ys = (str(tmp_path / d / "*.tif") for d in ("images", "masks"))
    want = jload_training(xs, ys, plot=False)
    got = load_training_images(xs, ys, plot=False)
    assert got[-1] == want[-1] == 3
    for a_list, b_list in zip(got[:-1], want[:-1]):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert got[0][0].shape == (8, 32, 32, 3)
    assert configure(got[1], got[-1]).n_channel_in == \
        jconfigure(want[1], want[-1]).n_channel_in == 3


def test_load_training_images_raises_on_mismatch(tmp_path):
    xs, ys = write_training_folder(tmp_path, 2)
    (tmp_path / "masks" / "vol1.tif").rename(tmp_path / "masks" / "x.tif")
    with pytest.raises(ValueError, match="do not match"):
        load_training_images(xs, ys, plot=False)


@pytest.mark.parametrize("max_projection", [True, False],
                         ids=["max_projection", "center_slice"])
def test_load_training_images_plots_as_jax(tmp_path, max_projection):
    """``plot=True``, JAX's default: the first volume and its labels drawn
    as JAX's loader draws them, pixel for pixel."""
    from test_torch_viz import drawn, pixels
    xs, ys = write_training_folder(tmp_path, 2)
    want, wfig = drawn(lambda: jload_training(
        xs, ys, max_projection=max_projection))
    got, gfig = drawn(lambda: load_training_images(
        xs, ys, max_projection=max_projection))
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(pixels(gfig), pixels(wfig))


def test_configure_and_extents_match_jax():
    ys = [scene(i, (16, 48, 40))[1] for i in range(3)]
    np.testing.assert_array_equal(calculate_extents(ys), jextents(ys))
    got, want = configure(ys), jconfigure(ys)
    assert json.dumps(got.__dict__, sort_keys=True) == \
        json.dumps(want.__dict__, sort_keys=True)
    lab = scene(7)[1]
    lab[2, 10:13, 10:13] = 5
    lab[2, 11, 11] = 0
    np.testing.assert_array_equal(fill_label_holes(lab), jfill(lab))


def test_train_stardist_script(tmp_path):
    """``scripts/train_stardist.py`` at a tiny size over a multi-page TIFF
    folder: it trains, tunes the thresholds and saves a folder that JAX's
    ``StarDist3D.load`` reads."""
    xs, ys = write_training_folder(tmp_path / "data", 3)
    model_dir = train_script.main([
        "--train-images", xs, "--train-labels", ys,
        "--basedir", str(tmp_path / "models"), "--model-name", "m",
        "--epochs", "1", "--steps-per-epoch", "1", "--device", "cpu"])
    assert model_dir == tmp_path / "models" / "m"
    jm = JStarDist3D.load(model_dir)
    assert jm.config.n_rays == 96
    th = json.loads((model_dir / "thresholds.json").read_text())
    assert set(th) == {"prob", "nms"}
    assert th["prob"] in (0.3, 0.4, 0.5, 0.6, 0.7)
