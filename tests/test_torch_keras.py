"""The reference's Keras files on the port: ``utils.keras_import`` (U-Net,
FFN and StarDist ``.h5`` checkpoints, the ``KerasGraph`` executor),
``StarDist3DNet(arch="keras")`` and the loaders that take Keras files
(``load_stardist_model`` on a reference folder, the legacy ``Tracker``'s
``load_unet`` / ``load_ffn``, ``TrackerLite``), against the JAX package on
the CPU with the same files.

Tolerances: imported trees exactly equal; ``KerasGraph`` within 1e-6;
the Keras forward within 1e-5 on prob and 1e-4 on dist, the bounds of
JAX's own TensorFlow test (``tests/test_keras_import.py``), against JAX
and against TensorFlow's forward of a file TensorFlow wrote; kept cells
and labels exactly.

The committed assets (``3deecelltracker_tpu_torch/assets/keras/``):
``sd_keras/``, the Keras topology at the bench config (96 rays, grid
(1, 2, 2), anisotropy (9.2, 1, 1)) with seeded He-scaled weights and the
pass-through path of ``with_keras_intensity_path``, written as a
reference stardist folder (``weights_best.h5``, Config3D ``config.json``,
``thresholds.json``), imported by JAX's ``load_stardist_keras_dir`` and
saved as a model folder (``config.json`` with ``"arch": "keras"`` and
``weights.npz``), which loads without ``h5py``; and
``jax_record_keras.npz``, JAX's ``bench_composition(handoff="device")``
over the 21-volume bench scene with that model (kept seg coordinates,
tracked coordinates, uint8 labels, ``tracking_id_metrics``), volume 1's
prob map and its dist at the kept cells, and TensorFlow's forward of the
``.h5`` on a crop of volume 1.  Regenerate both (JAX and TensorFlow on
the CPU) with

    python tests/test_torch_keras.py --write
"""

import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from test_keras_import import write_keras2_h5  # noqa: E402
from test_torch_scene import REPO, jax_script  # noqa: E402

import t3dct_torch  # noqa: E402,F401
from t3dct.config import StarDistConfig as JStarDistConfig  # noqa: E402
from t3dct.engine.stardist import StarDist3D as JStarDist3D  # noqa: E402
from t3dct.models.stardist3d import StarDist3DNet as JNet  # noqa: E402
from t3dct.utils import keras_import as jk  # noqa: E402
from t3dct_torch.config import StarDistConfig  # noqa: E402
from t3dct_torch.engine.stardist import (StarDist3D,  # noqa: E402
                                         load_stardist_model)
from t3dct_torch.models.stardist3d import (StarDist3DNet,  # noqa: E402
                                           with_keras_intensity_path)
from t3dct_torch.utils import keras_import as tk  # noqa: E402
from t3dct_torch.utils.convert import (load_npz,  # noqa: E402
                                       stardist_params_from_numpy)

KERAS_ASSETS = REPO / "3deecelltracker_tpu_torch" / "assets" / "keras"
SD_KERAS = KERAS_ASSETS / "sd_keras"
RECORD = KERAS_ASSETS / "jax_record_keras.npz"
BENCH_ASSETS = REPO / "3deecelltracker_tpu_torch" / "assets" / "bench"
# the bench's StarDist config (bench.py:190), its seeded Keras weights and
# the thresholds of the reference folder
BENCH_CFG = dict(n_rays=96, grid=(1, 2, 2), anisotropy=(9.2, 1.0, 1.0),
                 train_patch_size=(24, 96, 96))
KERAS_SEED = 0
THRESHOLDS = {"prob": 0.3, "nms": 0.3}
# bench_composition's arguments (bench.py:369-387)
N_VOLS = 21
SHAPE = (24, 401, 168)
MAX_CANDIDATES, RENDER_BOX = 256, (9, 33, 33)
# TensorFlow's forward on this (z, y, x) crop of volume 1; its dist map is
# kept on every TF_DIST_STEP-th grid voxel along y and x
TF_CROP = (slice(0, 24), slice(150, 214), slice(40, 104))
TF_DIST_STEP = 4
# the record keeps every volume's labels unless they pass this compressed
# size; then volumes 2, 11 and 21
LABELS_BUDGET = 4 * 1024 * 1024
PROB_ATOL, DIST_ATOL = 1e-5, 1e-4
# the record's run against the port's over the bench scene (chip_smoke.py's
# Keras phase): labels equal per recorded volume, the median per volume of
# the tracked coordinates' distance to JAX's, every cell within the
# record's identity gate
LABELS_EQUAL = 0.999
COORD_MEDIAN = 1e-2

# small configs of the Keras topology: pre-grid blocks on one or two axes,
# csbdeep's middle and up widths at depths 1-3, three convs per level
SMALL = {
    "g122": dict(n_rays=8, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0),
                 unet_n_depth=2, unet_n_filter_base=8,
                 net_conv_after_unet=16, train_patch_size=(8, 16, 16)),
    "g211": dict(n_rays=6, grid=(2, 1, 1), anisotropy=(1.0, 1.0, 1.0),
                 unet_n_depth=1, unet_n_filter_base=4,
                 net_conv_after_unet=8, train_patch_size=(8, 8, 8)),
    "g144_ncv3": dict(n_rays=8, grid=(1, 4, 4), anisotropy=(2.0, 1.0, 1.0),
                      unet_n_depth=1, unet_n_filter_base=4,
                      unet_n_conv_per_depth=3, net_conv_after_unet=8,
                      train_patch_size=(4, 16, 16)),
    "g111_d3": dict(n_rays=4, grid=(1, 1, 1), anisotropy=(1.0, 1.0, 1.0),
                    unet_n_depth=3, unet_n_filter_base=4,
                    net_conv_after_unet=8, train_patch_size=(8, 8, 8)),
}


def configs(kw):
    return StarDistConfig(**kw), JStarDistConfig(**kw)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_trees_equal(got, want):
    """Nested dicts (or tuples) of arrays: the same keys, dtypes and
    values."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_trees_equal(g, w)
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k])
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


# ---- seeded Keras files ---------------------------------------------------

def keras_stardist_params(cfg, seed=KERAS_SEED, intensity_path=True):
    """Seeded numpy weights of ``StarDist3DNet(cfg, arch="keras")``:
    He-normal kernels (std sqrt(2 / fan_in)), biases N(0, 0.01), then,
    with ``intensity_path``, the pass-through of
    ``with_keras_intensity_path``."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, cin, cout, kernel in StarDist3DNet(cfg, "keras").conv_plan():
        fan_in = int(np.prod(kernel)) * cin
        params[name] = {
            "w": (rng.standard_normal((*kernel, cin, cout))
                  * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "b": (rng.standard_normal(cout) * 0.01).astype(np.float32)}
    if not intensity_path:
        return params
    out = with_keras_intensity_path(
        stardist_params_from_numpy(params, "cpu"), cfg)
    return {n: {k: v.numpy() for k, v in layer.items()}
            for n, layer in out.items()}


def stardist_layers(cfg, params):
    """The Keras layers of a StarDist checkpoint in creation order."""
    layers = []
    for i, (name, *_) in enumerate(StarDist3DNet(cfg, "keras").conv_plan()):
        suffix = "" if i == 0 else f"_{i}"
        layers.append((f"conv3d{suffix}",
                       [(f"conv3d{suffix}/kernel:0", params[name]["w"]),
                        (f"conv3d{suffix}/bias:0", params[name]["b"])]))
    return layers


def config3d_json(cfg):
    """A stardist ``Config3D`` ``config.json`` for ``cfg``."""
    return {
        "n_dim": 3, "axes": "ZYXC", "backbone": "unet",
        "n_channel_in": cfg.n_channel_in, "n_channel_out": 1 + cfg.n_rays,
        "rays_json": {"name": "Rays_GoldenSpiral",
                      "kwargs": {"n": cfg.n_rays,
                                 "anisotropy": list(cfg.anisotropy)}},
        "grid": list(cfg.grid), "anisotropy": list(cfg.anisotropy),
        "unet_n_depth": cfg.unet_n_depth, "unet_pool": list(cfg.unet_pool),
        "unet_n_filter_base": cfg.unet_n_filter_base,
        "unet_n_conv_per_depth": cfg.unet_n_conv_per_depth,
        "unet_kernel_size": list(cfg.unet_kernel_size),
        "unet_batch_norm": False, "unet_activation": "relu",
        "net_conv_after_unet": cfg.net_conv_after_unet,
        "train_patch_size": list(cfg.train_patch_size)}


def tf_stardist(cfg, params):
    """The stardist-0.8 model3d topology built with TensorFlow's Keras
    (pre-grid conv blocks and pools, csbdeep ``unet_block``, features and
    the two heads), holding ``params``."""
    import tensorflow as tf
    from tensorflow.keras import layers as kl
    net = StarDist3DNet(cfg, "keras")

    def conv(name, h, activation="relu"):
        w = params[name]["w"]
        return kl.Conv3D(w.shape[-1], w.shape[:3], padding="same",
                         activation=activation, name=name)(h)

    ncv, depth = cfg.unet_n_conv_per_depth, cfg.unet_n_depth
    inputs = kl.Input((None, None, None, cfg.n_channel_in))
    h = inputs
    for step, pool in enumerate(net._keras_pools()):
        for i in range(ncv):
            h = conv(f"pre{step}_{i}", h)
        h = kl.MaxPooling3D(pool)(h)
    skips = []
    for n in range(depth):
        for i in range(ncv):
            h = conv(f"down{n}_{i}", h)
        skips.append(h)
        h = kl.MaxPooling3D(tuple(cfg.unet_pool))(h)
    for i in range(ncv):
        h = conv(f"middle{i}", h)
    for n in reversed(range(depth)):
        h = kl.Concatenate()([kl.UpSampling3D(tuple(cfg.unet_pool))(h),
                              skips[n]])
        for i in range(ncv):
            h = conv(f"up{n}_{i}", h)
    feat = conv("features", h)
    model = tf.keras.Model(inputs, [conv("prob_head", feat, "sigmoid"),
                                    conv("dist_head", feat, None)])
    for name, *_ in net.conv_plan():
        model.get_layer(name).set_weights([params[name]["w"],
                                           params[name]["b"]])
    return model


def write_reference_folder(folder: Path, cfg, params, thresholds,
                           with_tf=False):
    """A reference stardist-0.8 model folder: Config3D ``config.json``,
    ``thresholds.json`` and ``weights_best.h5``, written by TensorFlow's
    Keras (``with_tf``; returns the model) or in the Keras-2 layout with
    h5py."""
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "config.json").write_text(json.dumps(config3d_json(cfg)))
    (folder / "thresholds.json").write_text(json.dumps(thresholds))
    if with_tf:
        model = tf_stardist(cfg, params)
        model.save(str(folder / "weights_best.h5"))
        return model
    write_keras2_h5(folder / "weights_best.h5", stardist_layers(cfg, params))
    return None


def normalized(vol):
    """Volume ``vol`` normalized as the device handoff does it: the exact
    1/99.8 percentiles, then csbdeep's formula in float32."""
    from t3dct_torch.io.imageio import fast_percentiles
    mi, ma = (np.float32(v) for v in fast_percentiles(vol, (1.0, 99.8)))
    return (vol.astype(np.float32) - mi) / (ma - mi + np.float32(1e-20))


# ---- the record -----------------------------------------------------------

def write_record(out: Path, work: Path) -> dict:
    """Writes ``sd_keras/`` and the record (see the module docstring);
    returns the metrics with the CPU wall time of each step."""
    from t3dct.engine.stardist import load_stardist_keras_dir
    from t3dct.io.imageio import imread_stack
    from test_torch_bench_record import jax_ffn_weights
    walls = {}
    cfg = StarDistConfig(**BENCH_CFG)
    t0 = time.perf_counter()
    params = keras_stardist_params(cfg)
    walls["weights_s"] = time.perf_counter() - t0
    try:
        import tensorflow  # noqa: F401
        with_tf = True
    except ImportError:
        with_tf = False
    t0 = time.perf_counter()
    ref = work / "reference" / "stardist"
    tf_model = write_reference_folder(ref, cfg, params, THRESHOLDS, with_tf)
    walls["write_h5_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jm = load_stardist_keras_dir(ref)
    assert jm.arch == "keras"
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jm.params), params)
    if SD_KERAS.exists():
        shutil.rmtree(SD_KERAS)
    jm.save(SD_KERAS)
    walls["import_and_save_s"] = time.perf_counter() - t0
    jm.max_candidates, jm.render_box = MAX_CANDIDATES, RENDER_BOX
    with jax_script(REPO / "bench.py", "jax_bench", work / "xla") as bench:
        raw = work / "raw"
        raw.mkdir(parents=True)
        images_path, centers, lab1 = bench.make_recording(raw)
        results = work / "results"
        t0 = time.perf_counter()
        _, coords = bench.bench_composition(images_path, results, lab1, jm,
                                            jax_ffn_weights(),
                                            handoff="device")
        walls["bench_composition_s"] = time.perf_counter() - t0
        metrics = bench.tracking_id_metrics(coords, centers)
    vol1 = imread_stack(sorted(raw.glob("raw_t001_z*.tif")))
    x1 = normalized(vol1)
    t0 = time.perf_counter()
    prob1, dist1 = jm.predict(x1)
    walls["vol1_forward_s"] = time.perf_counter() - t0
    seg1 = np.load(results / "seg" / "coords000001.npy")
    pts = seg1[:, [2, 0, 1]] // np.asarray(cfg.grid)
    arrays = {"prob_1": prob1.astype(np.float32),
              "dist_1_points": pts.astype(np.int32),
              "dist_1": dist1[pts[:, 0], pts[:, 1], pts[:, 2]].astype(
                  np.float32)}
    crop = x1[TF_CROP][None, ..., None]
    if tf_model is not None:
        t0 = time.perf_counter()
        tf_prob, tf_dist = tf_model.predict(crop, verbose=0)
        walls["tf_crop_forward_s"] = time.perf_counter() - t0
        jp, jd = jm.net.apply(jm.params, jnp.asarray(crop))
        metrics["jax_vs_tf_crop_max_abs"] = dict(
            prob=float(np.abs(np.asarray(jp) - tf_prob).max()),
            dist=float(np.abs(np.asarray(jd) - tf_dist).max()))
        arrays["tf_prob"] = tf_prob[0, ..., 0].astype(np.float32)
        arrays["tf_dist"] = tf_dist[0, :, ::TF_DIST_STEP,
                                    ::TF_DIST_STEP].astype(np.float32)
    labels = {}
    for t in range(1, N_VOLS + 1):
        arrays[f"seg_coords_{t}"] = np.load(results / "seg" /
                                            f"coords{t:06d}.npy")
        arrays[f"coords_{t}"] = np.asarray(coords[t], np.float32)
        lab = imread_stack(sorted((results / "track_results" / "labels")
                                  .glob("track_results_t%06i_z*.tif" % t)))
        labels[f"labels_{t}"] = lab.transpose(1, 2, 0)
    metrics.update(walls)
    metrics["h5_writer"] = "tensorflow" if with_tf else "h5py"
    recipe = json.dumps(dict(BENCH_CFG, seed=KERAS_SEED,
                             thresholds=THRESHOLDS,
                             max_candidates=MAX_CANDIDATES,
                             render_box=RENDER_BOX,
                             tf_crop=[[s.start, s.stop] for s in TF_CROP],
                             tf_dist_step=TF_DIST_STEP))
    np.savez_compressed(out, metrics=json.dumps(metrics), recipe=recipe,
                        **arrays, **labels)
    if out.stat().st_size > LABELS_BUDGET:
        kept = {k: v for k, v in labels.items()
                if k in ("labels_2", "labels_11", "labels_21")}
        np.savez_compressed(out, metrics=json.dumps(metrics), recipe=recipe,
                            **arrays, **kept)
    return metrics


# ---- the Keras topology ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(SMALL) + ["bench"])
def test_keras_plan_matches_jax(name):
    """``_keras_pools``, ``_keras_plan`` (names, widths, kernels, in
    creation order), ``div_by`` and ``receptive_field`` equal JAX's."""
    cfg, jcfg = configs(BENCH_CFG if name == "bench" else SMALL[name])
    net, jnet = StarDist3DNet(cfg, "keras"), JNet(jcfg, arch="keras")
    assert net._keras_pools() == jnet._keras_pools()
    assert net._keras_plan() == jnet._keras_plan() == net.conv_plan()
    assert net.div_by == jnet.div_by
    assert net.receptive_field() == jnet.receptive_field()
    if name == "bench":
        # the full-resolution pre-grid block, csbdeep's half widths
        assert [(n, ci, co) for n, ci, co, _ in net.conv_plan()] == [
            ("pre0_0", 1, 32), ("pre0_1", 32, 32), ("down0_0", 32, 32),
            ("down0_1", 32, 32), ("down1_0", 32, 64), ("down1_1", 64, 64),
            ("middle0", 64, 128), ("middle1", 128, 64), ("up1_0", 128, 64),
            ("up1_1", 64, 32), ("up0_0", 64, 32), ("up0_1", 32, 32),
            ("features", 32, 128), ("prob_head", 128, 1),
            ("dist_head", 128, 96)]
        assert net.receptive_field() == (29, 57, 57)
        assert StarDist3DNet(StarDistConfig(), "keras").receptive_field() \
            == (57, 29, 29)


def test_keras_grid_must_be_powers_of_two():
    """JAX's ``ValueError`` for a grid that pooling by 2 cannot reach; an
    unknown arch raises too."""
    kw = dict(SMALL["g122"], grid=(1, 3, 2))
    with pytest.raises(ValueError, match="powers of 2"):
        JNet(JStarDistConfig(**kw), arch="keras")._keras_pools()
    with pytest.raises(ValueError, match="powers of 2"):
        StarDist3DNet(StarDistConfig(**kw), "keras")._keras_pools()
    with pytest.raises(ValueError, match="arch"):
        StarDist3DNet(StarDistConfig(**kw), "tf")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_keras_forward_matches_jax(name):
    """``StarDist3DNet(arch="keras").apply`` gives JAX's (prob, dist) on the
    same seeded weights, a batch of two, within 1e-5 / 1e-4."""
    cfg, jcfg = configs(SMALL[name])
    params = keras_stardist_params(cfg, seed=3, intensity_path=False)
    div = StarDist3DNet(cfg, "keras").div_by
    shape = tuple(2 * d for d in div)
    x = np.random.default_rng(5).random((2, *shape, 1), np.float32)
    tp, td = StarDist3DNet(cfg, "keras").apply(
        stardist_params_from_numpy(params, "cpu"), torch.from_numpy(x))
    jp, jd = JNet(jcfg, arch="keras").apply(to_jax(params), jnp.asarray(x))
    assert tp.shape == jp.shape and td.shape == jd.shape
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=PROB_ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=DIST_ATOL)


def test_keras_forward_matches_tensorflow(tmp_path):
    """A checkpoint that TensorFlow's Keras wrote (``model.save`` of the
    stardist-0.8 topology): the port imports the weights TensorFlow holds
    and its forward gives TensorFlow's within 1e-5 / 1e-4."""
    pytest.importorskip("tensorflow")
    cfg, _ = configs(SMALL["g122"])
    params = keras_stardist_params(cfg, seed=6)
    model = write_reference_folder(tmp_path, cfg, params, THRESHOLDS,
                                   with_tf=True)
    got = tk.import_stardist3d(tmp_path / "weights_best.h5", cfg)
    assert_trees_equal(got, params)
    x = np.random.default_rng(7).random((1, 8, 32, 32, 1), np.float32)
    want_p, want_d = model.predict(x, verbose=0)
    p, d = StarDist3DNet(cfg, "keras").apply(
        stardist_params_from_numpy(got, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(p.numpy(), want_p, atol=PROB_ATOL)
    np.testing.assert_allclose(d.numpy(), want_d, atol=DIST_ATOL)


def test_keras_intensity_path_passes_channel_zero():
    """``with_keras_intensity_path`` scales the weights by 0.05 and adds the
    pass-through: every 3x3x3 layer's centre tap maps channel 0 (an up
    block's first conv: the skip's channel 0, after the upsampled tensor)
    to channel 0; the heads read sigmoid(12 ch0 - 6) and dist 3."""
    cfg, _ = configs(SMALL["g122"])
    raw = keras_stardist_params(cfg, intensity_path=False)
    out = keras_stardist_params(cfg)
    base = cfg.unet_n_filter_base
    for name, cin, cout, kernel in StarDist3DNet(cfg, "keras").conv_plan():
        w, w0 = out[name]["w"], raw[name]["w"] * np.float32(0.05)
        np.testing.assert_array_equal(out[name]["b"], {
            "prob_head": np.full(1, -6.0, np.float32),
            "dist_head": np.full(cfg.n_rays, 3.0, np.float32)}.get(
                name, raw[name]["b"]))
        if name == "prob_head":
            assert w[0, 0, 0, 0, 0] == 12.0 and np.count_nonzero(w) == 1
            continue
        src = 0
        if name.startswith("up") and name.endswith("_0"):
            src = cin - base * 2 ** int(name[2])
        diff = w - w0
        assert np.count_nonzero(diff) == (name != "dist_head")
        if name != "dist_head":
            assert diff[1, 1, 1, src, 0] == pytest.approx(1.0, abs=1e-6)


# ---- the importers --------------------------------------------------------

def unet_layers(spec, seed):
    """Seeded U-Net weights as the reference's Keras layers in creation
    order (a conv with bias, then a BatchNorm, per block)."""
    rng = np.random.default_rng(seed)
    layers = []
    for i, (name, cin, cout) in enumerate(tk._unet_block_specs(spec)):
        k = 1 if name == "out" else 3
        sfx = "" if i == 0 else f"_{i}"
        w = rng.standard_normal((k, k, k, cin, cout)).astype(np.float32)
        b = rng.standard_normal(cout).astype(np.float32)
        layers.append((f"conv3d{sfx}", [(f"conv3d{sfx}/kernel:0", w),
                                        (f"conv3d{sfx}/bias:0", b)]))
        if name != "out":
            bn = [rng.standard_normal(cout).astype(np.float32)
                  for _ in range(3)]
            bn.append((np.abs(rng.standard_normal(cout)) + 0.5).astype(
                np.float32))
            layers.append((f"batch_normalization{sfx}", [
                (f"batch_normalization{sfx}/{n}:0", a) for n, a in zip(
                    ("gamma", "beta", "moving_mean", "moving_variance"),
                    bn)]))
    return layers


FULL_MODEL = {"class_name": "Functional", "config": {"layers": []}}


@pytest.mark.parametrize("layout", ["weights_only", "full_model"])
@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_import_unet3_matches_jax(tmp_path, variant, layout):
    """The same ``.h5`` through both packages' ``import_unet3``: the same
    variant (inferred, 'a' for the a/c tie; 'c' when asked) and exactly
    equal trees."""
    from t3dct.models.unet3d import get_unet as j_get_unet
    from t3dct_torch.models.unet3d import get_unet
    path = tmp_path / "unet.h5"
    write_keras2_h5(path, unet_layers(get_unet(variant), seed=7),
                    FULL_MODEL if layout == "full_model" else None)
    assert [n for n, *_ in tk._unet_block_specs(get_unet(variant))] == [
        n for n, *_ in jk._unet_block_specs(j_get_unet(variant))]
    for ask in (None, variant):
        spec, params, state = tk.import_unet3(path, ask)
        jspec, jparams, jstate = jk.import_unet3(path, ask)
        assert spec.variant == jspec.variant == (
            ask or ("a" if variant == "c" else variant))
        assert_trees_equal(params, jax.tree_util.tree_map(np.asarray,
                                                          jparams))
        assert_trees_equal(state, jax.tree_util.tree_map(np.asarray,
                                                         jstate))


def ffn_layers(seed, n_feat=61, hidden=512):
    """The subclassed FFN's ``save_weights`` layout (ffn.py:225-258):
    top-level Sequential groups with nested weight paths."""
    rng = np.random.default_rng(seed)

    def a(*shape, pos=False):
        v = rng.standard_normal(shape).astype(np.float32)
        return (np.abs(v) + 0.5).astype(np.float32) if pos else v

    names = ["gamma:0", "beta:0", "moving_mean:0", "moving_variance:0"]
    bn1 = [a(hidden), a(hidden), a(hidden), a(hidden, pos=True)]
    bn2 = [a(hidden), a(hidden), a(hidden), a(hidden, pos=True)]
    return [
        ("sequential", [("sequential/dense/kernel:0", a(n_feat, hidden))]
         + [(f"sequential/batch_normalization/{n}", v)
            for n, v in zip(names, bn1)]),
        ("concatenate", []),
        ("sequential_1",
         [("sequential_1/dense_1/kernel:0", a(2 * hidden, hidden))]
         + [(f"sequential_1/batch_normalization_1/{n}", v)
            for n, v in zip(names, bn2)]),
        ("sequential_2", [("sequential_2/dense_2/kernel:0", a(hidden, 1)),
                          ("sequential_2/dense_2/bias:0", a(1))]),
    ]


@pytest.mark.parametrize("layout", ["weights_only", "full_model"])
def test_import_ffn_matches_jax(tmp_path, layout):
    path = tmp_path / "ffn.h5"
    write_keras2_h5(path, ffn_layers(seed=2),
                    FULL_MODEL if layout == "full_model" else None)
    params, state = tk.import_ffn(path)
    jparams, jstate = jk.import_ffn(path)
    assert "b" not in params["feat"]          # use_bias=False kept
    assert_trees_equal(params, jax.tree_util.tree_map(np.asarray, jparams))
    assert_trees_equal(state, jax.tree_util.tree_map(np.asarray, jstate))


@pytest.mark.parametrize("name", ["g122", "g211"])
def test_import_stardist3d_matches_jax(tmp_path, name):
    """A StarDist checkpoint at grids (1, 2, 2) and (2, 1, 1): both
    packages' trees equal the written weights exactly."""
    cfg, jcfg = configs(SMALL[name])
    params = keras_stardist_params(cfg, seed=4)
    path = tmp_path / "weights_best.h5"
    write_keras2_h5(path, stardist_layers(cfg, params))
    got = tk.import_stardist3d(path, cfg)
    assert list(got) == [n for n, *_ in StarDist3DNet(cfg,
                                                      "keras").conv_plan()]
    assert_trees_equal(got, params)
    assert_trees_equal(jax.tree_util.tree_map(
        np.asarray, jk.import_stardist3d(path, jcfg)), params)


def _errors(fn_port, fn_jax):
    """Both calls raise: the same exception type and message."""
    with pytest.raises(Exception) as want:
        fn_jax()
    with pytest.raises(want.type) as got:
        fn_port()
    assert str(got.value) == str(want.value)
    return got.value


@pytest.mark.parametrize("case", ["wrong_variant", "stardist_bn",
                                  "conv_count", "stardist_channels",
                                  "not_keras2", "ffn_units",
                                  "unet_with_dense", "sequential",
                                  "config_json"])
def test_importers_raise_as_jax(tmp_path, case):
    """JAX's errors come back the same: a variant that does not fit, a
    BatchNorm in a StarDist file, a conv count or width that does not fit
    the config, a file without ``layer_names``, a non-FFN file, Dense
    weights in a U-Net file, a Sequential config for ``KerasGraph``, an
    unsupported Config3D."""
    from t3dct_torch.models.unet3d import get_unet
    path = tmp_path / "w.h5"
    cfg, jcfg = configs(SMALL["g122"])
    if case == "wrong_variant":
        write_keras2_h5(path, unet_layers(get_unet("a"), seed=1))
        err = _errors(lambda: tk.import_unet3(path, "b"),
                      lambda: jk.import_unet3(path, "b"))
        assert isinstance(err, ValueError)
    elif case == "stardist_bn":
        write_keras2_h5(path, stardist_layers(cfg, keras_stardist_params(
            cfg)) + [("bn", [("bn/moving_mean:0", np.zeros(4, np.float32)),
                             ("bn/moving_variance:0",
                              np.ones(4, np.float32))])])
        _errors(lambda: tk.import_stardist3d(path, cfg),
                lambda: jk.import_stardist3d(path, jcfg))
    elif case == "conv_count":
        write_keras2_h5(path, stardist_layers(cfg, keras_stardist_params(
            cfg))[:-1])
        _errors(lambda: tk.import_stardist3d(path, cfg),
                lambda: jk.import_stardist3d(path, jcfg))
    elif case == "stardist_channels":
        other, jother = configs(dict(SMALL["g122"], unet_n_filter_base=4))
        write_keras2_h5(path, stardist_layers(cfg, keras_stardist_params(
            cfg)))
        _errors(lambda: tk.import_stardist3d(path, other),
                lambda: jk.import_stardist3d(path, jother))
    elif case == "not_keras2":
        import h5py
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=np.zeros(3))
        _errors(lambda: tk.read_keras_h5(path),
                lambda: jk.read_keras_h5(path))
    elif case == "ffn_units":
        write_keras2_h5(path, unet_layers(get_unet("a"), seed=1))
        _errors(lambda: tk.import_ffn(path), lambda: jk.import_ffn(path))
    elif case == "unet_with_dense":
        write_keras2_h5(path, ffn_layers(seed=1))
        _errors(lambda: tk.import_unet3(path), lambda: jk.import_unet3(path))
    elif case == "sequential":
        seq = {"class_name": "Sequential", "config": {"layers": [
            {"class_name": "Dense", "name": "dense_1",
             "config": {"name": "dense_1", "units": 4}}]}}
        _errors(lambda: tk.KerasGraph(seq, {}, device="cpu"),
                lambda: jk.KerasGraph(seq, {}))
    else:
        bad = dict(config3d_json(cfg), unet_batch_norm=True)
        (tmp_path / "config.json").write_text(json.dumps(bad))
        _errors(lambda: tk.stardist_config_from_json(tmp_path /
                                                     "config.json"),
                lambda: jk.stardist_config_from_json(tmp_path /
                                                     "config.json"))


def test_units_adjacent_scale_false_bn():
    """A scale=False BatchNorm (no gamma) right after a complete one is a
    unit of its own, as in JAX."""
    layers = [("bn_a", [("bn_a/gamma:0", np.ones(4, np.float32)),
                        ("bn_a/beta:0", np.full(4, 2.0, np.float32)),
                        ("bn_a/moving_mean:0", np.zeros(4, np.float32)),
                        ("bn_a/moving_variance:0", np.ones(4, np.float32))]),
              ("bn_b", [("bn_b/beta:0", np.full(4, 7.0, np.float32)),
                        ("bn_b/moving_mean:0", np.full(4, 5.0, np.float32)),
                        ("bn_b/moving_variance:0",
                         np.full(4, 3.0, np.float32))])]
    got, want = tk._units(layers), jk._units(layers)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]


def test_keras_graph_shared_branch_matches_jax(tmp_path):
    """A full-model file whose feature branch is one layer applied to both
    inputs (the legacy FFN, tracker.py:1121 + track.py:117-180): the port's
    ``KerasGraph`` gives JAX's within 1e-6, and ``import_ffn`` reads the
    same file."""
    def node(*parents):
        return [[p, idx, 0, {}] for p, idx in parents]

    def layer(cls, name, inbound, **cfg):
        return {"class_name": cls, "name": name,
                "config": dict(name=name, **cfg), "inbound_nodes": inbound}

    model_config = {"class_name": "Functional", "config": {
        "name": "legacy_ffn",
        "layers": [
            layer("InputLayer", "in_ref", []),
            layer("InputLayer", "in_tgt", []),
            layer("Dense", "feat", [node(("in_ref", 0)),
                                    node(("in_tgt", 0))], use_bias=False),
            layer("BatchNormalization", "feat_bn",
                  [node(("feat", 0)), node(("feat", 1))], epsilon=1e-3),
            layer("LeakyReLU", "feat_act",
                  [node(("feat_bn", 0)), node(("feat_bn", 1))], alpha=0.3),
            layer("Concatenate", "concat",
                  [node(("feat_act", 0), ("feat_act", 1))], axis=1),
            layer("Dense", "comb", [node(("concat", 0))], use_bias=False),
            layer("BatchNormalization", "comb_bn", [node(("comb", 0))],
                  epsilon=1e-3),
            layer("LeakyReLU", "comb_act", [node(("comb_bn", 0))],
                  alpha=0.3),
            layer("Dropout", "drop", [node(("comb_act", 0))], rate=0.5),
            layer("Dense", "pred", [node(("drop", 0))],
                  activation="sigmoid"),
        ],
        "input_layers": [["in_ref", 0, 0], ["in_tgt", 0, 0]],
        "output_layers": [["pred", 0, 0]]}}
    (seq, _, seq1, seq2) = ffn_layers(seed=9)
    bn = ["gamma:0", "beta:0", "moving_mean:0", "moving_variance:0"]
    layers = [
        ("feat", [("feat/kernel:0", seq[1][0][1])]),
        ("feat_bn", [(f"feat_bn/{n}", v) for n, (_, v)
                     in zip(bn, seq[1][1:])]),
        ("comb", [("comb/kernel:0", seq1[1][0][1])]),
        ("comb_bn", [(f"comb_bn/{n}", v) for n, (_, v)
                     in zip(bn, seq1[1][1:])]),
        ("pred", [("pred/kernel:0", seq2[1][0][1]),
                  ("pred/bias:0", seq2[1][1][1])]),
    ]
    path = tmp_path / "ffn_legacy_model.h5"
    write_keras2_h5(path, layers, model_config)
    rng = np.random.default_rng(11)
    a, b = (rng.standard_normal((7, 61)).astype(np.float32)
            for _ in range(2))
    graph = tk.KerasGraph.from_h5(path, device="cpu")
    got = graph(a, b)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = jk.KerasGraph.from_h5(path)(a, b)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(ValueError, match="expects 2 inputs"):
        graph(a)
    params, _ = tk.import_ffn(path)
    np.testing.assert_array_equal(params["pred"]["b"], seq2[1][1][1])


# ---- the loaders ----------------------------------------------------------

@pytest.fixture(scope="module")
def reference_folder(tmp_path_factory):
    """A reference stardist folder (h5py's Keras-2 layout) of the small
    config with seeded Keras weights and the pass-through path."""
    root = tmp_path_factory.mktemp("stardist_models")
    cfg, _ = configs(SMALL["g122"])
    params = keras_stardist_params(cfg, seed=1)
    write_reference_folder(root / "ref", cfg, params,
                           {"prob": 0.42, "nms": 0.25})
    return root, params


def _scene_volume():
    """A normalized (8, 32, 32) volume with a few gaussian cells."""
    rng = np.random.default_rng(2)
    zz, yy, xx = np.meshgrid(np.arange(8), np.arange(32), np.arange(32),
                             indexing="ij")
    vol = rng.random((8, 32, 32)).astype(np.float32) * 0.05
    for cz, cy, cx in ((3.2, 8.5, 9.1), (4.6, 20.3, 11.7),
                       (3.9, 15.2, 24.4), (4.1, 26.8, 25.2)):
        vol += np.exp(-((zz - cz) ** 2 / 2.0 + (yy - cy) ** 2 / 8.0
                        + (xx - cx) ** 2 / 8.0)).astype(np.float32)
    return vol


def test_load_stardist_model_reference_folder(reference_folder):
    """``load_stardist_model`` on a reference Keras folder: an
    ``arch="keras"`` model with the folder's config and thresholds, and
    ``predict_instances`` keeps JAX's cells and labels exactly."""
    from t3dct.engine.stardist import load_stardist_model as j_load
    root, params = reference_folder
    tm = load_stardist_model("ref", str(root), device="cpu")
    jm = j_load("ref", str(root))
    assert tm.arch == jm.arch == "keras"
    assert tm.net.arch == "keras"
    assert tm.thresholds == jm._thresholds == {"prob": 0.42, "nms": 0.25}
    assert tm.config == StarDistConfig(**SMALL["g122"])
    assert_trees_equal({n: {k: v.numpy() for k, v in layer.items()}
                        for n, layer in tm.params.items()}, params)
    x = _scene_volume()
    (tl, td), tp = tm.predict_instances(x)
    (jl, jd), jp = jm.predict_instances(x)
    assert len(td["points"]) > 0
    np.testing.assert_array_equal(td["points"], jd["points"])
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tp, jp, atol=1e-3)


def test_keras_folder_search_order(tmp_path, reference_folder):
    """``weights_best.h5`` before ``weights_last.h5`` before any other
    ``.h5``; a folder without one raises ``FileNotFoundError``."""
    from t3dct_torch.engine.stardist import load_stardist_keras_dir
    root, params = reference_folder
    cfg, _ = configs(SMALL["g122"])
    other = keras_stardist_params(cfg, seed=8)
    folder = tmp_path / "m"
    write_reference_folder(folder, cfg, other, THRESHOLDS)
    (folder / "weights_best.h5").rename(folder / "weights_last.h5")
    shutil.copy(root / "ref" / "weights_best.h5", folder / "a_first.h5")
    got = load_stardist_keras_dir(folder, device="cpu")
    np.testing.assert_array_equal(got.params["pre0_0"]["w"].numpy(),
                                  other["pre0_0"]["w"])
    (folder / "weights_last.h5").unlink()
    got = load_stardist_keras_dir(folder, device="cpu")
    np.testing.assert_array_equal(got.params["pre0_0"]["w"].numpy(),
                                  params["pre0_0"]["w"])
    (folder / "a_first.h5").unlink()
    with pytest.raises(FileNotFoundError, match="no .h5 checkpoint"):
        load_stardist_keras_dir(folder, device="cpu")


def test_keras_save_load_round_trip_both_ways(tmp_path, reference_folder):
    """The port's ``save`` of a Keras model writes ``"arch": "keras"``
    (it wrote ``"tpu"`` for every model), so JAX's ``StarDist3D.load``
    builds the Keras network around its weights; a folder JAX saves loads
    in the port as the same model."""
    root, params = reference_folder
    tm = load_stardist_model("ref", str(root), device="cpu")
    tm.save(tmp_path / "port")
    assert json.loads((tmp_path / "port" / "config.json").read_text())[
        "arch"] == "keras"
    jm = JStarDist3D.load(tmp_path / "port")
    assert jm.arch == "keras" and jm._thresholds == tm.thresholds
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jm.params),
                       params)
    jm.save(tmp_path / "jax")
    back = StarDist3D.load(tmp_path / "jax", device="cpu")
    assert back.arch == "keras" and back.net.arch == "keras"
    assert back.thresholds == tm.thresholds and back.config == tm.config
    x = _scene_volume()[None, ..., None]
    jp, jd = (np.asarray(a) for a in jm.net.apply(jm.params,
                                                  jnp.asarray(x)))
    for m in (back, StarDist3D.load(tmp_path / "port", device="cpu")):
        p, d = m.net.apply(m.params, torch.from_numpy(x))
        np.testing.assert_allclose(p.numpy(), jp, atol=PROB_ATOL)
        np.testing.assert_allclose(d.numpy(), jd, atol=DIST_ATOL)


def test_keras_model_init_without_params():
    """``StarDist3D(config, arch="keras")`` initializes the Keras plan's
    layers from its seed, and keeps them through ``save``."""
    cfg, _ = configs(SMALL["g211"])
    m = StarDist3D(cfg, arch="keras", rng=2, device="cpu")
    assert list(m.params) == [n for n, *_ in m.net.conv_plan()]
    assert "pre0_0" in m.params and m.net.div_by == (4, 2, 2)


# ---- the legacy and tracker loaders ---------------------------------------

def test_legacy_tracker_loads_h5(tmp_path):
    """The legacy ``Tracker.load_unet`` and ``load_ffn`` on ``.h5`` files
    give JAX's parameters, exactly, and ``weights_initial.npz`` holds
    them."""
    from t3dct.engine.legacy import Tracker as JTracker
    from t3dct_torch.engine.legacy import Tracker
    from t3dct_torch.models.unet3d import get_unet
    from t3dct_torch.utils.checkpoint import load_pytree
    trees = []
    for pkg, cls, extra in (("jax", JTracker, {}),
                            ("port", Tracker, {"device": "cpu"})):
        folder = tmp_path / pkg
        tr = cls(2, (32, 32, 8), 2.0, 2, 10.0, 5, 300.0, 0.1, 3,
                 str(folder), "raw_t%04i_z%04i.tif", "unet3_b.h5", "ffn.h5",
                 unet_variant="b", **extra)
        write_keras2_h5(folder / "models" / "unet3_b.h5",
                        unet_layers(get_unet("b"), seed=3))
        write_keras2_h5(folder / "models" / "ffn.h5", ffn_layers(seed=4))
        tr.load_unet()
        tr.load_ffn()
        assert tr.unet_model.variant == "b"
        trees.append(jax.tree_util.tree_map(
            lambda v: np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                 else v),
            (tr.unet_params, tr.unet_bn_state, tr.ffn_params,
             tr.ffn_state)))
        if pkg == "port":
            assert tr.unet_params["down0_0"]["conv"]["w"].device.type \
                == "cpu"
            cached = load_pytree(
                (tr.unet_params, tr.unet_bn_state),
                Path(tr.paths.unet_weights) / "weights_initial.npz")
            assert_trees_equal(jax.tree_util.tree_map(
                lambda v: v.numpy(), cached), trees[-1][:2])
    for got, want in zip(trees[1], trees[0]):
        assert_trees_equal(got, want)


def test_trackerlite_takes_keras_ffn(tmp_path):
    """``TrackerLite`` on a Keras FFN ``.h5`` holds the parameters JAX's
    does and scores pairs as JAX's within 1e-5."""
    from t3dct.engine.tracker import TrackerLite as JTrackerLite
    from t3dct.models.ffn import ffn_pair_scores as j_scores
    from t3dct_torch.coordinates import Coordinates
    from t3dct_torch.engine.tracker import TrackerLite
    from t3dct_torch.models.ffn import ffn_pair_scores
    path = tmp_path / "ffn.h5"
    write_keras2_h5(path, ffn_layers(seed=5))
    rng = np.random.default_rng(0)
    vol1 = Coordinates.from_raw(rng.random((20, 3)) * 50, 10,
                                (1.0, 1.0, 4.0), device="cpu")
    tr = TrackerLite(tmp_path / "port", str(path), vol1)
    jt = JTrackerLite(tmp_path / "jax", str(path),
                      type("Vol1", (), {"cell_num": 20})())
    assert_trees_equal(jax.tree_util.tree_map(lambda v: v.numpy(),
                                              tr.ffn_params),
                       jax.tree_util.tree_map(np.asarray, jt.ffn_params))
    assert_trees_equal(jax.tree_util.tree_map(lambda v: v.numpy(),
                                              tr.ffn_state),
                       jax.tree_util.tree_map(np.asarray, jt.ffn_state))
    f1, f2 = (rng.standard_normal((n, 61)).astype(np.float32)
              for n in (12, 9))
    got = ffn_pair_scores(tr.ffn_params, tr.ffn_state, torch.from_numpy(f1),
                          torch.from_numpy(f2))
    want = j_scores(jt.ffn_params, jt.ffn_state, jnp.asarray(f1),
                    jnp.asarray(f2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_keras_readers_name_h5py_when_missing(tmp_path, monkeypatch,
                                             reference_folder):
    """Without ``h5py`` every ``.h5`` reader raises an ``ImportError``
    that names it, and a reference folder does not load; the model folder
    of the assets, ``weights.npz``, still does."""
    root, _ = reference_folder
    monkeypatch.setitem(sys.modules, "h5py", None)
    for fn in (lambda: tk.read_keras_h5(root / "ref" / "weights_best.h5"),
               lambda: load_stardist_model("ref", str(root), device="cpu")):
        with pytest.raises(ImportError, match="h5py"):
            fn()
    m = load_stardist_model("sd_keras", str(KERAS_ASSETS), device="cpu")
    assert m.arch == "keras"


# ---- the committed assets and JAX's record --------------------------------

@pytest.fixture(scope="module")
def record():
    with np.load(RECORD) as data:
        return {k: data[k] for k in data.files}


def bench_cfg():
    return StarDistConfig(**BENCH_CFG)


def test_sd_keras_is_the_seeded_reference_model(tmp_path):
    """``sd_keras/`` is the seeded Keras model at the bench config, saved
    by JAX's ``StarDist3D.save`` (``"arch": "keras"``): its weights equal
    ``keras_stardist_params`` exactly, and a reference folder written
    again from them (h5py's Keras-2 layout) imports to the same tree in
    both packages."""
    cfg = bench_cfg()
    raw = json.loads((SD_KERAS / "config.json").read_text())
    assert raw["arch"] == "keras" and raw["n_rays"] == 96
    assert tuple(raw["grid"]) == (1, 2, 2)
    assert tuple(raw["anisotropy"]) == (9.2, 1.0, 1.0)
    assert json.loads((SD_KERAS / "thresholds.json").read_text()) \
        == THRESHOLDS
    params = keras_stardist_params(cfg)
    assert_trees_equal(load_npz(SD_KERAS / "weights.npz"), params)
    n = sum(v.size for layer in params.values() for v in layer.values())
    assert 1_100_000 < n < 1_250_000
    total = sum(p.stat().st_size for p in KERAS_ASSETS.rglob("*")
                if p.is_file())
    assert total < 8 * 1024 * 1024
    folder = tmp_path / "stardist"
    write_reference_folder(folder, cfg, params, THRESHOLDS)
    tm = load_stardist_model("stardist", str(tmp_path), device="cpu")
    assert_trees_equal({k: {n: v.numpy() for n, v in layer.items()}
                        for k, layer in tm.params.items()}, params)
    assert tm.thresholds == THRESHOLDS and tm.arch == "keras"
    jp = jk.import_stardist3d(folder / "weights_best.h5",
                              JStarDistConfig(**BENCH_CFG))
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jp), params)


def test_record_holds_its_recipe(record):
    """The recipe the record states, each volume's kept cells and tracked
    coordinates, the uint8 labels, the metrics with the CPU wall of each
    step, volume 1's maps and TensorFlow's crop."""
    recipe = json.loads(str(record["recipe"]))
    assert recipe["seed"] == KERAS_SEED and recipe["n_rays"] == 96
    assert recipe["thresholds"] == THRESHOLDS
    assert recipe["max_candidates"] == MAX_CANDIDATES
    assert tuple(recipe["render_box"]) == RENDER_BOX
    assert recipe["tf_crop"] == [[s.start, s.stop] for s in TF_CROP]
    metrics = json.loads(str(record["metrics"]))
    assert set(metrics) >= {"gate", "strict_recall", "id_switches",
                            "bench_composition_s", "h5_writer"}
    n1 = record["coords_1"].shape[0]
    for t in range(1, N_VOLS + 1):
        seg = record[f"seg_coords_{t}"]
        assert seg.dtype == np.int32 and 100 < len(seg) <= MAX_CANDIDATES
        assert record[f"coords_{t}"].shape == (n1, 3)
        assert np.isfinite(record[f"coords_{t}"]).all()
    labels = [k for k in record if k.startswith("labels_")]
    assert labels
    for k in labels:
        assert record[k].dtype == np.uint8
        assert record[k].shape == (SHAPE[1], SHAPE[2], SHAPE[0])
    assert record["prob_1"].shape == (24, 201, 84)
    assert record["dist_1"].shape == (len(record["seg_coords_1"]), 96)
    if metrics["h5_writer"] == "tensorflow":
        assert record["tf_prob"].shape == (24, 32, 32)
        assert record["tf_dist"].shape == (24, 32 // TF_DIST_STEP,
                                           32 // TF_DIST_STEP, 96)
        # JAX's own forward of the crop agreed with TensorFlow's
        err = metrics["jax_vs_tf_crop_max_abs"]
        assert err["prob"] <= PROB_ATOL and err["dist"] <= DIST_ATOL


@pytest.fixture(scope="module")
def bench_volumes():
    from t3dct_torch.utils.synthetic import make_recording
    vols, centers, lab1 = make_recording(N_VOLS, shape=SHAPE)
    return vols, centers, lab1


@pytest.fixture(scope="module")
def sd_keras():
    m = load_stardist_model("sd_keras", str(KERAS_ASSETS), device="cpu")
    m.max_candidates, m.render_box = MAX_CANDIDATES, RENDER_BOX
    return m


def test_port_matches_tensorflow_on_the_crop(record, bench_volumes,
                                             sd_keras):
    """The port's Keras forward of the crop of volume 1 gives TensorFlow's
    (the framework that wrote the checkpoint) within 1e-5 / 1e-4."""
    if "tf_prob" not in record:
        pytest.skip("the record was written without tensorflow")
    x = normalized(bench_volumes[0][0])[TF_CROP][None, ..., None]
    p, d = sd_keras.net.apply(sd_keras.params, torch.from_numpy(x))
    np.testing.assert_allclose(p[0, ..., 0].numpy(), record["tf_prob"],
                               atol=PROB_ATOL)
    np.testing.assert_allclose(
        d[0, :, ::TF_DIST_STEP, ::TF_DIST_STEP].numpy(), record["tf_dist"],
        atol=DIST_ATOL)


def test_port_maps_match_record(record, bench_volumes, sd_keras):
    """Volume 1's prob map through the port's ``StarDist3D.predict``
    equals JAX's record within 1e-5, and its dist at every kept cell
    within 1e-4."""
    prob, dist = sd_keras.predict(normalized(bench_volumes[0][0]))
    assert prob.shape == record["prob_1"].shape
    np.testing.assert_allclose(prob, record["prob_1"], atol=PROB_ATOL)
    pts = record["dist_1_points"]
    np.testing.assert_allclose(dist[pts[:, 0], pts[:, 1], pts[:, 2]],
                               record["dist_1"], atol=DIST_ATOL)


def same_cells(got, want):
    """The same kept cells (rows of ``seg/coords``).  Their order is the
    descending probability: the pass-through model's peaks saturate near
    0.9999, where two cells can lie within the f32 summation bound of each
    other and come in either order (volume 12 of the scene), so the cells
    are held as sets."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert {tuple(r) for r in got} == {tuple(r) for r in want}


def hold_keras_to_record(record, results, coords, centers):
    """The Keras phase's checks of a run of the port: kept cells
    (``same_cells``), tracked coordinates within ``COORD_MEDIAN`` per
    volume and every cell within the identity gate, labels
    ``LABELS_EQUAL`` per recorded volume, strict recall and identity
    switches equal."""
    from t3dct_torch.engine.metrics import tracking_id_metrics
    from t3dct_torch.io.imageio import imread_stack
    want = json.loads(str(record["metrics"]))
    for t in range(1, N_VOLS + 1):
        same_cells(np.load(results / "seg" / f"coords{t:06d}.npy"),
                   record[f"seg_coords_{t}"])
        d = np.linalg.norm(coords[t] - record[f"coords_{t}"], axis=1)
        assert np.median(d) <= COORD_MEDIAN and d.max() <= want["gate"], t
        if f"labels_{t}" in record:
            lab = imread_stack(sorted((results / "track_results" / "labels")
                                      .glob("track_results_t%06i_z*.tif"
                                            % t))).transpose(1, 2, 0)
            assert lab.dtype == np.uint8
            assert (lab == record[f"labels_{t}"]).mean() >= LABELS_EQUAL, t
    got = tracking_id_metrics(coords, centers, (1.0, 1.0, 9.2), N_VOLS)
    assert got["strict_recall"] == want["strict_recall"]
    assert got["id_switches"] == want["id_switches"]


def test_port_kept_cells_match_record(record, bench_volumes, sd_keras,
                                      tmp_path):
    """``predict_and_save`` with the Keras model over volumes 1, 2 and 21
    of the bench scene keeps JAX's cells (``seg/coords``)."""
    from t3dct_torch.engine.stardist import predict_and_save
    from t3dct_torch.io.imageio import save_label_slices
    vols = bench_volumes[0]
    ts = (1, 2, N_VOLS)
    for t in ts:
        save_label_slices(vols[t - 1].transpose(1, 2, 0), tmp_path / "raw",
                          "raw_t%03i_z%04i.tif", t, use_8_bit=False,
                          compression=None)
    predict_and_save(str(tmp_path / "raw" / "raw_t%03i_z*.tif"), sd_keras,
                     tmp_path / "results", volumes=list(ts))
    for t in ts:
        same_cells(np.load(tmp_path / "results" / "seg" /
                           f"coords{t:06d}.npy"), record[f"seg_coords_{t}"])


@pytest.mark.slow
def test_port_on_cpu_matches_record(record, tmp_path):
    """The port's ``segment_and_track(handoff="device")`` on the CPU over
    the whole bench scene with the Keras model, held to the record with
    ``chip_smoke.py``'s bounds for the phase."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import segment_and_track
    pattern, centers = chip_smoke.write_bench_scene(tmp_path)
    model = load_stardist_model("sd_keras", str(KERAS_ASSETS), device="cpu")
    model.max_candidates, model.render_box = MAX_CANDIDATES, RENDER_BOX
    results = tmp_path / "results"
    coords = segment_and_track(
        pattern, model, results, str(results / "manual_vol1" / "*.tif"),
        BENCH_ASSETS / "ffn.npz", (1.0, 1.0, 9.2), 10, (1, N_VOLS),
        TrackingConfig(beta=3.0, lambda_=3.0), verbose=False,
        handoff="device", device="cpu")
    hold_keras_to_record(record, results, coords, centers)

if __name__ == "__main__":
    import argparse
    import os
    import tempfile
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="write assets/keras/sd_keras/ and "
                         "assets/keras/jax_record_keras.npz (JAX and "
                         "TensorFlow on the CPU)")
    args = ap.parse_args()
    if not args.write:
        ap.error("nothing to do without --write")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    KERAS_ASSETS.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        m = write_record(RECORD, Path(tmp))
    print(json.dumps(m))
    for p in sorted(KERAS_ASSETS.rglob("*")):
        if p.is_file():
            print(f"{p.relative_to(REPO)}: {p.stat().st_size} bytes")
