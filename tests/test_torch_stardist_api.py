"""The port's StarDist3D per-volume API and the network pieces its tiled
path stands on, against the JAX package on the CPU with the same weights:
``StarDist3DNet.receptive_field``, ``neighborhood_max_3x3x3``,
``sparse_candidates`` in both ``lmax_prefilter`` modes,
``upsample_prob_map``, ``StarDist3D.predict_sparse`` / ``predict`` /
``predict_instances`` (sparse, dense, ``return_predict``), and
``StarDist3D(config)`` with ``params=None``.

Tolerances: network outputs to f32 summation order (``_conv_bound``);
candidates, kept sets and labels exact; the instance program's float16
prob map to one float16 step (1e-3)."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.config import StarDistConfig as JStarDistConfig
from t3dct.models.stardist3d import StarDist3DNet as JNet
from t3dct.models.stardist3d import neighborhood_max_3x3x3 as j_neigh
from t3dct.models.stardist3d import sparse_candidates as j_sparse
from t3dct.models.stardist3d import upsample_prob_map as j_upsample
from t3dct_torch.config import StarDistConfig
from t3dct_torch.engine.stardist import StarDist3D
from t3dct_torch.models.stardist3d import (StarDist3DNet,
                                           neighborhood_max_3x3x3,
                                           sparse_candidates,
                                           upsample_prob_map)
from t3dct_torch.utils.device import upload_raw
from test_torch_scene import REPO, recording, stardist_pair

CONFIGS = {
    # JAX's tests/test_stardist_tiled.py::_cfg_small
    "small": dict(n_rays=8, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0),
                  unet_n_depth=1, unet_n_filter_base=4,
                  net_conv_after_unet=8, train_patch_size=(16, 32, 32),
                  prob_thresh=0.6, nms_thresh=0.3),
    # examples/segment_large_volume.py
    "example": dict(n_rays=32, grid=(2, 4, 4), anisotropy=(2.0, 1.0, 1.0),
                    unet_n_depth=1, unet_n_filter_base=8,
                    net_conv_after_unet=16, train_patch_size=(16, 32, 32),
                    prob_thresh=0.8, nms_thresh=0.3),
}


def config_kw(name):
    if name != "bench":
        return CONFIGS[name]
    raw = json.loads((REPO / "3deecelltracker_tpu_torch" / "assets" /
                      "bench" / "sd_model" / "config.json").read_text())
    raw.pop("arch")
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in raw.items()}


def _conv_bound(ref):
    return 1e-5 * float(np.abs(ref).max()) + 1e-6


@pytest.fixture(scope="module")
def models():
    return stardist_pair()


@pytest.fixture(scope="module")
def volume():
    """Vol 1 of the scene, normalized, cut to a shape off ``div_by``."""
    vol = recording(1)[0][0][:, :61, :45]
    mi, ma = np.percentile(vol, (1.0, 99.8))
    return ((vol - mi) / (ma - mi + 1e-20)).astype(np.float32)


@pytest.mark.parametrize("name,want", [("small", (12, 25, 25)),
                                       ("bench", (28, 57, 57)),
                                       ("example", (25, 51, 51))])
def test_receptive_field(name, want):
    kw = config_kw(name)
    assert StarDist3DNet(StarDistConfig(**kw)).receptive_field() == want
    assert JNet(JStarDistConfig(**kw)).receptive_field() == want


def test_neighborhood_max_exact():
    """Plateaus and edges, and a leading batch axis taken per item."""
    rng = np.random.RandomState(0)
    prob = (np.round(rng.rand(3, 6, 16, 12) * 4) / 4).astype(np.float32)
    got = neighborhood_max_3x3x3(torch.from_numpy(prob)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(j_neigh(jnp.asarray(prob[i]))))


@pytest.mark.parametrize("lmax_prefilter", [True, False])
@pytest.mark.parametrize("k", [48, 2000])
def test_sparse_candidates_both_modes(lmax_prefilter, k):
    rng = np.random.RandomState(1)
    prob = (np.round(rng.rand(6, 16, 12) * 8) / 8).astype(np.float32)
    dist = (rng.rand(6, 16, 12, 8) * 4 - 0.5).astype(np.float32)
    want = j_sparse(jnp.asarray(prob), jnp.asarray(dist), (1, 2, 2), 0.3,
                    max_candidates=k, lmax_prefilter=lmax_prefilter)
    got = sparse_candidates(torch.from_numpy(prob), torch.from_numpy(dist),
                            (1, 2, 2), 0.3, max_candidates=k,
                            lmax_prefilter=lmax_prefilter)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_upsample_prob_map_exact():
    prob = np.random.RandomState(2).rand(5, 9, 7).astype(np.float32)
    for grid, out in (((1, 2, 2), (5, 17, 13)), ((2, 4, 4), (9, 36, 25))):
        np.testing.assert_array_equal(
            upsample_prob_map(torch.from_numpy(prob), grid, out).numpy(),
            np.asarray(j_upsample(jnp.asarray(prob), grid, out)))


def test_predict_sparse_matches_jax(models, volume):
    jm, tm = models
    want = [np.asarray(a) for a in jm.predict_sparse(volume)]
    got = [a.numpy() for a in tm.predict_sparse(volume)]
    for i in (2, 3):                       # points and valid
        np.testing.assert_array_equal(got[i], want[i])
    assert np.abs(got[0] - want[0]).max() <= 1e-6
    assert np.abs(got[1] - want[1]).max() <= _conv_bound(want[1])
    assert got[4].shape == want[4].shape == (8, 31, 23)
    assert np.abs(got[4] - want[4]).max() <= _conv_bound(want[4])
    assert got[3].sum() >= 4


def test_predict_dense_matches_jax(models, volume):
    jm, tm = models
    (jp, jd), (tp, td) = jm.predict(volume), tm.predict(volume)
    assert tp.shape == jp.shape == (8, 31, 23)
    assert td.shape == jd.shape == (8, 31, 23, 32)
    assert np.abs(tp - jp).max() <= _conv_bound(jp)
    assert np.abs(td - jd).max() <= _conv_bound(jd)


def _same_instances(got, want):
    (g_lab, g_det), (w_lab, w_det) = got, want
    np.testing.assert_array_equal(g_det["points"], w_det["points"])
    assert np.abs(g_det["prob"] - w_det["prob"]).max() <= 1e-6
    assert np.abs(g_det["dist"] - w_det["dist"]).max() <= \
        _conv_bound(w_det["dist"])
    np.testing.assert_array_equal(g_det["rays_vertices"],
                                  w_det["rays_vertices"])
    np.testing.assert_array_equal(np.asarray(g_lab, np.int64),
                                  np.asarray(w_lab, np.int64))


def test_predict_instances_sparse_matches_jax(models, volume):
    jm, tm = models
    (w_inst, w_prob), (g_inst, g_prob) = (jm.predict_instances(volume),
                                          tm.predict_instances(volume))
    _same_instances(g_inst, w_inst)
    assert g_prob.dtype == np.float32 and g_prob.shape == w_prob.shape
    assert np.abs(g_prob - w_prob).max() <= 1e-3      # float16 steps
    assert len(g_inst[1]["points"]) >= 4


def test_predict_instances_dense_and_return_predict(models, volume):
    """``sparse=False`` returns the float32 dense prob map with the same
    instances; ``return_predict=True`` warns as JAX does and returns
    ``(instances, (prob, dist), prob)``."""
    jm, tm = models
    g_inst, g_prob = tm.predict_instances(volume, sparse=False)
    w_inst, w_prob = jm.predict_instances(volume, sparse=False)
    _same_instances(g_inst, w_inst)
    assert np.abs(g_prob - w_prob).max() <= _conv_bound(w_prob)
    with pytest.warns(UserWarning, match="Setting sparse to False"):
        g_inst2, (prob, dist), prob2 = tm.predict_instances(
            volume, return_predict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, (j_prob, j_dist), _ = jm.predict_instances(volume,
                                                      return_predict=True)
    _same_instances(g_inst2, w_inst)
    assert prob2 is prob and prob.shape == j_prob.shape
    assert np.abs(dist - j_dist).max() <= _conv_bound(j_dist)


def test_predict_instances_is_the_instance_program(models, volume):
    """``predict_instances`` is ``predict_instances_device`` (normalizing
    with (0, 1)) and ``finalize_instances``; thresholds pass through."""
    _, tm = models
    out = [None if a is None else a.numpy() for a in
           tm.predict_instances_device(upload_raw(volume, tm.device),
                                       (0.0, 1.0), True, prob_thresh=0.5,
                                       nms_thresh=0.2)]
    (lab, det), prob = tm.finalize_instances(out)
    (lab2, det2), prob2 = tm.predict_instances(volume, prob_thresh=0.5,
                                               nms_thresh=0.2)
    np.testing.assert_array_equal(det["points"], det2["points"])
    np.testing.assert_array_equal(lab, lab2)
    np.testing.assert_array_equal(prob, prob2)


def test_thresholds_under_jax_name(models, tmp_path):
    """``_thresholds`` reads and sets ``thresholds``; ``save``/``load``
    carry them."""
    _, tm = models
    assert tm._thresholds is tm.thresholds
    saved = dict(tm.thresholds)
    try:
        tm._thresholds = {"prob": 0.41, "nms": 0.25}
        assert tm.thresholds == {"prob": 0.41, "nms": 0.25}
        tm.save(tmp_path / "m")
        back = StarDist3D.load(tmp_path / "m", device="cpu")
        assert back._thresholds == {"prob": 0.41, "nms": 0.25}
    finally:
        tm.thresholds = saved


def test_init_without_params():
    """``StarDist3D(config)`` initializes its own weights: the same seed
    (int or generator; default 0) gives the same weights, another seed
    others; ``arch="keras"`` initializes the Keras plan's layers
    (``tests/test_torch_keras.py``), another arch raises."""
    cfg = StarDistConfig(**CONFIGS["small"])
    a = StarDist3D(cfg, max_candidates=512, render_box=(9, 17, 17),
                   device="cpu")
    b = StarDist3D(cfg, rng=0, device="cpu")
    c = StarDist3D(cfg, rng=torch.Generator().manual_seed(0), device="cpu")
    d = StarDist3D(cfg, rng=1, device="cpu")
    assert set(a.params) == {name for name, *_ in a.net.conv_plan()}
    for name in a.params:
        for key in ("w", "b"):
            np.testing.assert_array_equal(a.params[name][key].numpy(),
                                          b.params[name][key].numpy())
            np.testing.assert_array_equal(a.params[name][key].numpy(),
                                          c.params[name][key].numpy())
    assert not np.array_equal(a.params["stem"]["w"].numpy(),
                              d.params["stem"]["w"].numpy())
    assert a.max_candidates == 512 and a.render_box == (9, 17, 17)
    keras = StarDist3D(cfg, arch="keras", device="cpu")
    assert keras.arch == keras.net.arch == "keras"
    assert list(keras.params) == [n for n, *_ in keras.net.conv_plan()]
    assert "pre0_0" in keras.params and "stem" not in keras.params
    with pytest.raises(ValueError, match="arch"):
        StarDist3D(cfg, arch="tf", device="cpu")
    x = np.random.RandomState(3).rand(8, 32, 32).astype(np.float32)
    (labels, details), prob = a.predict_instances(x)
    assert labels.shape == x.shape and prob.shape == (8, 16, 16)


def test_init_weights_run_in_jax():
    """A port init carried to JAX gives JAX's network outputs (the seeds
    differ between the frameworks; the weights are carried, not
    re-seeded)."""
    cfg = StarDistConfig(**CONFIGS["small"])
    tm = StarDist3D(cfg, device="cpu")
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                    tm.params)
    x = np.random.RandomState(4).rand(1, 8, 32, 32, 1).astype(np.float32)
    jp, _ = JNet(JStarDistConfig(**CONFIGS["small"])).apply(
        params, jnp.asarray(x))
    tp, _ = tm.net.apply(tm.params, torch.from_numpy(x))
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= \
        _conv_bound(np.asarray(jp))
