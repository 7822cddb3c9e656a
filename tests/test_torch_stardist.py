"""StarDist network, candidates, NMS, render and the instance program of
the port against the JAX package, on the CPU, with the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.models.stardist3d import sparse_candidates as jsparse
from t3dct.ops.nms import greedy_nms as jgreedy
from t3dct.ops.nms import overlap_matrix as joverlap
from t3dct.ops.nms import render_polyhedra_labels as jrender
from t3dct.ops.rays import rays_golden_spiral as jrays
from t3dct.utils.checkpoint import save_pytree
from t3dct_torch.engine.stardist import StarDist3D
from t3dct_torch.models.stardist3d import sparse_candidates
from t3dct_torch.ops.nms import (greedy_nms, overlap_matrix,
                                 render_polyhedra_labels)
from t3dct_torch.ops.rays import rays_golden_spiral
from t3dct_torch.utils.convert import load_npz, stardist_params_from_numpy
from test_torch_scene import (SD_CFG, recording, stardist_pair,
                              stardist_params, to_jax)


def _conv_bound(ref):
    # f32 accumulation in a different summation order
    return 1e-5 * float(np.abs(ref).max()) + 1e-6


@pytest.fixture(scope="module")
def models():
    return stardist_pair()


def test_rays_identical():
    np.testing.assert_array_equal(rays_golden_spiral(96, (9.2, 1, 1)),
                                  jrays(96, (9.2, 1, 1)))


def test_network_forward_matches(models):
    jm, tm = models
    x = np.random.RandomState(3).rand(1, 8, 32, 48, 1).astype(np.float32)
    jp, jd = jm.net.apply(jm.params, jnp.asarray(x))
    tp, td = tm.net.apply(tm.params, torch.from_numpy(x))
    assert tp.shape == jp.shape and td.shape == jd.shape
    jp, jd = np.asarray(jp), np.asarray(jd)
    assert np.abs(tp.numpy() - jp).max() <= _conv_bound(jp)
    assert np.abs(td.numpy() - jd).max() <= _conv_bound(jd)


def test_network_forward_random_weights():
    """Plain seeded weights (no pass-through path), also through the
    numpy converter, match too."""
    from t3dct.config import StarDistConfig as JCfg
    from t3dct.models.stardist3d import StarDist3DNet as JNet
    from t3dct_torch.config import StarDistConfig
    from t3dct_torch.models.stardist3d import StarDist3DNet
    params = to_jax(stardist_params(seed=4, intensity_path=False))
    x = np.random.RandomState(5).rand(1, 4, 16, 16, 1).astype(np.float32)
    jp, jd = JNet(JCfg(**SD_CFG)).apply(params, jnp.asarray(x))
    tp, td = StarDist3DNet(StarDistConfig(**SD_CFG)).apply(
        stardist_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          params), "cpu"),
        torch.from_numpy(x))
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= _conv_bound(jp)
    assert np.abs(td.numpy() - np.asarray(jd)).max() <= _conv_bound(jd)


@pytest.mark.parametrize("fused_up", [False, True])
def test_network_fused_up_matches_jax(fused_up):
    """``StarDist3DNet(fused_up=)``, JAX's option: the port's net with it
    against JAX's ``fused_up=True`` net (the sub-pixel decomposition of
    the up-blocks, the same network) within f32 summation order."""
    from t3dct.config import StarDistConfig as JCfg
    from t3dct.models.stardist3d import StarDist3DNet as JNet
    from t3dct_torch.config import StarDistConfig
    from t3dct_torch.models.stardist3d import StarDist3DNet
    tparams = stardist_params(seed=6, intensity_path=False)
    x = np.random.RandomState(7).rand(1, 4, 16, 16, 1).astype(np.float32)
    jp, jd = JNet(JCfg(**SD_CFG), fused_up=True).apply(to_jax(tparams),
                                                       jnp.asarray(x))
    net = StarDist3DNet(StarDistConfig(**SD_CFG), fused_up=fused_up)
    assert net.fused_up is fused_up
    tp, td = net.apply(tparams, torch.from_numpy(x))
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= _conv_bound(jp)
    assert np.abs(td.numpy() - np.asarray(jd)).max() <= _conv_bound(jd)


def _candidates(seed, k=48, plateau=False):
    rng = np.random.RandomState(seed)
    prob = rng.rand(6, 16, 12).astype(np.float32)
    if plateau:     # equal-prob plateaus: top-k ties toward the lower index
        prob = np.round(prob * 4) / 4
    dist = (rng.rand(6, 16, 12, 32) * 4 + 0.5).astype(np.float32)
    return prob, dist, k


@pytest.mark.parametrize("k", [48, 2000])
@pytest.mark.parametrize("plateau", [False, True])
def test_sparse_candidates_exact(plateau, k):
    """k = 2000 exceeds the grid: the result pads with invalid slots."""
    prob, dist, _ = _candidates(1, plateau=plateau)
    want = jsparse(jnp.asarray(prob), jnp.asarray(dist), (1, 2, 2), 0.3,
                   max_candidates=k, lmax_prefilter=True)
    got = sparse_candidates(torch.from_numpy(prob), torch.from_numpy(dist),
                            (1, 2, 2), 0.3, max_candidates=k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("neighbor_limit", [0, 8])
def test_overlap_nms_render_exact(neighbor_limit):
    """Overlaps agree to f32 rounding; kept mask and labels exactly."""
    rng = np.random.RandomState(2)
    k = 24
    centers = np.stack([rng.randint(1, 7, k), rng.randint(2, 30, k),
                        rng.randint(2, 22, k)], 1).astype(np.float32)
    dists = (rng.rand(k, 32) * 3 + 1.5).astype(np.float32)
    prob = rng.rand(k).astype(np.float32)
    valid = rng.rand(k) < 0.9
    rays = rays_golden_spiral(32, (4.0, 1, 1))
    jov = joverlap(jnp.asarray(centers), jnp.asarray(dists),
                   jnp.asarray(rays), jnp.asarray(valid),
                   neighbor_limit=neighbor_limit, prob=jnp.asarray(prob))
    tc, td, tr = (torch.from_numpy(a) for a in (centers, dists, rays))
    tov = overlap_matrix(tc, td, tr, torch.from_numpy(valid),
                         neighbor_limit=neighbor_limit,
                         prob=torch.from_numpy(prob))
    np.testing.assert_allclose(tov.numpy(), np.asarray(jov), atol=1e-6)
    jkept = np.asarray(jgreedy(jnp.asarray(prob), jov, jnp.asarray(valid),
                               0.3))
    tkept = greedy_nms(torch.from_numpy(prob), tov, torch.from_numpy(valid),
                       0.3)
    np.testing.assert_array_equal(tkept.numpy(), jkept)
    assert 0 < jkept.sum() < valid.sum()
    jlab = np.asarray(jrender(jnp.asarray(centers), jnp.asarray(dists),
                              jnp.asarray(rays), jnp.asarray(prob),
                              jnp.asarray(jkept), (8, 32, 24), (5, 17, 17)))
    tlab = render_polyhedra_labels(tc, td, tr, torch.from_numpy(prob),
                                   tkept, (8, 32, 24), (5, 17, 17))
    np.testing.assert_array_equal(tlab.numpy(), jlab)


@pytest.mark.parametrize("t", [0, 1])
def test_instance_program_exact(models, t):
    """The whole per-volume seg program from the raw uint16 volume:
    candidates, NMS kept set and rendered labels exactly; probs, dists and
    the f16 prob map to the network's f32 rounding."""
    jm, tm = models
    vol = recording(2)[0][t]
    mi, ma = np.percentile(vol, (1.0, 99.8))
    want = [np.asarray(a) for a in jm._predict_instances_device(
        vol, norm_minmax=(mi, ma), return_labels=True)]
    got = [a.numpy() for a in tm.predict_instances_device(
        torch.from_numpy(vol.astype(np.int32)),
        norm_minmax=(np.float32(mi), np.float32(ma)), return_labels=True)]
    kept, probs, dists, points, prob_map, labels = got
    np.testing.assert_array_equal(kept, want[0])
    np.testing.assert_array_equal(points, want[3])
    np.testing.assert_array_equal(labels.astype(np.int64),
                                  want[5].astype(np.int64))
    assert np.abs(probs - want[1]).max() <= 1e-6
    assert np.abs(dists - want[2]).max() <= _conv_bound(want[2])
    assert prob_map.dtype == np.float16
    assert np.abs(prob_map.astype(np.float32)
                  - want[4].astype(np.float32)).max() <= 1e-3
    assert 8 <= kept.sum() <= 14          # one detection per cell, about


def test_load_reads_jax_model_dir(models, tmp_path):
    """``StarDist3D.load`` reads a JAX-package model folder with numpy."""
    jm, _ = models
    jm.save(tmp_path)
    tm = StarDist3D.load(tmp_path, device="cpu")
    assert tm.config.grid == (1, 2, 2)
    assert tm.thresholds == {"prob": 0.3, "nms": 0.3}
    for name, layer in jm.params.items():
        for key, v in layer.items():
            np.testing.assert_array_equal(tm.params[name][key].numpy(),
                                          np.asarray(v))


def test_load_npz_nested(tmp_path):
    tree = ({"feat": {"w": np.ones((2, 3), np.float32)}},
            {"bn": {"mean": np.zeros(3, np.float32)}})
    save_pytree(tree, tmp_path / "t.npz")
    got = load_npz(tmp_path / "t.npz")
    np.testing.assert_array_equal(got["0"]["feat"]["w"], tree[0]["feat"]["w"])
    np.testing.assert_array_equal(got["1"]["bn"]["mean"],
                                  tree[1]["bn"]["mean"])


def test_ray_helpers_match():
    """Volumes, interior sampling and the ray LUT against the JAX twins."""
    from t3dct.ops import rays as jr
    from t3dct_torch.ops import rays as tr
    rng = np.random.RandomState(8)
    rays = rays_golden_spiral(32, (4.0, 1, 1))
    dists = (rng.rand(5, 32) * 3 + 1).astype(np.float32)
    np.testing.assert_allclose(
        tr.polyhedron_volumes(torch.from_numpy(dists),
                              torch.from_numpy(rays)).numpy(),
        np.asarray(jr.polyhedron_volumes(jnp.asarray(dists),
                                         jnp.asarray(rays))), rtol=1e-6)
    lut = tr.nearest_ray_lut(rays)
    np.testing.assert_array_equal(lut, jr.nearest_ray_lut(rays))
    dirs = rays_golden_spiral(200)
    np.testing.assert_array_equal(
        tr.lut_ray_index(torch.from_numpy(lut), torch.from_numpy(dirs))
        .numpy(),
        np.asarray(jr.lut_ray_index(jnp.asarray(lut), jnp.asarray(dirs))))
    fr = ((np.arange(4) + 0.5) / 4) ** (1 / 3)
    sdirs = rays_golden_spiral(16)
    center = np.float32([3, 10, 12])
    np.testing.assert_allclose(
        tr.sample_points_in_polyhedron(
            torch.from_numpy(center), torch.from_numpy(dists[0]),
            torch.from_numpy(rays), torch.from_numpy(sdirs), fr).numpy(),
        np.asarray(jr.sample_points_in_polyhedron(
            jnp.asarray(center), jnp.asarray(dists[0]), jnp.asarray(rays),
            jnp.asarray(sdirs), fr)), atol=1e-5)
