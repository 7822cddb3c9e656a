"""Tiles over a mesh of two ``gloo`` ranks on the CPU
(``tests/torch_mesh_ranks.py::tiles_cases``, one spawned world for the
file): ``StarDist3D.predict_instances_sharded`` over a mesh and over the
world (``mesh=None``), the ``UNetSegmenter``'s tile mode in f32 and bf16,
and its halo mode over two ranks in f32.

Each tile-parallel run equals the port's run without a mesh bit for bit
(``predict_instances_tiled``; the segmenter's one-card sweep, its
probabilities and its labels).  Each rank's share holds at least two
tiles: on the CPU the plain conv (oneDNN) sums a batch of one in another
order than a larger batch, while batches of two or more agree (the card's
kernels are batch-independent, ``chip_smoke.py``'s mesh phase).  Against
JAX over two of conftest's CPU devices: the sharded instances within
``tests/test_torch_tiled.py``'s ``PROB_TOL`` (points and labels exact),
the f32 segmenter's tile and halo modes within
``tests/test_torch_unet.py``'s ``PROB_ATOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import t3dct_torch  # noqa: F401
import torch_mesh_ranks as ranks
from t3dct.config import SegmentationConfig as JSegConfig
from t3dct.engine.segmentation import UNetSegmenter as JSegmenter
from test_torch_tiled import (CFG, MODEL, TILE,  # noqa: F401
                              assert_same_instances, models, normalized,
                              raw_volume)
from test_torch_unet import NARROW, PROB_ATOL, unet_pair
from test_torch_unet import raw_volume as unet_raw

WORLD = 2
SEG_CFG = dict(noise_level=20.0, shrink=(4, 4, 2))
UNET_SHAPE = (40, 36, 6)        # 18 tiles of (24, 24, 8): 9 a rank
HALO_SHAPE = (112, 16, 4)       # two x shards of 56, the default halo


@pytest.fixture(scope="module")
def world(tmp_path_factory, models):
    jm, tm = models
    root = tmp_path_factory.mktemp("mesh_tiles")
    x = normalized(raw_volume(1))
    torch.save(x, root / "x.pt")
    torch.save(tm.params, root / "sd.pt")
    _, _, params, state, jp, js = unet_pair("a", seed=9)
    torch.save((NARROW["a"], params, state), root / "unet.pt")
    raw = unet_raw(UNET_SHAPE, seed=10)
    halo_raw = unet_raw(HALO_SHAPE, seed=11)
    torch.save(raw, root / "raw.pt")
    torch.save(halo_raw, root / "halo_raw.pt")
    run = ranks.World(
        WORLD, "tiles_cases", root / "w", sd_cfg=CFG, sd_model=MODEL,
        sd_params=str(root / "sd.pt"), x=str(root / "x.pt"), tile=TILE,
        unet=str(root / "unet.pt"), raw=str(root / "raw.pt"),
        seg_cfg=SEG_CFG, halo_raw=str(root / "halo_raw.pt"))
    from t3dct.models.unet3d import UNet3D as JUNet3D
    jmesh = Mesh(np.array(jax.devices()[:WORLD]), ("tiles",))
    want = {"sharded": jm.predict_instances_sharded(x, mesh=jmesh,
                                                    tile_shape=TILE)}
    for mode, shape, vol in (("tiles", UNET_SHAPE, raw),
                             ("halo", HALO_SHAPE, halo_raw)):
        mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(1, WORLD),
                    ("data", "spatial"))
        seg = JSegmenter(JUNet3D(**NARROW["a"]), jp, js,
                         JSegConfig(**SEG_CFG), shape, max_cells=64,
                         compute_dtype=jnp.float32, mesh=mesh,
                         mesh_mode=mode,
                         spatial_axis="spatial" if mode == "tiles" else None)
        want[mode] = np.asarray(seg.predict_cellregions(vol))
    return run.results(), want


def test_sharded_equals_tiled(world):
    """Every rank, over the mesh and over the world, returns
    ``predict_instances_tiled``'s instances and prob map bit for bit."""
    results, _ = world
    (w_lab, w_det), w_prob = results[0]["tiled"]
    assert 4 <= len(w_det["points"])
    for rank in range(WORLD):
        for key in ("sharded", "sharded_world"):
            (lab, det), prob = results[rank][key]
            np.testing.assert_array_equal(prob, w_prob)
            np.testing.assert_array_equal(lab, w_lab)
            for k in ("points", "prob", "dist"):
                np.testing.assert_array_equal(det[k], w_det[k])


def test_sharded_matches_jax_mesh(world):
    results, want = world
    assert_same_instances(results[0]["sharded"], want["sharded"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_mode_equals_one_card(world, dtype):
    """The tile batch split over the ranks: every rank's probabilities and
    labels are the one-card sweep's, bit for bit."""
    results, _ = world
    w_probs, w_labels = results[0][f"plain_{dtype}"]
    assert int(w_labels.max()) > 0
    for rank in range(WORLD):
        probs, labels = results[rank][f"tiles_{dtype}"]
        assert probs.dtype == torch.float32
        assert torch.equal(probs, w_probs) and torch.equal(labels, w_labels)


@pytest.mark.parametrize("mode", ["tiles", "halo"])
def test_segmenter_mesh_matches_jax_mesh(world, mode):
    """The f32 segmenter over two ranks against JAX's over two devices,
    within ``PROB_ATOL``: tile mode, and halo mode (the whole volume in two
    x shards with the default halo, every voxel exact up to f32
    summation order)."""
    results, want = world
    got = results[0]["tiles_float32"][0] if mode == "tiles" else \
        results[0]["halo_f32"]
    for rank in range(1, WORLD):
        other = results[rank]["tiles_float32"][0] if mode == "tiles" else \
            results[rank]["halo_f32"]
        assert torch.equal(other, got)
    assert got.shape == want[mode].shape
    np.testing.assert_allclose(got.numpy(), want[mode], rtol=0,
                               atol=PROB_ATOL)


def test_tile_plan_splits_as_the_test_assumes(models):
    """Each rank's share of the test's tile batches holds at least two
    tiles (see the module docstring)."""
    from t3dct_torch.ops import plan_tiles
    plan = plan_tiles(UNET_SHAPE, NARROW["a"]["tile_shape"],
                      SEG_CFG["shrink"])
    assert len(plan.origins) // WORLD >= 2
    _, tm = models
    vol = raw_volume(1).shape
    assert len(tm.plan_tiling(vol, TILE).origins) // WORLD >= 2
