"""The legacy U-Net's halo mode over a mesh of four ``gloo`` ranks on the
CPU (``tests/torch_mesh_ranks.py::halo_cases``, one spawned world for the
file), and the segmenter's mesh ``ValueError``s.

The volume is split along x in four shards of 56 voxels, the default halo
(narrow U-Net a's receptive radius, 51, rounded up to its x pool factor,
8).  In f32 the segmenter's probabilities equal JAX's halo mode over four
of conftest's CPU devices within ``tests/test_torch_unet.py``'s
``PROB_ATOL``.  In bf16 the network is chaotic (each layer rounds its
input again), so it is held per layer as ``tests/test_torch_bf16.py``
holds it (C.6): each rank's extended shard, which must equal its slice of
the zero-extended volume exactly (the exchange), goes through JAX's bf16
U-Net with its layers recorded, and each port layer fed JAX's own input
agrees within ``TOL`` of sum |x w| + |b|."""

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
from t3dct.models.unet3d import UNet3D as JUNet3D
from t3dct_torch.config import SegmentationConfig
from t3dct_torch.engine.segmentation import UNetSegmenter
from t3dct_torch.parallel import make_mesh, multihost
from test_torch_bf16 import hold_layers, record_jax_convs
from test_torch_unet import NARROW, PROB_ATOL, unet_pair
from test_torch_unet import raw_volume as unet_raw

WORLD = 4
SEG_CFG = dict(noise_level=20.0, shrink=(4, 4, 2))
SHAPE = (224, 16, 4)
HALO = 56


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_unet")
    jm, _, params, state, jp, js = unet_pair("a", seed=9)
    torch.save((NARROW["a"], params, state), root / "unet.pt")
    raw = unet_raw(SHAPE, seed=12)
    torch.save(raw, root / "raw.pt")
    batch = torch.from_numpy((np.random.RandomState(13).randn(
        1, *SHAPE, 1) * 2).astype(np.float32))
    torch.save(batch, root / "batch.pt")
    run = ranks.World(WORLD, "halo_cases", root / "w",
                      unet=str(root / "unet.pt"), raw=str(root / "raw.pt"),
                      batch=str(root / "batch.pt"), seg_cfg=SEG_CFG,
                      halo=HALO)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(1, WORLD),
                ("data", "spatial"))
    seg = JSegmenter(jm, jp, js, JSegConfig(**SEG_CFG), SHAPE, max_cells=64,
                     compute_dtype=jnp.float32, mesh=mesh, mesh_mode="halo")
    assert seg.halo == HALO
    return (run.results(), np.asarray(seg.predict_cellregions(raw)), batch,
            params, jp, js)


def test_halo_f32_matches_jax_mesh(world):
    """Every rank holds the whole probability map, the same on each, JAX's
    within ``PROB_ATOL``."""
    results, want, _, _, _, _ = world
    got = results[0]["halo_f32"]
    for rank in range(1, WORLD):
        assert torch.equal(results[rank]["halo_f32"], got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_ATOL)


def test_halo_exchange_is_exact(world):
    """Rank i's model input is its x shard with its neighbours' ``HALO``
    edge planes, zeros past the volume's x faces: the slice of the
    zero-extended volume, bit for bit; every rank gathers the same
    output."""
    results, _, batch, _, _, _ = world
    shard = SHAPE[0] // WORLD
    ext = torch.nn.functional.pad(batch, (0, 0, 0, 0, 0, 0, HALO, HALO))
    for rank in range(WORLD):
        got = results[rank]["ext"]
        assert torch.equal(got, ext[:, rank * shard:
                                    rank * shard + shard + 2 * HALO])
        assert torch.equal(results[rank]["bf16"], results[0]["bf16"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_halo_bf16_per_layer(world, rank, monkeypatch):
    """Rank ``rank``'s extended shard through JAX's bf16 U-Net, every conv
    recorded; the port's layer on JAX's input to it within ``TOL``."""
    results, _, _, params, jp, js = world
    names = {id(jp[n]["conv"]): n for n in jp}
    calls = record_jax_convs(monkeypatch)
    JUNet3D(**NARROW["a"]).apply(
        jp, js, jnp.asarray(results[rank]["ext"].numpy()),
        compute_dtype=jnp.bfloat16)
    held = hold_layers(calls, names, lambda n: params[n]["conv"])
    assert len(held) == len(jp)


@pytest.fixture
def world_of_one(tmp_path):
    multihost.initialize(device="cpu", store=str(tmp_path / "store"))
    try:
        yield make_mesh(1, device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("halo,match", [
    (12, "multiple of the total x pool factor 8"),
    (None, r"halo \(56\) exceeds the per-device x shard \(16")])
def test_segmenter_halo_raises(world_of_one, halo, match):
    """JAX's two ``ValueError``s: a halo off the pooling grid, and one
    wider than a rank's x shard (a (16, 16, 4) volume on one rank)."""
    spec, params, state = unet_pair("a", seed=9)[1:4]
    with pytest.raises(ValueError, match=match):
        UNetSegmenter(spec, params, state, SegmentationConfig(**SEG_CFG),
                      (16, 16, 4), mesh=world_of_one, mesh_mode="halo",
                      halo=halo)
    with pytest.raises(ValueError, match="mesh_mode must be"):
        UNetSegmenter(spec, params, state, SegmentationConfig(**SEG_CFG),
                      (16, 16, 4), mesh=world_of_one, mesh_mode="rows")
