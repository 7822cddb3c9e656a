"""The legacy U-Net's front half of the port against the JAX package, on the
CPU: box filters, LCN, tiling and the U-Net forward (variants a, b, c at
narrow widths, float32 on both sides, the same weights through
``unet_from_numpy``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.engine.segmentation import UNetSegmenter as JSegmenter
from t3dct.config import SegmentationConfig as JSegConfig
from t3dct.models.unet3d import UNet3D as JUNet3D
from t3dct.ops.filters import box_mean as jbox_mean
from t3dct_torch.config import SegmentationConfig
from t3dct_torch.engine.segmentation import UNetSegmenter
from t3dct_torch.models import layers
from t3dct_torch.models.unet3d import (UNet3D, get_unet, unet3_a,
                                       with_intensity_path)
from t3dct_torch.ops import lcn, tiling
from t3dct_torch.ops.filters import box_mean
from t3dct_torch.utils.convert import unet_from_numpy

# ``t3dct.ops`` re-exports functions under these module names
jlcn = importlib.import_module("t3dct.ops.lcn")
jtiling = importlib.import_module("t3dct.ops.tiling")

# float32 LCN: the JAX box sums are a float32 running sum, the port's a
# float64 one rounded once; relative to the output's scale they agree to
LCN_RTOL = 1e-5
PROB_ATOL = 1e-5

# narrow versions of the three variants: same depth, pools and activations
NARROW = {
    "a": dict(variant="a", tile_shape=(24, 24, 8), pool=(2, 2, 1),
              down_filters=((4, 6), (6, 8), (8, 12)),
              up_filters=((12, 12), (8, 8), (6, 6)), head_filters=(4, 4),
              activation="leaky_relu"),
    "b": dict(variant="b", tile_shape=(16, 16, 8), pool=(2, 2, 1),
              down_filters=((6, 6), (8, 8)), up_filters=((12, 12), (8, 8)),
              head_filters=(6, 6), activation="relu"),
    "c": dict(variant="c", tile_shape=(16, 16, 16), pool=(2, 2, 2),
              down_filters=((4, 6), (6, 8), (8, 12)),
              up_filters=((12, 12), (8, 8), (6, 6)), head_filters=(4, 4),
              activation="leaky_relu"),
}


def to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.cpu().numpy()),
                                  tree)


def raw_volume(shape=(40, 36, 6), seed=0):
    """Gaussian blobs on noise, microscopy-like counts (float32)."""
    rng = np.random.RandomState(seed)
    xx, yy, zz = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    img = rng.rand(*shape) * 300.0
    for _ in range(6):
        c = rng.uniform((3, 3, 0), shape)
        img += 4000 * np.exp(-((xx - c[0]) ** 2 + (yy - c[1]) ** 2) / 12.0
                             - (zz - c[2]) ** 2 / 2.0)
    return img.astype(np.float32)


def unet_pair(variant, seed=0):
    """(JAX spec, port spec, port params, port state, JAX params, state):
    seeded weights and random BatchNorm statistics, one set of numbers."""
    spec = NARROW[variant]
    tm = UNet3D(**spec)
    params, state = tm.init(torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 100)
    for name in state:
        c = state[name]["mean"].shape[0]
        state[name] = {"mean": torch.randn(c, generator=g) * 0.1,
                       "var": torch.rand(c, generator=g) + 0.5}
        params[name]["bn"] = {"scale": torch.rand(c, generator=g) + 0.5,
                              "bias": torch.randn(c, generator=g) * 0.1}
    for layer in params.values():
        layer["conv"]["b"] = torch.randn(layer["conv"]["b"].shape,
                                         generator=g) * 0.1
    return JUNet3D(**spec), tm, params, state, to_jax(params), to_jax(state)


@pytest.mark.parametrize("size", [(27, 27, 1), (5, 4, 3)])
def test_box_mean_matches(size):
    x = raw_volume(seed=1)
    want = np.asarray(jbox_mean(jnp.asarray(x), size, mode="zero"))
    got = box_mean(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("noise", [5.0, 200.0])
def test_lcn_matches(noise):
    x = raw_volume(seed=2)
    want = np.asarray(jlcn.lcn(jnp.asarray(x), noise))
    got = lcn.lcn(torch.from_numpy(x), noise).numpy()
    np.testing.assert_allclose(got, want, rtol=LCN_RTOL,
                               atol=LCN_RTOL * np.abs(want).max())


@pytest.mark.parametrize("stride", [1, 61])
def test_normalize_image_matches(stride):
    """With stride 61 the (40, 36, 6) volume gives a 142-voxel sample: an
    even count, whose median is the mean of the two middle values."""
    x = raw_volume(seed=3)
    assert x.reshape(-1)[::61].size % 2 == 0
    want = np.asarray(jlcn.normalize_image(jnp.asarray(x), 20.0,
                                           median_stride=stride))
    got = lcn.normalize_image(torch.from_numpy(x), 20.0,
                              median_stride=stride).numpy()
    np.testing.assert_allclose(got, want, rtol=LCN_RTOL,
                               atol=LCN_RTOL * np.abs(want).max())


@pytest.mark.parametrize("n", [1, 2, 7, 142])
def test_median_midpoint_even_and_odd(n):
    x = np.random.RandomState(n).rand(n).astype(np.float32) * 1000
    want = np.float32(np.asarray(jnp.median(jnp.asarray(x))))
    got = lcn.median_midpoint(torch.from_numpy(x)).numpy()
    assert got == want
    if n % 2 == 0:
        # torch.median takes the lower middle value: not the JAX median
        assert float(torch.median(torch.from_numpy(x))) != float(want)


@pytest.mark.parametrize("vol,tile,shrink", [
    ((40, 36, 6), (24, 24, 8), (4, 4, 2)),
    ((401, 168, 24), (160, 160, 16), (24, 24, 2)),
    ((9, 30, 3), (16, 16, 8), (2, 3, 3)),
])
def test_tiling_exact(vol, tile, shrink):
    """Plan, reflect pad (also pads longer than the axis), tile gather and
    stitch, bit for bit; the stitch of the tiles is the volume."""
    jp = jtiling.plan_tiles(vol, tile, shrink)
    tp = tiling.plan_tiles(vol, tile, shrink)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x = np.random.RandomState(4).rand(*vol).astype(np.float32)
    jpad = jtiling.pad_for_tiles(jnp.asarray(x), jp)
    tpad = tiling.pad_for_tiles(torch.from_numpy(x), tp)
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    jt = jtiling.extract_tiles(jpad, jp)
    tt = tiling.extract_tiles(tpad, tp)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tiling.stitch_tiles(tt, tp).numpy(),
                                  np.asarray(jtiling.stitch_tiles(jt, jp)))
    np.testing.assert_array_equal(tiling.stitch_tiles(tt, tp).numpy(), x)


@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_unet_apply_matches(variant):
    jm, tm, tp, ts, jp, js = unet_pair(variant)
    rng = np.random.RandomState(5)
    x = rng.randn(2, *tm.tile_shape, 1).astype(np.float32)
    want = np.asarray(jm.apply(jp, js, jnp.asarray(x), train=False,
                               compute_dtype=jnp.float32)[0])
    got = tm.apply(tp, ts, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *tm.tile_shape, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_unet_from_numpy_keeps_the_tree(variant):
    """The JAX init's pytree converts leaf for leaf, with the port's init's
    keys and shapes."""
    jm = JUNet3D(**NARROW[variant])
    jparams, jstate = jm.init(jax.random.PRNGKey(0))
    tp, ts = unet_from_numpy(jax.device_get(jparams), jax.device_get(jstate),
                             "cpu")
    mine, mine_s = UNet3D(**NARROW[variant]).init(
        torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), (tp, ts))
    want = jax.tree_util.tree_map(lambda t: tuple(t.shape), (mine, mine_s))
    assert shapes == want
    np.testing.assert_array_equal(tp["down0_0"]["conv"]["w"].numpy(),
                                  np.asarray(jparams["down0_0"]["conv"]["w"]))


def test_reference_variants_match_the_jax_specs():
    from t3dct.models.unet3d import get_unet as jget
    for v in "abc":
        assert dataclass_fields(get_unet(v)) == dataclass_fields(jget(v))


def dataclass_fields(spec):
    import dataclasses
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def test_batched_conv_equals_per_volume():
    """One conv call on a batch equals the per-volume calls (the CPU plain
    path the kernel's batch launch is held to on the card)."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn((3, 10, 9, 8, 5), generator=g)
    p = layers.init_conv3d((3, 3, 3), 5, 7, g, "cpu")
    got = layers.conv3d(p, x)
    # the CPU convolution blocks a batch differently: f32 summation order
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(),
                                   layers.conv3d(p, x[i:i + 1])[0].numpy(),
                                   rtol=0, atol=1e-5)


def test_intensity_path_follows_the_lcn():
    """The stand-in weights: probability > 0.5 exactly where the
    normalized intensity clears the threshold (up to the BatchNorms'
    scaling), whatever the random weights elsewhere."""
    spec = UNet3D(**NARROW["a"])
    params, state = spec.init(torch.Generator().manual_seed(7), device="cpu")
    params = with_intensity_path(params, spec, threshold=1.0)
    x = torch.randn((1, *spec.tile_shape, 1),
                    generator=torch.Generator().manual_seed(8)) * 2
    prob = spec.apply(params, state, x)[..., 0]
    h = x[..., 0] * (1.0 + 1e-3) ** -2.0   # two BN'd pass-through blocks
    h = h * (1.0 + 1e-3) ** -(len(spec.head_filters) / 2.0)
    sure = (h - 1.0).abs() > 1e-3
    np.testing.assert_array_equal((prob > 0.5)[sure].numpy(),
                                  (h > 1.0)[sure].numpy())


def test_segmenter_predict_matches():
    """LCN (stride-61 median) + reflect pad + tile batch + U-Net + stitch,
    float32 on both sides (the JAX segmenter built with
    ``compute_dtype=float32``; its default is bfloat16)."""
    jm, tm, tp, ts, jp, js = unet_pair("a", seed=9)
    cfg = dict(noise_level=20.0, shrink=(4, 4, 2))
    x = raw_volume((40, 36, 6), seed=10)
    jseg = JSegmenter(jm, jp, js, JSegConfig(**cfg), x.shape, max_cells=64,
                      compute_dtype=jnp.float32)
    tseg = UNetSegmenter(tm, tp, ts, SegmentationConfig(**cfg), x.shape,
                         max_cells=64, device="cpu")
    want = np.asarray(jseg._predict_impl(jp, js, jnp.asarray(x)))
    got = tseg.predict_cellregions(x).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def test_unet3_a_is_the_reference_model():
    spec = unet3_a()
    plan, c_last = spec.block_plan()
    assert [c for _, _, c in plan] == [8, 16, 16, 32, 32, 64, 64, 64, 32,
                                       32, 16, 16, 8, 8]
    assert c_last == 8 and spec.tile_shape == (160, 160, 16)
