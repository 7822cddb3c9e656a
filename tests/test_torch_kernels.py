"""The two kernel modules of the port against the JAX package, on the CPU:
the wrappers take their plain versions here, and the Pallas kernels run in
interpret mode, as the JAX package's own tests run them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.models import layers as JL
from t3dct.ops.pallas_conv import conv3x3x3_fused
from t3dct.ops.pallas_kernels import flood_slices as jflood_slices
from t3dct.ops.watershed import watershed_flood as jwatershed_flood
from t3dct_torch.models import layers as L
from t3dct_torch.ops.hopper_conv import (conv3x3x3_bias_relu,
                                         conv3x3x3_bias_relu_plain)
from t3dct_torch.ops import hopper_flood
from t3dct_torch.ops.hopper_flood import flood_slices, flood_slices_plain
from t3dct_torch.ops.watershed import watershed_flood


def _conv_bound(ref):
    # f32 accumulation in a different summation order
    return 1e-5 * float(np.abs(ref).max()) + 1e-6


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(4, 12, 10, 1, 8), (4, 12, 10, 8, 16),
                                   (3, 6, 21, 24, 32)])
def test_conv_plain_matches_pallas_and_layers(shape, relu):
    z, y, x, ci, co = shape
    rng = np.random.RandomState(ci + co)
    xin = rng.randn(z, y, x, ci).astype(np.float32)
    w = (rng.randn(3, 3, 3, ci, co) / np.sqrt(27 * ci)).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    want_pallas = np.asarray(conv3x3x3_fused(
        jnp.asarray(xin), jnp.asarray(w), jnp.asarray(b), relu=relu))
    want_layers = np.asarray(JL.conv3d(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        jnp.asarray(xin)[None]))[0]
    if relu:
        want_layers = np.maximum(want_layers, 0.0)
    tx, tw, tb = (torch.from_numpy(a) for a in (xin, w, b))
    got = conv3x3x3_bias_relu(tx, tw, tb, relu=relu).numpy()
    np.testing.assert_array_equal(
        got, conv3x3x3_bias_relu_plain(tx, tw, tb, relu=relu).numpy())
    for want in (want_pallas, want_layers):
        assert np.abs(got - want).max() <= _conv_bound(want)
    # the layer entry point (batched, channels-last) takes the same path
    lay = L.conv3d({"w": tw, "b": tb}, tx[None], relu=relu)[0].numpy()
    np.testing.assert_array_equal(lay, got)


def _flood_case(seed, x=24, y=30, z=3, levels=None):
    rng = np.random.RandomState(seed)
    seg = np.zeros((x, y, z), np.int32)
    seg[4:9, 4:9, :] = 1
    seg[14:19, 20:26, :] = 2
    seg[3:6, 22:27, 1:] = 3
    mask = np.zeros((x, y, z), bool)
    mask[2:22, 2:28, :] = True
    if levels is None:
        elev = rng.rand(x, y, z).astype(np.float32)
    else:   # few distinct elevations: many exact (cost, hops) ties
        elev = rng.randint(0, levels, (x, y, z)).astype(np.float32)
    return elev, seg, mask


@pytest.mark.parametrize("levels", [None, 3, 1])
def test_flood_plain_matches_pallas_and_watershed(levels, monkeypatch):
    elev, seg, mask = _flood_case(levels or 7, levels=levels)
    want = np.asarray(jflood_slices(jnp.asarray(elev), jnp.asarray(seg),
                                    jnp.asarray(mask)))
    want_ws = np.asarray(jax.vmap(
        lambda e, mk, m: jwatershed_flood(e, mk, m, 1),
        in_axes=2, out_axes=2)(jnp.asarray(elev), jnp.asarray(seg),
                               jnp.asarray(mask)))
    np.testing.assert_array_equal(want, want_ws)
    te, ts, tm = (torch.from_numpy(a) for a in (elev, seg, mask))
    got, rounds = flood_slices(te, ts, tm)
    np.testing.assert_array_equal(got.numpy(), want)
    # the host's check interval does not change the labels (fixed point)
    monkeypatch.setattr(hopper_flood, "CHECK_EVERY", 3)
    got_plain, _ = flood_slices_plain(te, ts, tm)
    np.testing.assert_array_equal(got_plain.numpy(), want)
    assert 0 < rounds <= 512


def test_flood_round_cap_matches_jax():
    """Stopped by the cap before the fixed point, both stop at the same
    round (the host checks every few rounds but never runs past the cap)."""
    elev, seg, mask = _flood_case(3, x=40, y=40, z=2)
    want = np.asarray(jax.vmap(
        lambda e, mk, m: jwatershed_flood(e, mk, m, 1, max_iters=7),
        in_axes=2, out_axes=2)(jnp.asarray(elev), jnp.asarray(seg),
                               jnp.asarray(mask)))
    got, rounds = flood_slices(*(torch.from_numpy(a)
                                 for a in (elev, seg, mask)), max_iters=7)
    assert rounds == 7
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("conn", [1, 2])
def test_watershed_flood_3d_matches_jax(conn):
    rng = np.random.RandomState(5)
    elev = rng.rand(14, 12, 6).astype(np.float32)
    markers = np.zeros((14, 12, 6), np.int32)
    markers[2, 2, 1], markers[11, 9, 4], markers[6, 10, 2] = 1, 2, 3
    mask = rng.rand(14, 12, 6) < 0.9
    want = np.asarray(jwatershed_flood(jnp.asarray(elev),
                                       jnp.asarray(markers),
                                       jnp.asarray(mask), conn))
    got = watershed_flood(torch.from_numpy(elev), torch.from_numpy(markers),
                          torch.from_numpy(mask), conn)
    np.testing.assert_array_equal(got.numpy(), want)
