"""The legacy path's watershed half of the port against the JAX package, on
the CPU: mask connected components (3-D and per slice, also against the
``cc_propagate`` Pallas kernel in interpret mode), peaks, outer boundaries,
size filtering with its ``max_labels`` cap, ``watershed_2d``/``3d`` and the
segmenter's watershed stage, all fed the same inputs and held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.config import SegmentationConfig as JSegConfig
from t3dct.engine.segmentation import UNetSegmenter as JSegmenter
from t3dct.models.unet3d import UNet3D as JUNet3D
from t3dct.ops import watershed as jws
from t3dct.ops.connected import label_components as jlabel
from t3dct.ops.connected import label_components_raw as jcc
from t3dct.ops.pallas_kernels import _BIG, cc_propagate
from t3dct.ops.peaks import peak_local_max_mask as jpeaks
from t3dct_torch.config import SegmentationConfig
from t3dct_torch.engine.segmentation import UNetSegmenter
from t3dct_torch.models.unet3d import UNet3D
from t3dct_torch.ops import hopper_cc
from t3dct_torch.ops import watershed as tws
from t3dct_torch.ops.connected import label_components, label_components_raw
from t3dct_torch.ops.peaks import peak_local_max_mask
from t3dct_torch.utils.synthetic import serpentine


def T(a):
    return torch.from_numpy(np.array(a))


def prob_volume(seed, shape=(64, 48, 10), n=14):
    """A U-Net-like probability map: anisotropic blobs (some touching) on
    weak noise, (x, y, z)."""
    rng = np.random.RandomState(seed)
    xx, yy, zz = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    p = np.zeros(shape, np.float32)
    for _ in range(n):
        c = rng.uniform((4, 4, 1), (shape[0] - 4, shape[1] - 4, shape[2] - 1))
        r = rng.uniform(3, 6)
        d2 = ((xx - c[0]) ** 2 + (yy - c[1]) ** 2) / r ** 2 \
            + ((zz - c[2]) / 1.6) ** 2
        p = np.maximum(p, np.exp(-d2))
    return (p + rng.rand(*shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("density", [0.2, 0.45])
def test_label_components_raw_3d_exact(seed, density):
    mask = np.random.RandomState(seed).rand(20, 24, 6) < density
    want = np.asarray(jcc(jnp.asarray(mask)))
    got = label_components_raw(T(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    # the Pallas kernel's contract: min-propagated initial labels
    n = mask.size
    init = np.where(mask, np.arange(1, n + 1, dtype=np.int32).reshape(
        mask.shape), _BIG)
    pallas = np.asarray(cc_propagate(jnp.asarray(init), max_iters=256))
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(pallas == _BIG, 0, pallas))


@pytest.mark.parametrize("seed", [3, 4])
def test_label_components_raw_per_slice_exact(seed):
    """Slice-local indices: the JAX function vmapped over z, and the Pallas
    kernel slice by slice."""
    mask = np.random.RandomState(seed).rand(26, 18, 5) < 0.35
    want = np.asarray(jax.vmap(jcc, in_axes=2, out_axes=2)(
        jnp.asarray(mask)))
    got = label_components_raw(T(mask), per_slice=True)
    np.testing.assert_array_equal(got.numpy(), want)
    n = mask.shape[0] * mask.shape[1]
    for z in range(mask.shape[2]):
        m = mask[:, :, z]
        init = np.where(m, np.arange(1, n + 1, dtype=np.int32).reshape(
            m.shape), _BIG)
        pallas = np.asarray(cc_propagate(jnp.asarray(init)))
        np.testing.assert_array_equal(got[:, :, z].numpy(),
                                      np.where(pallas == _BIG, 0, pallas))


@pytest.mark.parametrize("conn", [1, 2])
def test_label_components_below_full_connectivity(conn):
    """Connectivity below the axis count runs the plain loop (no kernel)."""
    mask = np.random.RandomState(5).rand(15, 12, 4) < 0.4
    want = np.asarray(jlabel(jnp.asarray(mask), connectivity=conn))
    got = label_components(T(mask), connectivity=conn)
    np.testing.assert_array_equal(got.numpy(), want)


def test_label_components_snake():
    """The JAX loop's pointer jumps reach the fixed point of a serpentine
    ~620 voxels long within its default 256 rounds; per slice and in 3-D
    the port agrees."""
    mask = serpentine((40, 30, 3))
    got = label_components_raw(T(mask), per_slice=True)
    assert int(got.max()) == 1 and (got.numpy()[mask] == 1).all()
    want = np.asarray(jax.vmap(jcc, in_axes=2, out_axes=2)(
        jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), want)
    got3 = label_components_raw(T(mask))
    np.testing.assert_array_equal(got3.numpy(),
                                  np.asarray(jcc(jnp.asarray(mask))))
    assert len(np.unique(got3.numpy())) == 2


def test_cc_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        hopper_cc.cc_label(torch.zeros((4, 4, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        hopper_cc.cc_label(torch.zeros((4, 4), dtype=torch.bool),
                           per_slice=True)


@pytest.mark.parametrize("min_distance,exclude", [(7, None), (3, 0), (2, 1)])
def test_peak_local_max_mask_exact(min_distance, exclude):
    rng = np.random.RandomState(6)
    img = np.round(rng.rand(30, 26, 8) * 20).astype(np.float32)  # plateaus
    want = np.asarray(jpeaks(jnp.asarray(img), min_distance=min_distance,
                             exclude_border=exclude))
    got = peak_local_max_mask(T(img), min_distance, exclude)
    np.testing.assert_array_equal(got.numpy(), want)
    # per slice: the JAX function vmapped over z, each slice its own min
    want2 = np.asarray(jax.vmap(
        lambda s: jpeaks(s, min_distance=min_distance,
                         exclude_border=exclude),
        in_axes=2, out_axes=2)(jnp.asarray(img)))
    got2 = peak_local_max_mask(T(img).permute(2, 0, 1), min_distance,
                               exclude, batch_ndim=1).permute(1, 2, 0)
    np.testing.assert_array_equal(got2.numpy(), want2)


@pytest.mark.parametrize("conn", [1, 2, 3])
def test_find_boundaries_outer_exact(conn):
    lab = np.random.RandomState(7).randint(0, 4, (16, 14, 5)).astype(np.int32)
    want = np.asarray(jws.find_boundaries_outer(jnp.asarray(lab), conn))
    got = tws.find_boundaries_outer(T(lab), conn)
    np.testing.assert_array_equal(got.numpy(), want)
    if conn <= 2:
        want2 = np.asarray(jax.vmap(
            lambda s: jws.find_boundaries_outer(s, conn),
            in_axes=2, out_axes=2)(jnp.asarray(lab)))
        got2 = tws.find_boundaries_outer(T(lab).permute(2, 0, 1), conn,
                                         batch_ndim=1).permute(1, 2, 0)
        np.testing.assert_array_equal(got2.numpy(), want2)


@pytest.mark.parametrize("max_labels", [40, 7, 3])
def test_remove_small_objects_capped(max_labels):
    """Ids above ``max_labels`` are not counted (``jnp.bincount`` drops
    them) and are kept or cleared with id ``max_labels`` (the gather
    clamps): with 30 labels and a cap of 7 or 3, the component count is
    above the cap."""
    rng = np.random.RandomState(8)
    lab = rng.randint(0, 31, (20, 18, 6)).astype(np.int32)
    lab[lab == 7] = 0                        # an id with no voxels
    for min_size in (1, 70, 80):
        want = np.asarray(jws.remove_small_objects(
            jnp.asarray(lab), min_size, max_labels))
        got = tws.remove_small_objects(T(lab), min_size, max_labels)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tws.bincount_capped(T(lab), max_labels + 1).numpy(),
        np.asarray(jnp.bincount(jnp.asarray(lab).reshape(-1),
                                length=max_labels + 1)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_watershed_2d_exact(seed):
    p = prob_volume(seed)
    jb, jbd = jws.watershed_2d(jnp.asarray(p))
    tb, tbd = tws.watershed_2d(T(p))
    np.testing.assert_array_equal(tbd.numpy(), np.asarray(jbd))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert np.asarray(jbd).any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("method", ["min_size", "cell_num"])
def test_watershed_3d_exact(seed, method):
    ws2d = np.asarray(jws.watershed_2d(jnp.asarray(prob_volume(seed)))[0])
    kw = dict(samplingrate=(1.0, 1.0, 2.0), method=method, min_size=20,
              cell_num=6, max_labels=64)
    want = jws.watershed_3d(jnp.asarray(ws2d), **kw)
    got = tws.watershed_3d(T(ws2d), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a.numpy()), np.asarray(b))
    assert int(np.asarray(want[1]).max()) >= 5


def test_watershed_3d_more_markers_than_max_labels():
    """With a cap below the marker count the two packages drop and clamp
    the same ids."""
    ws2d = np.asarray(jws.watershed_2d(jnp.asarray(prob_volume(4)))[0])
    kw = dict(samplingrate=(1.0, 1.0, 2.0), min_size=10, max_labels=4)
    want = jws.watershed_3d(jnp.asarray(ws2d), **kw)
    got = tws.watershed_3d(T(ws2d), **kw)
    assert int(np.asarray(want[1]).max()) > 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a.numpy()), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("method", ["min_size", "cell_num"])
def test_segmenter_watershed_stage_exact(seed, method):
    """``UNetSegmenter._watershed_impl`` fed the same probability volume:
    labels, the adaptive min_size/cell_num exactly, centres to 1e-5."""
    p = prob_volume(seed)
    spec = dict(variant="a", tile_shape=(16, 16, 8), pool=(2, 2, 1),
                down_filters=((2, 2),), up_filters=((2, 2),),
                head_filters=(2,))
    cfg = dict(noise_level=20.0, min_size=20, cell_num=6, z_xy_ratio=2.0,
               shrink=(4, 4, 2))
    tm = UNet3D(**spec)
    params, state = tm.init(torch.Generator().manual_seed(0), device="cpu")
    tseg = UNetSegmenter(tm, params, state, SegmentationConfig(**cfg),
                         p.shape, max_cells=64, device="cpu")
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     (params, state))
    jseg = JSegmenter(JUNet3D(**spec), *jparams, JSegConfig(**cfg), p.shape,
                      max_cells=64, compute_dtype=jnp.float32)
    want = jseg._watershed_impl(jnp.asarray(p), method)
    got = tseg._watershed_impl(T(p), method)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(np.isnan(got[1].numpy()),
                                  np.isnan(np.asarray(want[1])))
    assert int(got[2]) == int(want[2]) and int(got[3]) == int(want[3])
