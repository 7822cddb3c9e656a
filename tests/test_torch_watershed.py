"""EDT, boundary recalculation, connected components and per-label
reductions of the port against the JAX package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.ops.connected import label_components_values as jcc
from t3dct.ops.edt import distance_transform_edt as jedt
from t3dct.ops.filters import gaussian_filter as jgauss
from t3dct.ops.neighborhood import neighbor_offsets as jnoff
from t3dct.ops.neighborhood import shift as jshift
from t3dct.ops.segment_reduce import center_of_mass as jcom
from t3dct.ops.segment_reduce import find_objects_bounds as jbounds
from t3dct.ops.watershed import recalculate_cell_boundaries as jrecalc
from t3dct_torch.ops.connected import label_components_values
from t3dct_torch.ops.edt import distance_transform_edt
from t3dct_torch.ops.filters import gaussian_filter
from t3dct_torch.ops.neighborhood import neighbor_offsets, shift
from t3dct_torch.ops.segment_reduce import center_of_mass, find_objects_bounds
from t3dct_torch.ops.watershed import recalculate_cell_boundaries


def _overlapping_cells(seed, shape=(40, 36, 5), n=7, half=4):
    """A label volume of overlapping boxes: (id sum, overlap count)."""
    rng = np.random.RandomState(seed)
    lab = np.zeros(shape, np.int32)
    cnt = np.zeros(shape, np.int32)
    for i in range(n):
        cx = rng.randint(half, shape[0] - half)
        cy = rng.randint(half, shape[1] - half)
        cz = rng.randint(0, shape[2])
        sl = (slice(cx - half, cx + half), slice(cy - half, cy + half),
              slice(max(cz - 2, 0), cz + 2))
        lab[sl] += i + 1
        cnt[sl] += 1
    return lab, cnt


@pytest.mark.parametrize("sampling", [(1.0, 1.0), (1.0, 1.13), (0.5, 2.0)])
def test_edt_per_slice_exact(sampling):
    _, cnt = _overlapping_cells(1)
    over = cnt > 1
    assert over.any() and not over.all()
    want = np.asarray(jax.vmap(lambda m: jedt(m, sampling), in_axes=2,
                               out_axes=2)(jnp.asarray(over)))
    got = distance_transform_edt(torch.from_numpy(over).permute(2, 0, 1),
                                 sampling, batch_ndim=1).permute(1, 2, 0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sampling", [None, (1.0, 1.13, 4.7)])
def test_edt_3d_exact(sampling):
    rng = np.random.RandomState(2)
    mask = rng.rand(12, 10, 7) < 0.8
    want = np.asarray(jedt(jnp.asarray(mask), sampling))
    got = distance_transform_edt(torch.from_numpy(mask), sampling)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("sampling", [(1.0, 1.0), (1.0, 1.13)])
def test_recalculate_cell_boundaries_exact(seed, sampling):
    lab, cnt = _overlapping_cells(seed)
    want = np.asarray(jrecalc(jnp.asarray(lab), jnp.asarray(cnt),
                              sampling_xy=sampling))
    got = recalculate_cell_boundaries(torch.from_numpy(lab),
                                      torch.from_numpy(cnt),
                                      sampling_xy=sampling)
    np.testing.assert_array_equal(got.numpy(), want)


def test_neighborhood_shift_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randint(0, 9, (5, 6, 4)).astype(np.int32)
    assert neighbor_offsets(3, 2) == jnoff(3, 2)
    for off in neighbor_offsets(3, 3):
        np.testing.assert_array_equal(
            shift(torch.from_numpy(x), off, -1).numpy(),
            np.asarray(jshift(jnp.asarray(x), off, -1)))


@pytest.mark.parametrize("conn", [1, 3])
def test_label_components_values_exact(conn):
    """Touching cells of different ids stay distinct components; one id
    split in two becomes two components."""
    lab, _ = _overlapping_cells(5, n=6)
    lab = np.where(lab > 6, 0, lab)
    lab[30:33, 2:4, 0] = 2            # a detached fragment of cell 2
    want = np.asarray(jcc(jnp.asarray(lab), connectivity=conn))
    got = label_components_values(torch.from_numpy(lab), connectivity=conn)
    np.testing.assert_array_equal(got.numpy(), want)


def test_center_of_mass_and_bounds():
    rng = np.random.RandomState(6)
    lab, _ = _overlapping_cells(6, n=5)
    lab = np.where(lab > 5, 0, lab)
    w = rng.rand(*lab.shape).astype(np.float32)
    # ids 6 and 7 are absent: NaN rows, as scipy's 0/0
    want = np.asarray(jcom(jnp.asarray(w), jnp.asarray(lab), 7))
    got = center_of_mass(torch.from_numpy(w), torch.from_numpy(lab), 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-5)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    jmn, jmx = jbounds(jnp.asarray(lab), 7)
    mn, mx = find_objects_bounds(torch.from_numpy(lab), 7)
    np.testing.assert_array_equal(mn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))


@pytest.mark.parametrize("sigma", [2.5, (2.5, 0.0, 1.0)])
def test_gaussian_filter_close(sigma):
    """Separable blur with zero padding: equal up to f32 summation order
    (XLA's conv and PyTorch's conv1d sum the taps in different orders)."""
    rng = np.random.RandomState(7)
    x = rng.rand(3, 9, 8, 30).astype(np.float32)
    want = np.asarray(jax.vmap(lambda v: jgauss(v, sigma, mode="zero"))(
        jnp.asarray(x)))
    got = gaussian_filter(torch.from_numpy(x), sigma, mode="zero",
                          batch_ndim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
