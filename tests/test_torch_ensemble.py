"""The ensemble's pieces against the JAX package, on the CPU: the trimmed
mean, the reference-volume lists, the member fan-out, and the serial
``TrackerLite.predict_cell_positions_ensemble``.

Bounds: ``trim_mean`` within 1e-6 relative of JAX's and scipy's (a float32
mean in another summation order); volume lists exact; each batched member
bit-equal to the port's own solo ``track_step`` (the same kernels on the
same numbers) with the same iteration count; the member predictions within
``EM_TOL`` of JAX's ``vmap`` (the f32 EM parts the frameworks by ~2e-3 for
a 1-ulp input change, ``test_torch_tracking.py``)."""

import numpy as np
import pytest
import scipy.stats
import jax.numpy as jnp
import torch

import t3dct_torch  # noqa: F401
from t3dct.engine.tracker import TrackerLite as JTrackerLite
from t3dct.engine.tracker import evenly_distributed_volumes as j_even
from t3dct.engine.tracker import get_volumes_list as j_volumes
from t3dct.engine.tracker import track_step as j_track_step
from t3dct.ops.trim import trim_mean as j_trim_mean
from t3dct.parallel import ensemble as jens
from t3dct_torch.coordinates import Coordinates
from t3dct_torch.engine.tracker import (TrackerLite,
                                        evenly_distributed_volumes,
                                        get_volumes_list, track_step)
from t3dct_torch.ops import prgls
from t3dct_torch.ops.trim import trim_mean
from t3dct_torch.parallel import ensemble
from test_torch_scene import INTERP, VOXEL_SIZE, ffn_pair, recording

EM_TOL = 1e-2
PAD = 32


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("proportion", [0.1, 0.25, 0.4])
@pytest.mark.parametrize("n", range(1, 26))
def test_trim_mean_matches_jax_and_scipy(n, proportion, axis):
    """The low cut is ``int(p * n)``, then sort, slice and mean; ties and
    the odd remainders of n included (integers drawn with repeats)."""
    rng = np.random.RandomState(n)
    a = (rng.randint(0, 7, (n, 5)) + rng.rand(n, 5)).astype(np.float32)
    a[: n // 3] = a[0]                  # repeated rows: ties in the sort
    if axis == 1:
        a = np.ascontiguousarray(a.T)
    got = trim_mean(torch.from_numpy(a), proportion, axis=axis).numpy()
    want = np.asarray(j_trim_mean(jnp.asarray(a), proportion, axis=axis))
    ref = scipy.stats.trim_mean(a.astype(np.float64), proportion, axis=axis)
    assert got.shape == want.shape == ref.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_trim_mean_cuts_the_outliers():
    a = torch.tensor([[0.0], [1.0], [2.0], [3.0], [1000.0]])
    assert float(trim_mean(a, 0.2)[0]) == 2.0
    assert float(trim_mean(a, 0.1)[0]) == pytest.approx(201.2)


VOLUME_CASES = [(cur, skip, s, adj, start)
                for cur in (2, 3, 7, 20, 21, 22, 40, 41, 63)
                for skip in ([], [1], [3, 5, 18], list(range(2, 60, 4)))
                for s in (1, 5, 20)
                for adj in (False, True)
                for start in (1,)] + [(12, [], 4, False, 3),
                                      (30, [10], 20, True, 5),
                                      (30, [10], 20, False, 5)]


@pytest.mark.parametrize("cur,skip,s,adj,start", VOLUME_CASES[::7] +
                         VOLUME_CASES[-3:])
def test_get_volumes_list_matches_jax(cur, skip, s, adj, start):
    assert get_volumes_list(cur, skip, s, adj, start) == \
        j_volumes(cur, skip, s, adj, start)


def test_get_volumes_list_whole_grid_matches_jax():
    for case in VOLUME_CASES:
        assert get_volumes_list(*case) == j_volumes(*case), case
    for cur in range(2, 70):
        for s in (1, 3, 20):
            if cur - 1 >= s:
                assert evenly_distributed_volumes(cur, s) == \
                    j_even(cur, s), (cur, s)


def test_get_volumes_list_rejects_the_first_volume():
    with pytest.raises(AssertionError):
        get_volumes_list(1, [], 20)


def _real_points(centers_zyx, seed):
    """True centres in the pipeline frame with sub-voxel noise, real
    units."""
    rng = np.random.RandomState(seed)
    pts = centers_zyx[:, [1, 2, 0]] + rng.uniform(-0.5, 0.5,
                                                  centers_zyx.shape)
    return (pts * np.float64(VOXEL_SIZE)).astype(np.float32)


def _pad(pts):
    out = np.full((PAD, 3), 1e6, np.float32)
    out[:len(pts)] = pts
    mask = np.zeros(PAD, bool)
    mask[:len(pts)] = True
    return out, mask


@pytest.fixture(scope="module")
def members():
    """Five members predicting volume 6 of a drifting scene from volumes
    1-5: (confirmed (E, 12, 3), seg1 (E, 32, 3), mask1, seg2, mask2)."""
    _, centers, _ = recording(6, seed=2)
    conf, seg1, mask1 = [], [], []
    for t in range(1, 6):
        conf.append(_real_points(centers[t], 100 + t))
        p, m = _pad(_real_points(centers[t], t))
        seg1.append(p)
        mask1.append(m)
    seg2, mask2 = _pad(_real_points(centers[6], 6))
    return (np.stack(conf), np.stack(seg1), np.stack(mask1), seg2, mask2)


def T(a):
    return torch.from_numpy(np.asarray(a))


def test_batched_members_equal_solo_track_step(members):
    """Each member of the batch is bit-equal to ``track_step`` run on it
    alone, iterations included."""
    _, (tp, ts) = ffn_pair()
    conf, seg1, mask1, seg2, mask2 = members
    res = track_step(tp, ts, T(conf), T(seg1), T(mask1), T(seg2), T(mask2))
    assert res.tracked.shape == conf.shape
    assert res.n_iterations.shape == (5,)
    for e in range(5):
        solo = track_step(tp, ts, T(conf[e]), T(seg1[e]), T(mask1[e]),
                          T(seg2), T(mask2))
        assert torch.equal(res.tracked[e], solo.tracked), e
        assert int(res.n_iterations[e]) == int(solo.n_iterations)


def test_member_that_stops_early_stays_frozen(members, monkeypatch):
    """Members stop at different iterations; the batch runs until the last
    one stops, and the early ones keep their state: each equals its solo
    run, and the iteration counts differ."""
    _, (tp, ts) = ffn_pair()
    conf, seg1, mask1, seg2, mask2 = members
    # member 1 starts at vol 6's own cells: its EM converges at once
    seg1 = seg1.copy()
    seg1[1] = seg2
    mask1 = mask1.copy()
    mask1[1] = mask2
    monkeypatch.setattr(prgls, "CHECK_EVERY", 3)
    res = track_step(tp, ts, T(conf), T(seg1), T(mask1), T(seg2), T(mask2))
    its = res.n_iterations.tolist()
    assert min(its) < max(its), its
    for e in range(5):
        solo = track_step(tp, ts, T(conf[e]), T(seg1[e]), T(mask1[e]),
                          T(seg2), T(mask2))
        assert int(solo.n_iterations) == its[e]
        assert torch.equal(res.tracked[e], solo.tracked), e


def test_member_predictions_match_jax(members):
    """``ensemble_member_predictions`` against JAX's ``vmap`` fan-out on
    the same inputs and weights, and each JAX member against JAX's solo
    ``track_step``'s bound."""
    (jp, js), (tp, ts) = ffn_pair()
    conf, seg1, mask1, seg2, mask2 = members
    want = np.asarray(jens.ensemble_member_predictions(
        jp, js, jnp.asarray(conf), jnp.asarray(seg1), jnp.asarray(mask1),
        jnp.asarray(seg2), jnp.asarray(mask2)))
    got = ensemble.ensemble_member_predictions(
        tp, ts, T(conf), T(seg1), T(mask1), T(seg2), T(mask2)).numpy()
    assert got.shape == want.shape == conf.shape
    np.testing.assert_allclose(got, want, atol=EM_TOL)
    solo = np.asarray(j_track_step(jp, js, jnp.asarray(conf[2]),
                                   jnp.asarray(seg1[2]),
                                   jnp.asarray(mask1[2]), jnp.asarray(seg2),
                                   jnp.asarray(mask2)))
    np.testing.assert_allclose(got[2], solo, atol=EM_TOL)


@pytest.mark.parametrize("trim", [0.1, 0.25])
def test_ensemble_track_step_matches_jax(members, trim):
    (jp, js), (tp, ts) = ffn_pair()
    conf, seg1, mask1, seg2, mask2 = members
    want = np.asarray(jens.ensemble_track_step(
        jp, js, jnp.asarray(conf), jnp.asarray(seg1), jnp.asarray(mask1),
        jnp.asarray(seg2), jnp.asarray(mask2), trim_proportion=trim))
    got = ensemble.ensemble_track_step(
        tp, ts, T(conf), T(seg1), T(mask1), T(seg2), T(mask2),
        trim_proportion=trim).numpy()
    np.testing.assert_allclose(got, want, atol=EM_TOL)


@pytest.mark.parametrize("n,multiple", [(1, 1), (3, 4), (5, 4), (8, 4),
                                        (20, 8)])
def test_pad_members_matches_jax(n, multiple):
    arrays = [np.full((2, 3), i, np.float32) for i in range(n)]
    got, n_real = ensemble.pad_members(arrays, multiple)
    want, j_real = jens.pad_members(arrays, multiple)
    np.testing.assert_array_equal(got, want)
    assert n_real == j_real == n and len(got) % multiple == 0


def test_serial_ensemble_prediction_matches_jax(tmp_path):
    """``predict_cell_positions_ensemble`` reads each reference volume's
    ``coords_real`` and ``seg/coords`` from the tree, as JAX's does; the
    same tree gives JAX's combined prediction within ``EM_TOL``."""
    from t3dct.coordinates import Coordinates as JCoordinates
    from t3dct_torch.io.artifacts import ResultsTree
    (jp, js), (tp, ts) = ffn_pair()
    _, centers, _ = recording(6, seed=2)
    tree = ResultsTree(tmp_path)
    vs = np.float32(VOXEL_SIZE)
    for t in range(1, 7):
        tree.save_seg_coords(t, np.round(centers[t][:, [1, 2, 0]])
                             .astype(np.int32))
        if t < 6:
            tree.save_coords_real(t, _real_points(centers[t], 50 + t))
    vol1_raw = _real_points(centers[1], 51) / vs
    tv1 = Coordinates.from_raw(vol1_raw, INTERP, VOXEL_SIZE, device="cpu")
    jv1 = JCoordinates.from_raw(vol1_raw, INTERP, VOXEL_SIZE)
    tt = TrackerLite(tmp_path, (tp, ts), tv1, max_cells=PAD)
    jt = JTrackerLite(tmp_path, (jp, js), jv1, max_cells=PAD)
    got = tt.predict_cell_positions_ensemble([3], 6, tv1)
    want = jt.predict_cell_positions_ensemble([3], 6, jv1)
    assert got.real.shape == (12, 3)
    np.testing.assert_allclose(got.real.numpy(), np.asarray(want.real),
                               atol=EM_TOL)
    # the serial variant is the solo predictions' trimmed mean
    solo = [tt.predict_cell_positions(t1, 6, Coordinates.from_real(
        tree.load_coords_real(t1), INTERP, VOXEL_SIZE, device="cpu")).real
        for t1 in (1, 2, 4, 5)]
    np.testing.assert_array_equal(
        got.real.numpy(), Coordinates.from_real(
            trim_mean(torch.stack(solo), 0.1), INTERP, VOXEL_SIZE).real
        .numpy())
