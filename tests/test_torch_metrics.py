"""The port's accuracy metrics (``engine/metrics.py``) against the JAX
package's ``instance_matching`` and ``tracking_accuracy`` and against
``bench.py::tracking_id_metrics``, exactly, on seeded label volumes and
tracks."""

import numpy as np
import pytest

import t3dct_torch  # noqa: F401
from t3dct.engine.metrics import instance_matching as j_instance_matching
from t3dct.engine.metrics import tracking_accuracy as j_tracking_accuracy
from t3dct_torch.engine.metrics import (instance_matching,
                                        tracking_accuracy,
                                        tracking_id_metrics)
from test_torch_scene import REPO, jax_script


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    with jax_script(REPO / "bench.py", "jax_bench",
                    tmp_path_factory.mktemp("xla")) as mod:
        yield mod


def label_pair(seed, n_gt, n_pred, shape=(24, 30, 6)):
    """Blocky ground truth and a prediction that shifts, merges, drops and
    invents cells."""
    rng = np.random.RandomState(seed)
    gt = np.zeros(shape, np.int32)
    pred = np.zeros(shape, np.int32)
    for i in range(1, n_gt + 1):
        x, y, z = (rng.randint(0, s - 3) for s in shape)
        gt[x:x + rng.randint(2, 6), y:y + rng.randint(2, 6), z:z + 2] = i
    for i in range(1, n_pred + 1):
        x, y, z = (rng.randint(0, s - 3) for s in shape)
        pred[x:x + rng.randint(2, 6), y:y + rng.randint(2, 6), z:z + 2] = i
    keep = rng.rand(*shape) < 0.5
    return gt, np.where(keep & (gt > 0), gt % max(n_pred, 1), pred)


@pytest.mark.parametrize("seed,n_gt,n_pred,iou", [
    (0, 12, 10, 0.5), (1, 30, 40, 0.3), (2, 5, 5, 0.7), (3, 8, 0, 0.5)])
def test_instance_matching_matches_jax(seed, n_gt, n_pred, iou):
    gt, pred = label_pair(seed, n_gt, n_pred)
    if n_pred == 0:
        pred = np.zeros_like(pred)
    got = instance_matching(gt, pred, iou)
    want = j_instance_matching(gt, pred, iou)
    assert got == want


def tracks(seed, n=15, n_t=6, jitter=1.0, n_tracked=None):
    rng = np.random.RandomState(seed)
    truth = {t: rng.rand(n, 3) * 50 + t for t in range(1, n_t + 1)}
    perm = rng.permutation(n)[:n_tracked or n]
    tracked = {t: truth[t][perm] + rng.randn(len(perm), 3) * jitter
               for t in range(1, n_t + 1)}
    return tracked, truth


@pytest.mark.parametrize("seed,kwargs,n_tracked", [
    (0, dict(radius=1.5), None), (1, dict(radius=2.0, assign_at=3), 10),
    (2, dict(radius=0.5, assign_at=1), None)])
def test_tracking_accuracy_matches_jax(seed, kwargs, n_tracked):
    tracked, truth = tracks(seed, n_tracked=n_tracked)
    if n_tracked:                       # more tracked than truth
        tracked, truth = truth, tracked
    assert tracking_accuracy(tracked, truth, **kwargs) == \
        j_tracking_accuracy(tracked, truth, **kwargs)


def test_tracking_accuracy_rejects_disjoint_times():
    tracked, truth = tracks(0)
    with pytest.raises(ValueError):
        tracking_accuracy({9: tracked[1]}, truth)


@pytest.mark.parametrize("jitter", [0.3, 3.0])
def test_tracking_id_metrics_match_bench(bench, jitter):
    """``tracking_id_metrics`` against the bench's on drifting centres
    (zyx, voxels) and tracks (real units) with a swap of two rows half
    way: the same gate, strict recall, accuracy and switches."""
    rng = np.random.RandomState(1)
    centers = {t: (rng.rand(20, 3) * [20, 300, 150]).astype(np.float32)
               for t in range(1, bench.N_VOLS + 1)}
    sc = np.asarray(bench.VOXEL_SIZE)
    coords = {}
    for t, c in centers.items():
        real = c[:, [1, 2, 0]] * sc + rng.randn(20, 3) * jitter
        if t > 10:
            real[[0, 1]] = real[[1, 0]]
        coords[t] = real
    got = tracking_id_metrics(coords, centers, bench.VOXEL_SIZE,
                              bench.N_VOLS)
    assert got == bench.tracking_id_metrics(coords, centers)
    assert got["id_switches"] >= 2
