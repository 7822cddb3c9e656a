"""The traffic generator: the same seed gives the same recording, another
seed another one, and the pool loops with no jump."""

import numpy as np
import torch

from benchmark.harness.scene import Scene, SceneSpec, centres_at

SMALL = dict(shape=[8, 64, 48], cells=12, pool=18, period=18,
             margin=[2, 8, 8])


def _scene(seed, **kw):
    return Scene(SceneSpec.from_dict(dict(SMALL, **kw)), seed,
                 torch.device("cpu"))


def test_same_seed_same_recording():
    a, b = _scene(2 ** 31 + 11), _scene(2 ** 31 + 11)
    assert np.array_equal(a.pool, b.pool)
    assert np.array_equal(a.labels1, b.labels1)
    assert np.array_equal(a.c0, b.c0)


def test_other_seed_other_recording():
    a, b = _scene(1), _scene(2)
    assert not np.array_equal(a.pool, b.pool)
    assert not np.allclose(a.c0, b.c0)


def test_recording_is_uint16_with_cells_and_vol1_labels():
    s = _scene(3)
    assert s.pool.dtype == np.uint16 and s.pool.shape == (18, 8, 64, 48)
    assert s.pool.max() == 50000
    assert set(np.unique(s.labels1)) - {0} <= set(range(1, 13))
    # nearly every cell is painted at t = 1 at its centre voxel
    painted = [s.labels1[tuple(int(round(v)) for v in c)] > 0
               for c in s.centres(1)]
    assert np.mean(painted) >= 0.9


def test_pool_loops_with_no_jump():
    spec = SceneSpec.from_dict(SMALL)
    s = _scene(4)
    steps = [np.abs(centres_at(spec, s.c0, t + 1) - centres_at(spec, s.c0, t)
                    ).max() for t in range(1, 3 * spec.period)]
    # the step from the last pool volume to the first is an ordinary step
    assert max(steps) <= 1.01 * np.median(steps) * 2
    assert np.allclose(s.centres(1), s.centres(1 + spec.period))
    assert np.array_equal(s.volume(1), s.volume(1 + spec.pool))
    # each pool entry has its own noise
    assert not np.array_equal(s.volume(1), s.volume(2))


def test_pool_not_a_multiple_of_the_period_is_refused():
    import pytest
    with pytest.raises(ValueError):
        SceneSpec.from_dict(dict(SMALL, pool=10))


def test_cells_keep_their_separation():
    s = _scene(5, cells=30, shape=[16, 96, 96], margin=[3, 8, 8])
    c = s.c0
    for i in range(len(c)):
        for j in range(i):
            d = c[i] - c[j]
            assert abs(d[0]) > 2.5 or np.hypot(d[1], d[2]) > 9.0
