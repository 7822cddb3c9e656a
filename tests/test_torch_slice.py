"""The whole slice: ``segment_and_track_arrays`` against the JAX
composition of the same steps (``_segment_and_track_device``'s per-volume
loop, single device), on the CPU, 3 volumes of about 12 cells."""

import numpy as np
import pytest

import t3dct_torch  # noqa: F401
from t3dct.coordinates import Coordinates as JCoordinates
from t3dct.engine.pipeline import fused_track_from_seg
from t3dct.engine.transformer import CoordsToImageTransformer as JTransformer
from t3dct_torch.config import TrackingConfig
from t3dct_torch.engine.pipeline import segment_and_track_arrays
from test_torch_scene import (INTERP, VOXEL_SIZE, ffn_pair, recording,
                              stardist_pair)


def jax_composition(vols, jm, lab, ffn, results_dir):
    """The JAX device-handoff loop on arrays: interpolate once, then per
    volume one seg dispatch and (t > 1) one fused track dispatch."""
    jp, js = ffn
    jt = JTransformer(results_dir, VOXEL_SIZE)
    jt.load_segmentation_array(lab)
    jt.interpolate(INTERP)
    vol1 = jt.coord_vol1
    pad_n = int(np.ceil(vol1.cell_num * 1.5 / 64) * 64)
    coords = {1: np.asarray(vol1.real)}
    labels = {1: jt.auto_corrected_segmentation}
    kept_counts = {}
    conf, prev = vol1, None
    for t, vol in enumerate(vols, start=1):
        mi, ma = np.percentile(vol, (1.0, 99.8))
        kept, _, _, points, prob_map, _ = jm._predict_instances_device(
            vol, norm_minmax=(mi, ma), return_labels=(t == 1))
        kept_counts[t] = int(np.asarray(kept).sum())
        if t > 1:
            raw, lab_t = fused_track_from_seg(
                jp, js, conf.raw_f32, vol1.raw_f32, prev[0], prev[1], points,
                kept, prob_map, jt.atlas, VOXEL_SIZE,
                jt.proofed_segmentation.shape, beta=3.0, lambda_=3.0,
                prob_grid=(1, 2, 2), pad_n=pad_n)
            conf = JCoordinates(raw, INTERP, VOXEL_SIZE)
            coords[t] = np.asarray(conf.real)
            labels[t] = np.asarray(lab_t)
        prev = (points, kept)
    return coords, labels, kept_counts


_RUNS = {}


def runs_for(seed, tmp_path_factory):
    """(JAX composition, port SliceResult, true centres), once per seed."""
    if seed not in _RUNS:
        jm, tm = stardist_pair()
        jffn, tffn = ffn_pair()
        vols, centers, lab = recording(3, seed=seed)
        want = jax_composition(vols, jm, lab, jffn,
                               tmp_path_factory.mktemp("res"))
        got = segment_and_track_arrays(vols, tm, lab, tffn, VOXEL_SIZE,
                                       INTERP, TrackingConfig(),
                                       device="cpu")
        _RUNS[seed] = (want, got, centers)
    return _RUNS[seed]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return runs_for(1, tmp_path_factory)


def test_slice_coords_match(runs):
    """Real coords per volume to 1e-3 (f32 EM; the correction loop snaps
    them to prob-weighted centres)."""
    (coords, _, _), got, _ = runs
    assert sorted(got.coords) == [1, 2, 3]
    for t, want in coords.items():
        assert got.coords[t].shape == want.shape
        np.testing.assert_allclose(got.coords[t], want, atol=1e-3)


def test_slice_labels_match(runs):
    (_, labels, _), got, _ = runs
    for t, want in labels.items():
        assert got.labels[t].dtype == np.uint16
        np.testing.assert_array_equal(got.labels[t].astype(np.int64),
                                      np.asarray(want).astype(np.int64))


def test_slice_seg_counts_and_stats(runs):
    (_, _, kept), got, _ = runs
    assert {t: s["kept"] for t, s in got.stats.items()} == kept
    for t in (2, 3):
        assert 1 < got.stats[t]["prgls_iterations"] < 2000
        assert 1 <= got.stats[t]["correction_iterations"] <= 20
    assert got.auto_vol1.shape == (8, 64, 48)
    assert got.auto_vol1.max() == kept[1]


def test_slice_rounding_flip_is_one_step(tmp_path_factory):
    """Seed 0 of the same scene puts one cell's integer displacement
    within the f32 EM noise (~2e-3 real units, see test_torch_tracking) of
    a rounding boundary at t=3: the two frameworks move that one cell by
    different whole steps.  Every other cell still agrees to 1e-3, the
    odd one is off by less than one interp step of its displacement, and
    the labels differ only around it."""
    (coords, labels, _), got, _ = runs_for(0, tmp_path_factory)
    for t, want in coords.items():
        off = np.abs(got.coords[t] - want).max(axis=1)
        assert (off > 1e-3).sum() <= 1
        assert off.max() < 1.5
        same = got.labels[t].astype(np.int64) == np.asarray(
            labels[t]).astype(np.int64)
        assert same.mean() >= 0.995


def test_slice_follows_the_cells(runs):
    """With the pass-through weights the tracked cells stay near the true
    centres (median under 2 real units); a sanity bound, not accuracy."""
    _, got, centers = runs
    sc = np.asarray(VOXEL_SIZE)
    for t, c in got.coords.items():
        gt = centers[t][:, [1, 2, 0]] * sc
        d = np.linalg.norm(c[:, None] - gt[None], axis=2).min(axis=1)
        assert np.isfinite(c).all() and np.median(d) < 2.0


def test_slice_rejects_ensemble():
    with pytest.raises(ValueError):
        segment_and_track_arrays([], None, np.zeros((4, 4, 2), np.int32),
                                 None, VOXEL_SIZE, INTERP,
                                 TrackingConfig(ensemble=True), device="cpu")


class _StubModel:
    """Stands in for ``StarDist3D``: every volume yields ``n_kept`` kept
    candidates."""

    def __init__(self, n_kept):
        import types
        self.n_kept = n_kept
        self.config = types.SimpleNamespace(grid=(1, 2, 2))

    def predict_instances_device(self, vol, norm_minmax, return_labels):
        import torch
        g = torch.Generator().manual_seed(0)
        n = self.n_kept
        points = torch.rand((n, 3), generator=g) * torch.tensor(
            [8.0, 64.0, 48.0])
        kept = torch.ones((n,), dtype=torch.bool)
        prob = torch.rand((8, 32, 24), generator=g)
        return kept, None, None, points, prob, None


@pytest.mark.parametrize("extra", [0, 1])
def test_slice_raises_past_max_cells(extra):
    """A volume that keeps more candidates than the tracker's padded set
    holds (``pad_n``, here 64 for 12 cells) raises the JAX pipelines'
    error instead of dropping the rest; ``pad_n`` itself is taken."""
    vols, _, lab = recording(1, seed=1)
    pad_n = int(np.ceil(len(np.unique(lab[lab > 0])) * 1.5 / 64) * 64)
    model = _StubModel(pad_n + extra)
    run = lambda: segment_and_track_arrays(  # noqa: E731
        vols, model, lab, ({}, {}), VOXEL_SIZE, INTERP, TrackingConfig(),
        device="cpu")
    if extra:
        with pytest.raises(ValueError,
                           match=f"{pad_n + 1} cells exceeds "
                                 f"max_cells={pad_n}"):
            run()
    else:
        assert run().stats[1]["kept"] == pad_n
