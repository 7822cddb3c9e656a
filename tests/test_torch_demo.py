"""The port's ``scripts/synthetic_demo.py`` against
``examples/synthetic_demo.py``: the same synthetic recording, bit for bit,
and a run of the whole demo on the CPU with its training cut short (the
recipe's constants patched; the card runs the whole recipe in
``chip_smoke.py``'s demo phase)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import t3dct_torch  # noqa: F401
from t3dct_torch.io import imageio
from t3dct_torch.scripts import synthetic_demo as demo

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "synthetic_demo.py"


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location("jax_synthetic_demo",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_cells():
    """The example's cells, drawn as its ``main`` draws them."""
    rng = np.random.RandomState(0)
    centers0 = np.stack([np.full(8, 8.0), rng.uniform(10, 54, 8),
                         rng.uniform(10, 54, 8)], 1).astype(np.float32)
    drift = np.stack([np.zeros(8), rng.uniform(-0.7, 0.7, 8),
                      rng.uniform(-0.7, 0.7, 8)], 1).astype(np.float32)
    return centers0, drift


def test_recording_is_the_example_s(example):
    for name in ("SHAPE_ZYX", "Z_RATIO", "N_VOLS", "N_CELLS"):
        assert getattr(demo, name) == getattr(example, name)
    centers0, drift = demo.cells()
    w0, wd = example_cells()
    np.testing.assert_array_equal(centers0, w0)
    np.testing.assert_array_equal(drift, wd)
    for t in range(1, demo.N_VOLS + 1):
        img, lab = demo.make_volume(t, centers0, drift,
                                    np.random.RandomState(t))
        want, want_lab = example.make_volume(t, w0, wd,
                                             np.random.RandomState(t))
        assert img.dtype == want.dtype and lab.dtype == want_lab.dtype
        np.testing.assert_array_equal(img, want)
        np.testing.assert_array_equal(lab, want_lab)
        np.testing.assert_array_equal(
            demo.recording_volume(t, centers0, drift),
            (want / want.max() * 40000).astype(np.uint16))


def test_demo_runs_end_to_end_on_cpu(tmp_path, monkeypatch):
    """The whole demo with 2 StarDist steps and 5 FFN iterations: the
    results tree (seg/, auto_vol1/, track_results/), both CSVs, each
    stage's seconds and a finite median error; the raw slices are the
    recording's."""
    monkeypatch.setattr(demo, "SD_EPOCHS", 1)
    monkeypatch.setattr(demo, "SD_STEPS", 2)
    monkeypatch.setattr(demo, "FFN_ITERATIONS", 5)
    out = demo.main(["--out", str(tmp_path), "--device", "cpu"])
    res = tmp_path / "results"
    assert out["results"] == res
    for sub in ("seg", "auto_vol1", "track_results/coords_real",
                "track_results/labels"):
        assert any((res / sub).iterdir()), sub
    assert len(list((res / "seg").glob("coords*.npy"))) == demo.N_VOLS
    assert (res / "tracked_coordinates.csv").stat().st_size > 0
    assert (res / "activities.csv").stat().st_size > 0
    assert set(out["seconds"]) == {"recording", "train_stardist", "segment",
                                   "train_ffn", "track", "activities"}
    assert np.isfinite(out["median_error"])
    centers0, drift = demo.cells()
    got = np.stack([imageio.imread(p) for p in sorted(
        (tmp_path / "raw").glob("raw_t003_z*.tif"))])
    np.testing.assert_array_equal(
        got, demo.recording_volume(3, centers0, drift))
