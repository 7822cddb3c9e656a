"""The v1.0 entry point ``segment_and_track(handoff="device")`` against the
JAX package's, on the CPU, over a small TIFF recording: 4 volumes of the
bench scene at (8, 64, 48) with 12 cells, the small StarDist with seeded
weights and its pass-through path, the same weights in both packages.

Bounds: kept counts and seg coordinates exact; tracked coordinates within
1e-2 real units (the slice test's bound: the f32 EM moves JAX's own
output by ~2e-3 for a 1-ulp input change); labels at least 99.5% of
voxels equal per volume (a cell one rounding step apart moves ~30 voxels
of 18,432); prob maps within 1e-3, since both store the float16 map and
the backbones round differently (one float16 step is 4.9e-4 near 1); the
same file names in both trees.  Both runs draw the matching figures
(``save_figures=True``): the same file names and image sizes, and the
plotted point sets (the confirmed cells at t - 1, the segmented cells at
t, the tracked cells) within the coordinates' bound.  The 8-bit upload
(``transport="u8"``) and the EM's compensated M-step
(``m_step_refine=8``) are held to JAX's with the same bounds.  Then the
driver's edges: miss frames, a recording that ends early, a volume past
the tracker's pad, and the raises for bad arguments."""

import contextlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import t3dct_torch  # noqa: F401
import t3dct.viz as jviz
from t3dct.config import TrackingConfig as JTrackingConfig
from t3dct.engine.pipeline import segment_and_track as j_segment_and_track
from t3dct_torch.config import TrackingConfig
from t3dct_torch.engine import pipeline
from t3dct_torch.engine.pipeline import segment_and_track
from t3dct_torch.engine.stardist import StarDist3D
from t3dct_torch.io import imageio
from t3dct_torch.utils.timing import CudaStageTimer
from test_torch_scene import (INTERP, SHAPE, VOXEL_SIZE, ffn_pair,
                              recording, stardist_pair, torch_threads)

N_VOLS = 4
COORD_ATOL = 1e-2
LABELS_EQUAL = 0.995
PROB_ATOL = 1e-3


def write_recording(root: Path, vols, lab, skip=()):
    """Per-(t, z) uint16 slices and the proofed vol-1 labels, as the bench
    writes them; volumes in ``skip`` are left out."""
    for t, v in enumerate(vols, start=1):
        if t not in skip:
            imageio.save_label_slices(v.transpose(1, 2, 0), root / "raw",
                                      "raw_t%03i_z%04i.tif", t,
                                      use_8_bit=False, compression=None)
    return str(root / "raw" / "raw_t%03i_z*.tif")


def manual_vol1(results: Path, lab) -> str:
    imageio.save_label_slices(lab, results / "manual_vol1",
                              "manual_vol1_t%04i_z%04i.tif", 0,
                              use_8_bit=False, compression=None)
    return str(results / "manual_vol1" / "*.tif")


def run_port(pattern, results, lab, model, ffn, t_range=(1, N_VOLS),
             config_kw=None, **kwargs):
    kwargs.setdefault("handoff", "device")
    return segment_and_track(pattern, model, results,
                             manual_vol1(results, lab), ffn, VOXEL_SIZE,
                             INTERP, t_range,
                             TrackingConfig(**(config_kw or {})),
                             verbose=False, device="cpu", **kwargs)


def run_jax(pattern, results, lab, model, ffn, t_range=(1, N_VOLS),
            config_kw=None, **kwargs):
    out = j_segment_and_track(pattern, model, results,
                              manual_vol1(results, lab), ffn, VOXEL_SIZE,
                              INTERP, t_range,
                              JTrackingConfig(**(config_kw or {})),
                              verbose=False, handoff="device", **kwargs)
    return {t: np.asarray(c) for t, c in out.items()}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    vols, centers, lab = recording(N_VOLS, seed=1)
    return root, write_recording(root, vols, lab), vols, lab


@pytest.fixture(scope="module")
def models():
    jm, tm = stardist_pair()
    jffn, tffn = ffn_pair()
    return jm, tm, jffn, tffn


@contextlib.contextmanager
def figure_calls():
    """Record the arguments of every matching figure either package's
    drivers draw: ``{"jax": {t2: (confirmed t1, seg t2, tracked, t1)},
    "port": ...}``; the figures are still drawn."""
    calls = {"jax": {}, "port": {}}

    def recorder(side, draw):
        def record(tree, confirmed, seg, tracked, t1, t2):
            calls[side][t2] = tuple(np.array(a, np.float64) for a in
                                    (confirmed, seg, tracked)) + (t1,)
            return draw(tree, confirmed, seg, tracked, t1, t2)
        return record

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jviz, "save_matching_figure",
                   recorder("jax", jviz.save_matching_figure))
        mp.setattr(pipeline, "save_matching_figure",
                   recorder("port", pipeline.save_matching_figure))
        yield calls


def coords_close(got, want):
    np.testing.assert_allclose(got, want, atol=COORD_ATOL)


def hold_figures(jroot: Path, proot: Path, calls, tracked,
                 close=coords_close):
    """The same figure files of the same sizes, one per tracked volume;
    the segmented point sets exact, the confirmed and tracked ones held
    by ``close`` (the coordinates' bound), and the same titles."""
    from PIL import Image
    names = sorted(p.name for p in (jroot / "track_results/figure").iterdir())
    assert names == sorted(p.name for p in (proot / "track_results/figure")
                           .iterdir())
    assert names == ["matching_%06d.png" % t for t in tracked]
    for n in names:
        with Image.open(jroot / "track_results/figure" / n) as a, \
                Image.open(proot / "track_results/figure" / n) as b:
            assert a.size == b.size
    assert sorted(calls["jax"]) == sorted(calls["port"]) == list(tracked)
    for t, want in calls["jax"].items():
        got = calls["port"][t]
        assert got[3] == want[3] == t - 1
        np.testing.assert_array_equal(got[1], want[1])
        for g, w in zip(got[::2], want[::2]):
            assert g.shape == w.shape
            close(g, w)


@pytest.fixture(scope="module")
def runs(scene, models):
    """Both packages' device handoff over the recording, the matching
    figures drawn."""
    root, pattern, _, lab = scene
    jm, tm, jffn, tffn = models
    timer = CudaStageTimer()
    with figure_calls() as calls:
        want = run_jax(pattern, root / "jax", lab, jm, jffn,
                       save_figures=True)
        got = run_port(pattern, root / "port", lab, tm, tffn, timer=timer,
                       save_figures=True)
    return root, want, got, timer, calls


def files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_driver_coords_match_jax(runs):
    _, want, got, _, _ = runs
    assert sorted(got) == sorted(want) == list(range(1, N_VOLS + 1))
    for t in want:
        assert got[t].shape == want[t].shape and got[t].dtype == np.float32
        np.testing.assert_allclose(got[t], want[t], atol=COORD_ATOL)


def test_driver_tree_has_jax_files(runs):
    """The same files: seg/ and auto_vol1/ for every volume, vol 1's and
    every tracked volume's coords_real, labels and merged-label PNGs."""
    root, _, _, _, _ = runs
    names = files(root / "jax")
    assert files(root / "port") == names
    z = SHAPE[0]
    assert sum(n.startswith("seg/") for n in names) == 2 * N_VOLS
    assert sum(n.startswith("auto_vol1/") for n in names) == z
    assert sum(n.startswith("track_results/labels/") for n in names) == \
        N_VOLS * z
    assert sum("merged_labels" in n for n in names) == 2 * (N_VOLS - 1)
    assert sum("track_results/figure/" in n for n in names) == N_VOLS - 1


def test_driver_figures_match_jax(runs):
    """``save_figures=True``: a matching figure per tracked volume, as
    JAX's, drawn from the same point sets within the bounds."""
    root, _, _, _, calls = runs
    hold_figures(root / "jax", root / "port", calls,
                 range(2, N_VOLS + 1))


def test_driver_u8_matches_jax(scene, models, tmp_path):
    """``transport="u8"``: each volume quantized to 8 bits against its
    own percentiles on the host, normalized on the device with (0, 255);
    the same trees as JAX's u8 run, held with the bounds of the u16 run
    (seg coordinates exact)."""
    _, pattern, _, lab = scene
    jm, tm, jffn, tffn = models
    want = run_jax(pattern, tmp_path / "jax", lab, jm, jffn,
                   transport="u8")
    got = run_port(pattern, tmp_path / "port", lab, tm, tffn,
                   transport="u8")
    for t in want:
        np.testing.assert_allclose(got[t], want[t], atol=COORD_ATOL)
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    for t in range(1, N_VOLS + 1):
        np.testing.assert_array_equal(
            np.load(tmp_path / "port/seg" / f"coords{t:06d}.npy"),
            np.load(tmp_path / "jax/seg" / f"coords{t:06d}.npy"))
        np.testing.assert_allclose(
            np.load(tmp_path / "port/seg" / f"prob{t:06d}.npy"),
            np.load(tmp_path / "jax/seg" / f"prob{t:06d}.npy"),
            atol=PROB_ATOL)


def test_driver_refine_matches_jax(scene, models, runs, tmp_path):
    """``TrackingConfig(m_step_refine=8)``: the EM's compensated M-step
    (``ops.prgls``) through the device handoff, held to JAX's run of the
    same config with the bounds of the default run, and not the default
    run's coordinates; the port on one torch thread
    (``test_torch_scene.torch_threads``)."""
    _, pattern, _, lab = scene
    jm, tm, jffn, tffn = models
    refine = dict(m_step_refine=8)
    want = run_jax(pattern, tmp_path / "jax", lab, jm, jffn,
                   config_kw=refine)
    with torch_threads(1):
        got = run_port(pattern, tmp_path / "port", lab, tm, tffn,
                       config_kw=refine)
    assert sorted(got) == sorted(want) == list(range(1, N_VOLS + 1))
    for t in want:
        np.testing.assert_allclose(got[t], want[t], atol=COORD_ATOL)
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    for t in range(2, N_VOLS + 1):
        pat = "track_results/labels/track_results_t%06i_z*.tif" % t
        got_l, want_l = (np.stack([imageio.imread(p) for p in
                                   sorted((tmp_path / side).glob(pat))])
                         for side in ("port", "jax"))
        assert (got_l == want_l).mean() >= LABELS_EQUAL
    default = runs[2]
    assert any(not np.array_equal(got[t], default[t])
               for t in range(2, N_VOLS + 1))


def test_driver_seg_artifacts_match_jax(runs):
    """Kept counts and seg coordinates exact for every volume, prob maps
    to ``PROB_ATOL``, the vol-1 render exact."""
    root, _, _, _, _ = runs
    for t in range(1, N_VOLS + 1):
        got = np.load(root / "port/seg" / f"coords{t:06d}.npy")
        want = np.load(root / "jax/seg" / f"coords{t:06d}.npy")
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        gp = np.load(root / "port/seg" / f"prob{t:06d}.npy")
        wp = np.load(root / "jax/seg" / f"prob{t:06d}.npy")
        assert gp.dtype == wp.dtype == np.float32 and gp.shape == wp.shape
        np.testing.assert_allclose(gp, wp, atol=PROB_ATOL)
    for p in sorted((root / "jax/auto_vol1").iterdir()):
        np.testing.assert_array_equal(
            imageio.imread(root / "port/auto_vol1" / p.name),
            imageio.imread(p))


def test_driver_track_artifacts_match_jax(runs):
    """coords_real to ``COORD_ATOL``; the label TIFFs, read per volume, at
    least ``LABELS_EQUAL`` of voxels equal and of the same dtype; the
    merged-label PNGs decode to images of the same size."""
    root, _, _, _, _ = runs
    for t in range(1, N_VOLS + 1):
        np.testing.assert_allclose(
            np.load(root / "port/track_results/coords_real"
                    / f"coords{t:06d}.npy"),
            np.load(root / "jax/track_results/coords_real"
                    / f"coords{t:06d}.npy"), atol=COORD_ATOL)
        pat = "track_results/labels/track_results_t%06i_z*.tif" % t
        got = np.stack([imageio.imread(p) for p in
                        sorted((root / "port").glob(pat))])
        want = np.stack([imageio.imread(p) for p in
                         sorted((root / "jax").glob(pat))])
        assert got.dtype == want.dtype == np.uint8
        assert (got == want).mean() >= LABELS_EQUAL
    for p in sorted((root / "jax/track_results").glob("merged*/*.png")):
        rel = p.relative_to(root / "jax")
        assert np.asarray(Image.open(root / "port" / rel)).shape == \
            np.asarray(Image.open(p)).shape


def test_driver_timer_reads_each_stage(runs):
    """The stage timer holds a seg time per volume, a track time per
    tracked volume, the vol-1 interpolation and the whole call."""
    _, _, _, timer, _ = runs
    assert len(timer.times["seg"]) == N_VOLS
    assert len(timer.times["track"]) == N_VOLS - 1
    assert len(timer.times["call"]) == len(timer.times["interpolate_vol1"])
    assert timer.times["call"][0] > sum(timer.times["seg"])
    assert "seg" in timer.summary()


def test_driver_miss_frame_matches_jax(scene, models, tmp_path):
    """A missed volume is segmented but not tracked: it keeps the previous
    positions, has no track artifacts, and the next volume pairs with the
    last tracked one; as in JAX."""
    _, pattern, _, lab = scene
    jm, tm, jffn, tffn = models
    want = run_jax(pattern, tmp_path / "jax", lab, jm, jffn, miss_frame=[3])
    got = run_port(pattern, tmp_path / "port", lab, tm, tffn,
                   miss_frame=[3])
    np.testing.assert_array_equal(got[3], got[2])
    for t in want:
        np.testing.assert_allclose(got[t], want[t], atol=COORD_ATOL)
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert not list((tmp_path / "port").glob("track_results/**/*t000003*"))
    assert (tmp_path / "port/seg/coords000003.npy").exists()


def test_driver_truncated_recording_raises(scene, models, tmp_path):
    """Volume 3 is missing: volumes 1-2 are tracked and written, then the
    driver raises JAX's error."""
    _, _, vols, lab = scene
    _, tm, _, tffn = models
    pattern = write_recording(tmp_path, vols, lab, skip=(3,))
    with pytest.raises(RuntimeError, match="segmentation ended at t=2 "
                                           "before volume 3"):
        run_port(pattern, tmp_path / "port", lab, tm, tffn)
    assert (tmp_path / "port/track_results/coords_real/"
            "coords000002.npy").exists()
    assert not (tmp_path / "port/seg/coords000003.npy").exists()


class _PastPad(StarDist3D):
    """The small model, but every volume keeps ``n_kept`` candidates."""

    n_kept = 0

    def predict_instances_device(self, x_raw, norm_minmax,
                                 return_labels=True):
        import torch
        kept, probs, dists, points, prob_map, labels = \
            super().predict_instances_device(x_raw, norm_minmax,
                                             return_labels)
        g = torch.Generator().manual_seed(0)
        n = self.n_kept
        hi = torch.tensor(SHAPE)
        points = (torch.rand((n, 3), generator=g) * hi).to(torch.int32)
        return (torch.ones(n, dtype=torch.bool),
                torch.rand(n, generator=g), dists[:1].expand(n, -1),
                points, prob_map, labels)


@pytest.mark.parametrize("extra", [0, 1])
def test_driver_raises_past_max_cells(scene, models, tmp_path, extra):
    """A volume that keeps more candidates than the tracker's pad (64 for
    12 cells) raises JAX's error from the seg saver, and no track
    artifact of that volume is written; the pad itself is taken."""
    _, pattern, _, lab = scene
    _, tm, _, tffn = models
    model = _PastPad(tm.config, tm.params,
                     max_candidates=tm.max_candidates,
                     render_box=tm.render_box, device="cpu")
    model.n_kept = 64 + extra
    run = lambda: run_port(pattern, tmp_path / "port", lab,  # noqa: E731
                           model, tffn, t_range=(1, 2))
    if extra:
        with pytest.raises(ValueError,
                           match="65 cells exceeds max_cells=64"):
            run()
        assert not (tmp_path / "port/track_results/coords_real/"
                    "coords000002.npy").exists()
    else:
        run()
        assert np.load(tmp_path / "port/seg/coords000002.npy").shape == \
            (64, 3)


@pytest.mark.parametrize("kwargs,err,match", [
    (dict(handoff="wire"), ValueError, "handoff must be"),
    (dict(mesh=object()), TypeError, "DeviceMesh"),
    (dict(transport="u4"), ValueError, "transport must be"),
    (dict(config=TrackingConfig(ensemble=True), handoff="device"),
     ValueError, "supports single mode only"),
], ids=["bad_handoff", "mesh", "bad_transport", "ensemble"])
def test_driver_raises_for_what_is_not_ported(tmp_path, kwargs, err, match):
    """Each raises before anything is read or written: a mesh that is no
    ``DeviceMesh`` too (the mesh runs are ``tests/test_torch_mesh_*.py``)."""
    args = dict(config=TrackingConfig(), verbose=False, device="cpu")
    args.update(kwargs)
    with pytest.raises(err, match=match):
        segment_and_track(str(tmp_path / "raw_t%03i_z*.tif"), None,
                          tmp_path / "res", str(tmp_path / "m/*.tif"), None,
                          VOXEL_SIZE, INTERP, (1, 2), **args)
    assert not (tmp_path / "res").exists()


def test_driver_ensemble_message_is_jax(tmp_path):
    """The ensemble refusal is the JAX device handoff's own message."""
    with pytest.raises(ValueError) as want:
        j_segment_and_track("x_t%03i.tif", None, tmp_path, "m", None,
                            VOXEL_SIZE, INTERP, (1, 2),
                            JTrackingConfig(ensemble=True), handoff="device")
    with pytest.raises(ValueError) as got:
        segment_and_track("x_t%03i.tif", None, tmp_path, "m", None,
                          VOXEL_SIZE, INTERP, (1, 2),
                          TrackingConfig(ensemble=True), handoff="device",
                          device="cpu")
    assert str(got.value) == str(want.value)


def test_driver_model_on_another_device_raises(models, tmp_path):
    _, tm, _, _ = models
    with pytest.raises(ValueError, match="the model is on cpu"):
        segment_and_track(str(tmp_path / "r_t%03i_z*.tif"), tm, tmp_path,
                          "m", None, VOXEL_SIZE, INTERP, (1, 2),
                          device="meta")
