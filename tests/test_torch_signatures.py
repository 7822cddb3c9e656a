"""Every public entry point of the JAX package binds to its twin in the
port with the same signature: the same parameter names in the same order,
of the same kinds, with the same defaults where they are plain values.
The port may add one keyword-only parameter, ``device``.  A JAX argument
the port has not ported yet is accepted and raises ``NotImplementedError``
naming its ``ROADMAP.md`` item (held by the tests of each module).

Entry points: the names the examples and the JAX package's docstring call
(``examples/*.py``), the legacy ``engine.legacy.Tracker`` of
``use_unet_legacy.py`` with every public method, its trainer
``TrainingUNet3D`` and ``UNetSegmenter.segment``, the Keras
importers of ``utils.keras_import``, ``utils.cache``, and the PR-GLS EM
with its compensated M-step (``ops.prgls``, ``ops.df32``) and the
functions that carry ``m_step_refine``."""

import importlib
import inspect
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import t3dct  # noqa: E402,F401
import t3dct_torch  # noqa: E402,F401

# every public method of JAX's legacy Tracker, and of its U-Net trainer
LEGACY_METHODS = (
    "__init__", "set_segmentation", "set_tracking", "load_unet",
    "load_unet_arrays", "load_ffn", "load_ffn_arrays",
    "precompute_segmentation", "segment_vol1", "retrain_unet",
    "select_unet_weights", "load_manual_seg", "interpolate_seg",
    "cal_subregions", "initiate_tracking", "draw_prediction_grid",
    "draw_correction", "draw_overlapping", "draw_segresult",
    "draw_manual_seg1", "subplots_tracking", "match", "track",
    "track_one_vol", "replay_track_animation", "save_coordinates")
UNET_TRAINER_METHODS = (
    "__init__", "load_dataset", "load_dataset_arrays", "preprocess",
    "draw_dataset", "draw_norm_dataset", "draw_divided_train_data",
    "draw_prediction", "validation_loss", "train", "select_weights")

ENTRY_POINTS = [
    ("engine.stardist", name) for name in (
        "StarDist3D.__init__", "StarDist3D.load", "StarDist3D.save",
        "StarDist3D.predict", "StarDist3D.predict_sparse",
        "StarDist3D.predict_instances", "StarDist3D.predict_instances_tiled",
        "StarDist3D.predict_instances_sharded", "load_stardist_model",
        "load_stardist_keras_dir", "predict_and_save", "save_arrays_to_folder", "save_auto_seg_vol1",
        "print_dict", "load_training_images", "configure",
        "calculate_extents", "fill_label_holes")
] + [
    ("engine.pipeline", "segment_and_track"),
    ("engine.pipeline", "track_timelapse"),
] + [
    ("engine.transformer", "CoordsToImageTransformer." + name)
    for name in ("__init__", "load_segmentation", "load_segmentation_array",
                 "interpolate", "move_cells", "move_cells_in_3d_image",
                 "get_cells_on_boundary", "load_prob_map",
                 "accurate_correction", "save_tracking_results")
] + [
    ("engine.tracker", "TrackerLite." + name)
    for name in ("__init__", "predict_cell_positions",
                 "predict_cell_positions_ensemble", "match_by_ffn",
                 "activities")
] + [
    ("engine.tracker", "get_volumes_list"),
    ("engine.tracker", "evenly_distributed_volumes"),
    ("engine.metrics", "optimize_thresholds"),
    ("engine.analyses", "get_activities"),
    ("models.train_stardist", "TrainStarDist3D.__init__"),
    ("models.train_stardist", "TrainStarDist3D.train"),
    ("models.train_ffn", "TrainFFN.__init__"),
    ("models.train_ffn", "TrainFFN.train"),
] + [
    ("coordinates", "Coordinates." + name)
    for name in ("from_raw", "from_real", "from_interp", "make",
                 "with_raw")
] + [
    ("io.imageio", name)
    for name in ("load_2d_slices_at_time", "get_t_range",
                 "save_label_slices", "imread_volume", "imwrite_volume",
                 "load_image", "read_image_ts", "save_recording_h5")
] + [
    ("utils.keras_import", name)
    for name in ("read_keras_h5", "import_unet3", "import_ffn",
                 "import_stardist3d", "stardist_config_from_json",
                 "KerasGraph.__init__", "KerasGraph.from_h5")
] + [
    ("engine.legacy", name) for name in (
        "get_tracking_path", "get_reference_vols", "get_remote_vols",
        "Paths.__init__", "Paths.make_folders")
] + [
    ("engine.legacy", "Tracker." + name)
    for name in LEGACY_METHODS
] + [
    ("models.train_unet", "TrainingUNet3D." + name)
    for name in UNET_TRAINER_METHODS
] + [
    ("models.train_unet", "divide_img"),
    ("engine.segmentation", "UNetSegmenter.segment"),
    ("engine.segmentation", "UNetSegmenter.predict_cellregions"),
    ("engine.segmentation", "UNetSegmenter.__init__"),
    ("models.unet3d", "UNet3D.apply"),
    ("models.stardist3d", "StarDist3DNet.apply"),
    ("models.stardist3d", "StarDist3DNet.__init__"),
    ("models.layers", "dense"),
    ("utils.cache", "enable_compilation_cache"),
    ("io.imageio", "percentile_normalize"),
] + [
    # the EM with the compensated M-step and the drivers that carry it
    ("ops.prgls", "prgls_with_two_ref"),
    ("ops.prgls", "prgls_quick"),
    ("engine.tracker", "track_step"),
    ("parallel.ensemble", "ensemble_member_predictions"),
    ("parallel.ensemble", "ensemble_track_step"),
] + [
    ("ops.df32", name) for name in (
        "two_sum", "fast_two_sum", "two_prod", "df_add", "df_sum",
        "compensated_residual")
]
# the port's own keyword-only extras beyond ``device``: the U-Net's
# forward over a mesh's blocks (JAX's sharding is the jit's, not apply's)
PORT_EXTRAS = {("models.unet3d", "UNet3D.apply"): ["mesh_axes"]}
# the functions that take JAX's compute_dtype, and its default in each
COMPUTE_DTYPE = [
    ("models.layers", "conv3d", "float32"),
    ("models.layers", "dense", "float32"),
    ("models.unet3d", "UNet3D.apply", "float32"),
    ("models.stardist3d", "StarDist3DNet.apply", "float32"),
    ("models.stardist3d", "StarDist3DNet._apply_keras", "float32"),
    ("engine.segmentation", "UNetSegmenter.__init__", "bfloat16"),
]

PLAIN = (type(None), bool, int, float, str, tuple)


def _resolve(package, module, qualname):
    obj = importlib.import_module(f"{package}.{module}")
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


@pytest.mark.parametrize("module,qualname", ENTRY_POINTS,
                         ids=[f"{m}.{q}" for m, q in ENTRY_POINTS])
def test_port_signature_binds_jax(module, qualname):
    want = _params(_resolve("t3dct", module, qualname))
    got = _params(_resolve("t3dct_torch", module, qualname))
    extra = got[len(want):]
    assert [p.name for p in got[:len(want)]] == [p.name for p in want]
    assert [p.name for p in extra] in ([], ["device"],
                                       PORT_EXTRAS.get((module, qualname)))
    for p in extra:
        assert p.kind is inspect.Parameter.KEYWORD_ONLY
        assert p.default is None
    for w, g in zip(want, got):
        assert g.kind == w.kind, w.name
        assert (g.default is inspect.Parameter.empty) == \
            (w.default is inspect.Parameter.empty), w.name
        if isinstance(w.default, PLAIN):
            assert g.default == w.default, w.name


@pytest.mark.parametrize("module,qualname,dtype", COMPUTE_DTYPE,
                         ids=[f"{m}.{q}" for m, q, _ in COMPUTE_DTYPE])
def test_compute_dtype_binds_jax(module, qualname, dtype):
    """``compute_dtype`` where JAX has it: the parameters up to it bind
    JAX's, and its default is the torch twin of JAX's (``layers.conv3d``
    adds ``relu``, keyword-only, after it)."""
    import jax.numpy as jnp
    import torch
    want = _params(_resolve("t3dct", module, qualname))
    got = _params(_resolve("t3dct_torch", module, qualname))
    i = [p.name for p in want].index("compute_dtype")
    assert [p.name for p in got[:i + 1]] == [p.name for p in want[:i + 1]]
    assert jnp.dtype(want[i].default).name == dtype
    assert got[i].default == getattr(torch, dtype)
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY for p in
               got[len(want):])


def test_entry_points_cover_the_examples():
    """Every StarDist / workflow name a v1.0 example imports is bound
    above."""
    bound = {q.split(".")[0] for _, q in ENTRY_POINTS}
    for name in ("StarDist3D", "predict_and_save", "load_stardist_model",
                 "track_timelapse", "TrackerLite", "TrainStarDist3D",
                 "TrainFFN", "Coordinates", "configure",
                 "load_training_images", "get_t_range", "save_label_slices"):
        assert name in bound, name


@pytest.mark.parametrize("module,cls,names", [
    ("engine.legacy", "Tracker", LEGACY_METHODS),
    ("models.train_unet", "TrainingUNet3D", UNET_TRAINER_METHODS)])
def test_legacy_methods_cover_jax(module, cls, names):
    """The lists above are every public method of JAX's class."""
    obj = _resolve("t3dct", module, cls)
    public = {n for n in vars(obj) if callable(getattr(obj, n))
              and not n.startswith("_")} | {"__init__"}
    assert public == set(names)
