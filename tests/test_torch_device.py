"""The port's device contract, on the CPU: entry points and the helpers they
call run on the first CUDA card unless the caller passes ``device="cpu"``,
and without a card they raise instead of falling back."""

import json

import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct_torch.config import (SegmentationConfig, StarDistConfig,
                                TrackingConfig)
from t3dct_torch.coordinates import Coordinates
from t3dct_torch.engine.legacy import Tracker, legacy_segment_and_track_arrays
from t3dct_torch.engine.pipeline import segment_and_track_arrays
from t3dct_torch.engine.segmentation import UNetSegmenter
from t3dct_torch.engine.stardist import StarDist3D
from t3dct_torch.engine.transformer import CoordsToImageTransformer
from t3dct_torch.models import ffn, layers
from t3dct_torch.models.stardist3d import StarDist3DNet
from t3dct_torch.models.unet3d import UNet3D
from t3dct_torch.scripts import probe_conv_fast
from t3dct_torch.utils import convert
from t3dct_torch.utils.device import select_device

SHAPE = (8, 8, 2)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _stardist_load(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"arch": "tpu"}))
    return StarDist3D.load(tmp_path)


ENTRY_POINTS = {
    "segment_and_track_arrays": lambda tmp: segment_and_track_arrays(
        [], None, np.zeros(SHAPE, np.int32), None, (1.0, 1.0, 1.0), 1,
        TrackingConfig()),
    "legacy_segment_and_track_arrays":
        lambda tmp: legacy_segment_and_track_arrays(
            [np.zeros(SHAPE, np.float32)], (None, None, None), None,
            np.zeros(SHAPE, np.int32), SegmentationConfig()),
    "Tracker": lambda tmp: Tracker(1, SHAPE, 1.0, 1, 5.0, 10, 300.0, 0.1,
                                   20),
    "StarDist3D": lambda tmp: StarDist3D(StarDistConfig(), params={}),
    "StarDist3D.load": _stardist_load,
    "UNetSegmenter": lambda tmp: UNetSegmenter(
        UNet3D(), {}, {}, SegmentationConfig(), SHAPE),
    "CoordsToImageTransformer":
        lambda tmp: CoordsToImageTransformer((1.0, 1.0, 1.0)),
}

HELPERS = {
    "glorot_uniform": lambda g: layers.glorot_uniform((2, 3), 2, 3, g),
    "init_conv3d": lambda g: layers.init_conv3d((3, 3, 3), 2, 3, g),
    "UNet3D.init": lambda g: UNet3D().init(g),
    "StarDist3DNet.init": lambda g: StarDist3DNet(StarDistConfig()).init(g),
    "init_ffn": lambda g: ffn.init_ffn(g),
    "feature_distance_ffn": lambda g: ffn.feature_distance_ffn(g),
    "stardist_params_from_numpy": lambda g: convert.stardist_params_from_numpy(
        {"stem": {"w": np.zeros(3)}}),
    "unet_from_numpy": lambda g: convert.unet_from_numpy({}, {}),
    "ffn_from_numpy": lambda g: convert.ffn_from_numpy({}, {}),
    "Coordinates.from_raw": lambda g: Coordinates.from_raw(
        np.zeros((2, 3)), 1, (1, 1, 1)),
    "Coordinates.from_real": lambda g: Coordinates.from_real(
        np.zeros((2, 3)), 1, (1, 1, 1)),
    "probe_conv_fast.run": lambda g: probe_conv_fast.run(shape=(2, 4, 4)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises(no_card, tmp_path, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](tmp_path)


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helper_without_device_raises(no_card, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        HELPERS[name](torch.Generator().manual_seed(0))


def test_select_device():
    assert select_device("cpu") == torch.device("cpu")
    assert select_device(torch.device("cpu")) == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_select_device_default_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert select_device(None) == torch.device("cuda", 0)


def test_coordinates_keep_a_tensors_device(no_card):
    """A tensor's own device is the caller's choice: no card needed."""
    c = Coordinates.from_raw(torch.zeros((2, 3)), 1, (1, 1, 1))
    assert c.raw_f32.device.type == "cpu"
    r = Coordinates.from_real(c.real, 1, (1, 2, 3))
    assert r.raw_f32.device.type == "cpu"


def test_explicit_cpu_runs_without_a_card(no_card):
    g = torch.Generator().manual_seed(0)
    p = layers.init_conv3d((3, 3, 3), 2, 3, g, "cpu")
    assert p["w"].device.type == "cpu" and p["b"].device.type == "cpu"
    t = CoordsToImageTransformer((1.0, 1.0, 1.0), device="cpu")
    assert t.device == torch.device("cpu")
