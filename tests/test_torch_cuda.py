"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``; without a card every test skips.  These tests import no
JAX, so they also run where JAX is not installed (the card's machine):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import t3dct_torch  # noqa: E402,F401
from t3dct_torch.ops import hopper_conv, hopper_flood  # noqa: E402
from t3dct_torch.utils.device import pin_float32  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "have no CPU mode")
    pin_float32()
    return torch.device("cuda")


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(3, 17, 19, 1, 8), (4, 20, 35, 12, 40),
                                   (2, 16, 16, 33, 64)])
def test_conv_kernel_matches_plain(dev, shape, relu):
    z, y, x, ci, co = shape
    g = torch.Generator().manual_seed(ci)
    xin = torch.randn((z, y, x, ci), generator=g).to(dev)
    w = (torch.randn((3, 3, 3, ci, co), generator=g) / (27 * ci) ** 0.5
         ).to(dev)
    b = torch.randn((co,), generator=g).to(dev)
    n0 = hopper_conv.conv3x3x3_bias_relu.launches
    got = hopper_conv.conv3x3x3_bias_relu(xin, w, b, relu=relu)
    want = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b, relu=relu)
    torch.cuda.synchronize()
    assert hopper_conv.conv3x3x3_bias_relu.launches == n0 + 1
    # f32 accumulation in a different summation order than cuDNN
    bound = 1e-5 * float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= bound


@pytest.mark.parametrize("levels", [None, 2])
def test_flood_kernel_matches_plain(dev, levels):
    rng = np.random.RandomState(3)
    shape = (50, 37, 4)
    seg = np.zeros(shape, np.int32)
    for i in range(8):
        cx, cy = rng.randint(4, 46), rng.randint(4, 33)
        seg[cx - 4:cx + 4, cy - 4:cy + 4, :] = i + 1
    mask = rng.rand(*shape) < 0.95
    elev = (rng.rand(*shape) if levels is None
            else rng.randint(0, levels, shape)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (elev, seg, mask)]
    got, rounds = hopper_flood.flood_slices(*args)
    want, rounds_p = hopper_flood.flood_slices_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert rounds > 1


def test_wrappers_refuse_mixed_devices(dev):
    x = torch.zeros((2, 4, 4, 3), device=dev)
    w = torch.zeros((3, 3, 3, 3, 4))
    b = torch.zeros((4,), device=dev)
    with pytest.raises(ValueError):
        hopper_conv.conv3x3x3_bias_relu(x, w, b)
