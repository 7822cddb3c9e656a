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
from t3dct_torch.ops import (  # noqa: E402
    hopper_cc, hopper_conv, hopper_flood, ladder)
from t3dct_torch.utils import cuda_build  # noqa: E402
from t3dct_torch.utils.device import pin_float32  # noqa: E402
from t3dct_torch.utils.synthetic import serpentine  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "have no CPU mode")
    pin_float32()
    return torch.device("cuda")


def _counts():
    return [k.launches for k in hopper_conv.KERNELS]


def _conv_case(shape, seed, batch=()):
    z, y, x, ci, co = shape
    g = torch.Generator().manual_seed(seed)
    xin = torch.randn(batch + (z, y, x, ci), generator=g)
    w = torch.randn((3, 3, 3, ci, co), generator=g) / (27 * ci) ** 0.5
    b = torch.randn((co,), generator=g)
    return xin, w, b


def _held(got, want):
    # f32 accumulation in a different summation order than cuDNN (TF32 off)
    bound = 1e-5 * float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= bound


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(3, 17, 19, 1, 8), (4, 20, 35, 12, 40),
                                   (2, 16, 16, 33, 64)])
def test_conv_kernel_matches_plain(dev, shape, relu):
    """Widths off the tensor-core rule (c_in 1, 12, 33) take the direct
    kernel: one launch of it, none of the other."""
    xin, w, b = (t.to(dev) for t in _conv_case(shape, shape[3]))
    assert hopper_conv.route(shape[3], shape[4]) == "direct"
    n0 = _counts()
    got = hopper_conv.conv3x3x3_bias_relu(xin, w, b, relu=relu)
    want = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b, relu=relu)
    torch.cuda.synchronize()
    assert _counts() == [n0[0] + 1, *n0[1:]]
    _held(got, want)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("c_out", [1, 8, 16, 32, 40])
@pytest.mark.parametrize("z", [1, 2, 3])
@pytest.mark.parametrize("width", [45, 13])
def test_stem_kernel_matches_plain(dev, width, c_out, z, relu):
    """The c_in = 1 stems: every output tile (8, 16, 32, and 40 as two
    tiles), both pixel tile widths (x 45 takes 32, x 13 takes 16), ragged
    y/x edges, z from 1 to 3, a batch of 5; one launch of the direct kernel
    and none of the other."""
    xin, w, b = (t.to(dev) for t in _conv_case((z, 37, width, 1, c_out),
                                               c_out + z, (5,)))
    assert hopper_conv.route(1, c_out) == "direct"
    n0 = _counts()
    got = hopper_conv.conv3x3x3_bias_relu(xin, w, b, relu=relu)
    want = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b, relu=relu)
    torch.cuda.synchronize()
    assert _counts() == [n0[0] + 1, *n0[1:]]
    assert got.shape == want.shape
    _held(got, want)
    one = hopper_conv.conv3x3x3_direct(xin[3], w, b, relu=relu)
    _held(one, want[3])


def test_conv_kernel_batch_is_one_launch(dev):
    """A tile batch (the legacy U-Net's layers) is one launch and equals
    the plain batched conv, without the ReLU as the U-Net calls it; at
    c_in 8 -> c_out 16 it is the tensor-core kernel's launch."""
    xin, w, b = (t.to(dev) for t in _conv_case((24, 20, 16, 8, 16), 5,
                                               (5,)))
    n0 = _counts()
    got = hopper_conv.conv3x3x3_bias_relu(xin, w, b, relu=False)
    want = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b, relu=False)
    torch.cuda.synchronize()
    assert _counts() == [n0[0], n0[1] + 1, *n0[2:]]
    _held(got, want)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 17, 19, 8, 8), (2, 17, 19, 32, 16), (2, 9, 33, 96, 32),
    (1, 12, 20, 192, 64), (2, 17, 19, 32, 128), (3, 8, 16, 8, 64),
    (2, 11, 7, 16, 136), (2, 13, 21, 8, 24)])
def test_wgmma_kernel_matches_plain(dev, shape, relu):
    """c_out 8-128 (every N tile), 136 (two tiles) and 24 (a padded tile);
    c_in 8, 16, 32, 96 and 192; ragged y/x edges (17x19, 9x33, 11x7); z = 1,
    2 and 3.  One launch of the tensor-core kernel, none of the other."""
    xin, w, b = (t.to(dev) for t in _conv_case(shape, sum(shape)))
    assert hopper_conv.route(shape[3], shape[4]) == "wgmma"
    n0 = _counts()
    got = hopper_conv.conv3x3x3_bias_relu(xin, w, b, relu=relu)
    want = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b, relu=relu)
    torch.cuda.synchronize()
    assert _counts() == [n0[0], n0[1] + 1, *n0[2:]]
    assert got.shape == want.shape
    _held(got, want)


@pytest.mark.parametrize("shape", [(2, 17, 19, 32, 8), (1, 9, 21, 8, 128)])
def test_wgmma_kernel_batch_of_five(dev, shape):
    """Five volumes in one launch: a z-halo at a volume's edge reads zeros,
    not the next volume."""
    xin, w, b = (t.to(dev) for t in _conv_case(shape, 11, (5,)))
    n0 = hopper_conv.conv3x3x3_wgmma.launches
    got = hopper_conv.conv3x3x3_wgmma(xin, w, b, relu=False)
    want = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b, relu=False)
    torch.cuda.synchronize()
    assert hopper_conv.conv3x3x3_wgmma.launches == n0 + 1
    _held(got, want)
    for i in range(5):
        _held(got[i], hopper_conv.conv3x3x3_bias_relu_plain(
            xin[i], w, b, relu=False))


@pytest.mark.parametrize("shape", [(24, 32, 84, 32, 32), (6, 8, 21, 128,
                                                         128),
                                   (32, 12, 12, 8, 16), (24, 32, 84, 1, 32),
                                   (32, 48, 48, 1, 8)])
def test_tile_batch_equals_single_tiles(dev, shape):
    """A batch of 8 tiles (the tiled StarDist path's backbone call) in one
    launch equals 8 single-tile launches bit for bit, on both kernels (the
    direct kernel's z-segments are planned by batch size)."""
    xin, w, b = (t.to(dev) for t in _conv_case(shape, 13, (8,)))
    got = hopper_conv.conv3x3x3_bias_relu(xin, w, b, relu=True)
    singles = torch.stack([hopper_conv.conv3x3x3_bias_relu(
        xin[i].contiguous(), w, b, relu=True) for i in range(8)])
    torch.cuda.synchronize()
    assert torch.equal(got, singles)
    _held(got, hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b, relu=True))


def test_wgmma_kernel_raises_without_fallback(dev):
    """A misaligned input or widths off the rule raise on the card; nothing
    is launched and no other kernel takes the call."""
    xin, w, b = (t.to(dev) for t in _conv_case((2, 8, 16, 8, 16), 2))
    flat = torch.zeros(xin.numel() + 1, device=dev)
    shifted = flat[1:].view(xin.shape)       # 4 bytes off a 16-byte line
    n0 = _counts()
    with pytest.raises(ValueError):
        hopper_conv.conv3x3x3_bias_relu(shifted, w, b)
    with pytest.raises(ValueError):
        hopper_conv.conv3x3x3_wgmma(xin[..., :4].contiguous(),
                                    w[:, :, :, :4].contiguous(), b)
    assert _counts() == n0


def _held_bf16(got, xin, w, b, relu):
    """The bf16 forms against the plain bf16 version (an f32 conv of the
    bf16-rounded operands, TF32 off): within 1e-5 of sum |x w| + |b| per
    output, the room the wgmma accumulator's truncated adds take."""
    bf = torch.bfloat16
    want = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b, relu, bf)
    scale = hopper_conv.conv3x3x3_bias_relu_plain(
        hopper_conv.round_bf16(xin).abs(), hopper_conv.round_bf16(w).abs(),
        b.abs(), False)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(((got - want).abs() / scale).max()) <= 1e-5


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 17, 19, 8, 8), (2, 17, 19, 32, 16), (2, 9, 33, 96, 32),
    (1, 12, 20, 192, 64), (2, 17, 19, 32, 128), (3, 8, 16, 8, 64),
    (2, 11, 7, 16, 136), (2, 13, 21, 24, 24), (3, 10, 12, 40, 8)])
def test_wgmma_bf16_kernel_matches_plain(dev, shape, relu):
    """The one-pass bf16 form: every N tile, two tiles (136), c_in with a
    half chunk (8, 24, 40) and whole ones, ragged y/x, z 1-3; one launch of
    it and none of the other kernels."""
    xin, w, b = (t.to(dev) for t in _conv_case(shape, sum(shape)))
    assert hopper_conv.route(shape[3], shape[4], torch.bfloat16) == \
        "wgmma_bf16"
    n0 = _counts()
    got = hopper_conv.conv3x3x3_bias_relu(xin, w, b, relu,
                                          compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert _counts() == [*n0[:3], n0[3] + 1]
    _held_bf16(got, xin, w, b, relu)


@pytest.mark.parametrize("shape", [(2, 17, 19, 32, 8), (1, 9, 21, 8, 128)])
def test_wgmma_bf16_batch_of_five(dev, shape):
    """Five volumes in one launch of the bf16 form, each as its own."""
    xin, w, b = (t.to(dev) for t in _conv_case(shape, 17, (5,)))
    got = hopper_conv.conv3x3x3_wgmma_bf16(xin, w, b, relu=False)
    torch.cuda.synchronize()
    _held_bf16(got, xin, w, b, False)
    for i in range(5):
        _held_bf16(got[i], xin[i], w, b, False)


@pytest.mark.parametrize("shape", [(3, 37, 45, 1, 8), (2, 37, 13, 1, 40),
                                   (16, 40, 16, 1, 8), (4, 20, 35, 12, 40)])
def test_stem_bf16_kernel_matches_plain(dev, shape):
    """The direct kernel with its operands rounded on load (c_in 1 stems
    and a width off the tensor-core rule): one launch of it, none of the
    other kernels."""
    xin, w, b = (t.to(dev) for t in _conv_case(shape, shape[4], (3,)))
    assert hopper_conv.route(shape[3], shape[4], torch.bfloat16) == \
        "direct_bf16"
    n0 = _counts()
    got = hopper_conv.conv3x3x3_bias_relu(xin, w, b, True,
                                          compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert _counts() == [*n0[:2], n0[2] + 1, n0[3]]
    _held_bf16(got, xin, w, b, True)


def test_bf16_layers_and_smem(dev):
    """``layers.conv3d`` in bf16 takes the bf16 forms; each N tile's bf16
    block fits the 227 KB a block may take; the f32 path is unchanged."""
    from t3dct_torch.models import layers as L
    for nb in hopper_conv.N_TILES:
        assert 0 < hopper_conv.wgmma_smem_bytes(nb, bf16=True) <= 232448
    xin, w, b = (t.to(dev) for t in _conv_case((2, 16, 16, 16, 32), 3, (2,)))
    n0 = _counts()
    got = L.conv3d({"w": w, "b": b}, xin, torch.bfloat16)
    torch.cuda.synchronize()
    assert _counts() == [*n0[:3], n0[3] + 1]
    _held_bf16(got, xin, w, b, False)
    with pytest.raises(NotImplementedError, match="A.4"):
        x = xin.clone().requires_grad_(True)
        L.conv3d({"w": w, "b": b}, x, torch.bfloat16).sum().backward()


# cc cases: (shape, tile_max of the host's plan (None: the kernel's), mask);
# shapes ragged on every axis at the card's plan (z past TILE_Z_MAX, with z
# % 4 = 2 and 0: byte and word loads), small tiles (ragged everywhere, one
# a block, or more of them than the card holds blocks: several a block),
# axes of length 1, the full pipeline frame
CC_CASES = {
    "sparse": ((61, 47, 9), None, "sparse"),
    "dense": ((61, 47, 9), None, "dense"),
    "snake": ((61, 47, 9), None, "snake"),
    "empty": ((61, 47, 9), None, "empty"),
    "full": ((61, 47, 9), None, "full"),
    "ragged bytes": ((29, 21, 70), None, "dense"),
    "ragged words": ((29, 21, 68), None, "dense"),
    "small tiles": ((61, 47, 9), 150, "dense"),
    "small tiles snake": ((61, 47, 9), 150, "snake"),
    "many tiles per block": ((61, 47, 9), 8, "sparse"),
    "many tiles per block snake": ((61, 47, 10), 8, "snake"),
    "snake ragged": ((29, 21, 70), None, "snake"),
    "x 1": ((1, 50, 40), None, "dense"),
    "y 1": ((50, 1, 40), None, "dense"),
    "z 1": ((50, 40, 1), None, "dense"),
    "frame sparse": ((401, 168, 24), None, "sparse"),
    "frame snake": ((401, 168, 24), None, "snake"),
    "frame full": ((401, 168, 24), None, "full"),
}


def _cc_mask(shape, kind, seed):
    rng = np.random.RandomState(seed)
    return {"sparse": lambda: rng.rand(*shape) < 0.2,
            "dense": lambda: rng.rand(*shape) < 0.55,
            "snake": lambda: serpentine(shape),
            "empty": lambda: np.zeros(shape, bool),
            "full": lambda: np.ones(shape, bool)}[kind]()


def _cc_held(m, per_slice):
    """cc_label on the card: exact against the plain version, one launch."""
    n0 = hopper_cc.cc_label.launches
    got = hopper_cc.cc_label(m, per_slice=per_slice)
    want = hopper_cc.label_components_raw_plain(m, per_slice=per_slice)
    torch.cuda.synchronize()
    assert hopper_cc.cc_label.launches == n0 + 1
    assert got.dtype == torch.int32 and got.shape == m.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("per_slice", [False, True])
@pytest.mark.parametrize("case", list(CC_CASES))
def test_cc_kernel_matches_plain(dev, per_slice, case, monkeypatch):
    """Exact: the kernel and the plain loop give every voxel its
    component's smallest flat index, in one launch per call."""
    shape, tile_max, kind = CC_CASES[case]
    if tile_max is not None:
        monkeypatch.setattr(hopper_cc, "TILE_MAX", tile_max)
        resident = cuda_build.resident_blocks("cc", "cc_blocks_per_sm", dev)
        n_tiles = hopper_cc.tile_plan(shape, resident, tile_max)[1]
        assert (n_tiles > resident) == case.startswith("many tiles")
    m = torch.from_numpy(_cc_mask(shape, kind, len(case))).to(dev)
    got = _cc_held(m, per_slice)
    if kind == "snake":
        assert int(got.max()) == 1 if per_slice else len(got.unique()) == 2


@pytest.mark.parametrize("shape", [(1,), (1000,), (4099,), (1, 1), (70, 90),
                                   (1, 300), (300, 1), (1, 1, 1)])
def test_cc_kernel_on_1d_and_2d_masks(dev, shape):
    """1-D and 2-D masks (padded to three axes by the wrapper), exact, one
    launch per call."""
    rng = np.random.RandomState(sum(shape))
    m = torch.from_numpy(rng.rand(*shape) < 0.6).to(dev)
    _cc_held(m, False)


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
    n0 = hopper_flood.flood_slices.launches
    got, rounds = hopper_flood.flood_slices(*args)
    want, rounds_p = hopper_flood.flood_slices_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert rounds > 1
    assert hopper_flood.flood_slices.launches == n0 + 1


def _exact_rounds(args, max_iters, monkeypatch):
    """The plain version with a convergence check after every round: the
    round the kernel must stop at."""
    monkeypatch.setattr(hopper_flood, "CHECK_EVERY", 1)
    return hopper_flood.flood_slices_plain(*args, max_iters=max_iters)


def _flood_scene(case, shape=(64, 48, 5), seed=0):
    rng = np.random.RandomState(seed)
    elev = rng.rand(*shape).astype(np.float32)
    seg = np.zeros(shape, np.int32)
    mask = np.ones(shape, bool)
    if case == "far":          # one corner marker per slice: ~100 rounds
        seg[0, 0, :] = 1
        seg[-1, -1, 1::2] = 2
    elif case == "uneven":     # slices that converge at very different rounds
        for s in range(shape[2]):
            n = 1 + 40 * s
            for i in range(n):
                seg[rng.randint(shape[0]), rng.randint(shape[1]), s] = i + 1
    elif case == "empty":      # no mask at all
        mask[:] = False
        seg[3, 3, :] = 1
    elif case == "markers":    # slice 1 is markers only, slice 3 unmasked
        seg[:, :, 1] = rng.randint(1, 5, shape[:2])
        seg[5, 7, 0] = seg[20, 30, 2] = 3
        mask[:, :, 3] = False
        mask[:, :, 4] = rng.rand(*shape[:2]) < 0.7
        seg[10, 10, 4] = 9
    elif case == "ties":       # integer elevations: many exact ties
        elev = rng.randint(0, 2, shape).astype(np.float32)
        for i in range(12):
            seg[rng.randint(shape[0]), rng.randint(shape[1]), :] = i + 1
    return [torch.from_numpy(a) for a in (elev, seg, mask)]


@pytest.mark.parametrize("max_iters", [1, 7, 17, 512])
@pytest.mark.parametrize("case", ["far", "uneven", "empty", "markers",
                                  "ties"])
def test_flood_kernel_exact_at_every_cap(dev, case, max_iters, monkeypatch):
    """Bit-equal labels at caps of 1, 7 and 17 rounds (stopping at exactly
    that round) and at convergence; the kernel stops at the first round
    that changes nothing, in one launch; its tile list is
    ``active_tiles``."""
    args = [t.to(dev) for t in _flood_scene(case)]
    n0 = hopper_flood.flood_slices.launches
    r0 = hopper_flood.flood_slices.rounds
    got, rounds = hopper_flood.flood_slices(*args, max_iters=max_iters)
    want, rounds_p = _exact_rounds(args, max_iters, monkeypatch)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert rounds == rounds_p
    if case == "far":            # far from converged at every small cap
        assert max_iters == 512 or rounds == max_iters
    assert hopper_flood.flood_slices.launches == n0 + 1
    assert hopper_flood.flood_slices.rounds == r0 + rounds
    assert hopper_flood.flood_slices.tiles == hopper_flood.active_tiles(
        args[1], args[2])


def test_flood_kernel_on_a_512_slice(dev, monkeypatch):
    """A (512, 512, 4) stack, the zebrafish slice size: the same kernel,
    bit-equal to the plain version, one launch."""
    args = [t.to(dev) for t in _flood_scene("uneven", (512, 512, 4), 7)]
    n0 = hopper_flood.flood_slices.launches
    got, rounds = hopper_flood.flood_slices(*args)
    want, rounds_p = _exact_rounds(args, 512, monkeypatch)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert rounds == rounds_p
    assert hopper_flood.flood_slices.launches == n0 + 1


def test_wrappers_refuse_mixed_devices(dev):
    with pytest.raises(TypeError):
        hopper_cc.cc_label(torch.zeros((4, 4, 2), device=dev))
    x = torch.zeros((2, 4, 4, 3), device=dev)
    w = torch.zeros((3, 3, 3, 3, 4))
    b = torch.zeros((4,), device=dev)
    with pytest.raises(ValueError):
        hopper_conv.conv3x3x3_bias_relu(x, w, b)


@pytest.mark.parametrize("n", [0, 1, 7, 4096, 100003])
def test_add_one_kernel_matches_plain_exactly(dev, n):
    """The float4 body and the scalar tail, and an unaligned view: one
    launch each."""
    x = torch.randn((n + 1,), generator=torch.Generator().manual_seed(n)
                    ).to(dev)
    for v in (x[:n], x[1:]):
        n0 = ladder.ladder_add_one.launches
        got = ladder.ladder_add_one(v)
        torch.cuda.synchronize()
        # an empty tensor launches nothing
        assert ladder.ladder_add_one.launches == n0 + (n > 0)
        assert torch.equal(got, ladder.ladder_add_one_plain(v))


def _add_one_held(v):
    n0 = ladder.ladder_add_one.launches
    got = ladder.ladder_add_one(v)
    torch.cuda.synchronize()
    assert ladder.ladder_add_one.launches == n0 + 1
    assert got.shape == v.shape
    assert torch.equal(got, ladder.ladder_add_one_plain(v))


@pytest.mark.parametrize("n", [1, 3, 5, 255, 256, 257, 1023, 1029,
                               4 * 256 * 4 + 6])
def test_ladder_add_one_below_one_block_and_ragged_tails(dev, n):
    """Sizes below one block of float4s, at it, just past it, and with a
    ragged tail of 1-3 floats: exact, one launch per call."""
    g = torch.Generator().manual_seed(n)
    _add_one_held(torch.randn((n,), generator=g).to(dev))


@pytest.mark.parametrize("n", [8, 4096, 1 << 20, 3 * (1 << 20) + 5])
def test_ladder_add_one_unaligned_view(dev, n):
    """A view 4 bytes off a 16-byte line (all floats take the scalar
    path): exact, one launch per call."""
    flat = torch.randn((n + 1,), generator=torch.Generator().manual_seed(n)
                       ).to(dev)
    v = flat[1:]
    assert v.data_ptr() % 16 == 4
    _add_one_held(v)


@pytest.mark.parametrize("shape", [(24, 204, 84, 32), (3, 1, 5)])
def test_ladder_add_one_many_passes(dev, shape):
    """The probe's tensor (more float4s than the resident grid takes in
    one unrolled pass) and a small 3-D one: exact, one launch per call;
    the grid never exceeds the card's resident blocks."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1)).to(dev)
    _add_one_held(x)
    resident = cuda_build.resident_blocks(
        "ladder", "ladder_add_one_blocks_per_sm", dev)
    n4, blocks = ladder.add_one_plan(x.numel(), True, resident)
    assert blocks <= resident and n4 == x.numel() // 4


@pytest.mark.parametrize("shape", [(3, 7, 5, 32, 32), (2, 9, 11, 8, 40),
                                   (1, 1, 130, 48, 16), (1, 1, 100, 32, 32),
                                   (3, 100, 301, 32, 32), (2, 5, 7, 5, 3)])
def test_pointwise_matmul_kernel_matches_plain(dev, shape):
    """The probe's widths, N tiles of 8, 16 and 32 (c_out 40 as two), M
    below one tile (100 rows), more tiles than resident blocks with a
    ragged last tile (90,300 rows), and widths off the 16-byte rule
    (5 -> 3, padded); one launch each."""
    z, y, x, ci, co = shape
    g = torch.Generator().manual_seed(ci + co)
    xin = torch.randn((z, y, x, ci), generator=g).to(dev)
    w = torch.rand((ci, co), generator=g).to(dev)
    n0 = ladder.ladder_pointwise_matmul.launches
    got = ladder.ladder_pointwise_matmul(xin, w)
    want = ladder.ladder_pointwise_matmul_plain(xin, w)
    torch.cuda.synchronize()
    assert ladder.ladder_pointwise_matmul.launches == n0 + 1
    assert got.shape == want.shape
    # f32 sums in another order than cuBLAS
    bound = 1e-5 * float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= bound


@pytest.mark.parametrize("shape", [(3, 17, 19, 32, 32), (2, 9, 33, 32, 128),
                                   (4, 8, 16, 5, 40), (2, 11, 7, 8, 200),
                                   (2, 13, 21, 32, 8), (3, 9, 18, 16, 16),
                                   (2, 11, 7, 8, 136), (1, 17, 19, 32, 32),
                                   (1, 6, 9, 48, 24)])
def test_conv9view_kernel_matches_plain(dev, shape):
    """Every N tile (8, 16, 32 with c_out 24 padded into it, 64 for c_out
    40, 128, two of them for 136 and 200); c_in 5 (padded to 8), 8, 16, 32
    (one halo group of four chunks) and 48 (three groups of two); ragged
    tiles in y and x; z = 1, 2, 3 and 4."""
    z, y, x, ci, co = shape
    g = torch.Generator().manual_seed(ci * co)
    xin = torch.rand((z, y, x, ci), generator=g).to(dev)
    w = (torch.randn((3, 3, 3, ci, co), generator=g) / (27 * ci) ** 0.5
         ).to(dev)
    b = (torch.randn((co,), generator=g) * 0.1).to(dev)
    w9 = ladder.pack_w9(w)
    n0 = ladder.ladder_conv9view_bias_relu.launches
    got = ladder.ladder_conv9view_bias_relu(xin, w9, b)
    want = ladder.ladder_conv9view_bias_relu_plain(xin, w9, b)
    conv = hopper_conv.conv3x3x3_bias_relu_plain(xin, w, b)
    torch.cuda.synchronize()
    assert ladder.ladder_conv9view_bias_relu.launches == n0 + 1
    for ref in (want, conv):
        bound = 1e-5 * float(ref.abs().max()) + 1e-6
        assert float((got - ref).abs().max()) <= bound


def test_conv9view_packs_the_weights_once(dev, monkeypatch):
    """A second call with the same w9 reuses its packed stages: no packing,
    the same result, one launch per call."""
    g = torch.Generator().manual_seed(3)
    xin = torch.rand((2, 9, 20, 32), generator=g).to(dev)
    w = (torch.randn((3, 3, 3, 32, 32), generator=g) / 30.0).to(dev)
    b = torch.zeros((32,), device=dev)
    w9 = ladder.pack_w9(w)
    packs = []
    real = ladder.pack_w9_tc
    monkeypatch.setattr(ladder, "pack_w9_tc",
                        lambda v: packs.append(1) or real(v))
    n0 = ladder.ladder_conv9view_bias_relu.launches
    first = ladder.ladder_conv9view_bias_relu(xin, w9, b)
    second = ladder.ladder_conv9view_bias_relu(xin, w9, b)
    torch.cuda.synchronize()
    assert len(packs) == 1
    assert ladder.ladder_conv9view_bias_relu.launches == n0 + 2
    assert torch.equal(first, second)


def test_ladder_kernels_raise_without_fallback(dev):
    """What the TMA kernels cannot take raises on the card and launches
    nothing: a misaligned tensor, a channel product wider than the
    kernel's shared memory holds."""
    flat = torch.zeros(3 * 8 * 8 * 32 + 1, device=dev)
    shifted = flat[1:].view(3, 8, 8, 32)     # 4 bytes off a 16-byte line
    w = torch.zeros((3, 3, 3, 32, 16), device=dev)
    n0 = [k.launches for k in ladder.KERNELS]
    with pytest.raises(ValueError):
        ladder.ladder_conv9view_bias_relu(shifted, ladder.pack_w9(w),
                                          torch.zeros((16,), device=dev))
    with pytest.raises(ValueError):
        ladder.ladder_pointwise_matmul(shifted, torch.zeros((32, 8),
                                                            device=dev))
    with pytest.raises(ValueError):
        ladder.ladder_pointwise_matmul(torch.zeros((4, 65), device=dev),
                                       torch.zeros((65, 8), device=dev))
    assert [k.launches for k in ladder.KERNELS] == n0


# ---- the ensemble's batched EM, and two threads on the card --------------

EM_TOL = 1e-2      # real units: the f32 EM's noise (test_torch_tracking.py)


def _members(n_members=5, pad=32, seed=2):
    """Members predicting volume n + 1 of a drifting 12-cell scene from
    volumes 1..n: (confirmed (E, 12, 3), seg1 (E, pad, 3), mask1, seg2,
    mask2), real units."""
    from t3dct_torch.utils.synthetic import drifting_centers
    vs = np.float32([1.0, 1.13, 4.7])
    centers = drifting_centers(np.random.RandomState(seed), n_members + 1,
                               12, (8, 64, 48))

    def real(t, s):
        c = centers[t][:, [1, 2, 0]] + np.random.RandomState(s).uniform(
            -0.5, 0.5, (12, 3))
        return (c * vs).astype(np.float32)

    def padded(t):
        out = np.full((pad, 3), 1e6, np.float32)
        out[:12] = real(t, t)
        mask = np.zeros(pad, bool)
        mask[:12] = True
        return out, mask

    ts = range(1, n_members + 1)
    seg2, mask2 = padded(n_members + 1)
    return (np.stack([real(t, 100 + t) for t in ts]),
            np.stack([padded(t)[0] for t in ts]),
            np.stack([padded(t)[1] for t in ts]), seg2, mask2)


@pytest.mark.parametrize("frozen", [False, True])
def test_batched_em_on_the_card_matches_its_solo_run(dev, frozen):
    """Every member of the batched ``track_step`` on the card against the
    same member run alone on the card, and against the CPU: within the f32
    EM's noise, with the solo iteration count give or take the card's
    other summation order.  ``frozen``: one member starts at the target's
    own cells and stops early while the others iterate."""
    from t3dct_torch.engine.tracker import track_step
    from t3dct_torch.models.ffn import feature_distance_ffn
    params, state = feature_distance_ffn(torch.Generator().manual_seed(1),
                                         "cpu")
    conf, seg1, mask1, seg2, mask2 = _members()
    if frozen:
        seg1[1], mask1[1] = seg2, mask2
    host = [torch.from_numpy(a) for a in (conf, seg1, mask1, seg2, mask2)]
    card = [a.to(dev) for a in host]
    pc = {k: {n: w.to(dev) for n, w in v.items()} for k, v in params.items()}
    sc = {k: {n: w.to(dev) for n, w in v.items()} for k, v in state.items()}
    res = track_step(pc, sc, *card)
    cpu = track_step(params, state, *host)
    its = res.n_iterations.tolist()
    for e in range(len(conf)):
        solo = track_step(pc, sc, card[0][e], card[1][e], card[2][e],
                          card[3], card[4])
        got = res.tracked[e].cpu()
        assert float((got - solo.tracked.cpu()).abs().max()) <= EM_TOL
        assert float((got - cpu.tracked[e]).abs().max()) <= EM_TOL
        assert abs(its[e] - int(solo.n_iterations)) <= 1
    if frozen:
        assert min(its) < max(its)


def test_two_threads_count_every_flood(dev):
    """Two threads, each on its own stream, launch the cooperative flood
    at once: every call is bit-equal to the plain version, nothing hangs,
    and the shared counters hold every launch and round."""
    import threading
    args = [t.to(dev) for t in _flood_scene("uneven")]
    want, _ = hopper_flood.flood_slices_plain(*args)
    _, solo_rounds = hopper_flood.flood_slices(*args)
    n0 = hopper_flood.flood_slices.launches
    r0 = hopper_flood.flood_slices.rounds
    errors, per_thread = [], 20

    def run():
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                for _ in range(per_thread):
                    got, rounds = hopper_flood.flood_slices(*args)
                    assert torch.equal(got, want) and rounds == solo_rounds
        except Exception as e:          # reported on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert hopper_flood.flood_slices.launches == n0 + 2 * per_thread
    assert hopper_flood.flood_slices.rounds == r0 + 2 * per_thread * \
        solo_rounds


# ---- the conv's gradient (training) -----------------------------------------

def _grad_rel(got, want):
    """Relative error in the norm."""
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize("shape,relu", [
    ((2, 6, 20, 18, 32, 64), True), ((2, 6, 20, 18, 96, 32), True),
    ((1, 4, 12, 10, 1, 32), True), ((2, 5, 9, 11, 12, 8), False),
    ((2, 3, 8, 8, 64, 128), True)])
def test_conv_function_gradients_match_plain(dev, shape, relu):
    """The autograd Function on the card: a result with a ``grad_fn``,
    dX on the kernels (the launch counters rise in the backward; none for
    the c_in = 1 stem, whose input needs no gradient), and dX, dW, db
    within 1e-4 of autograd through the plain version under the same ReLU
    mask, in the norm."""
    b_, z, y, x, ci, co = shape
    g = torch.Generator().manual_seed(ci + co)
    xin = torch.randn((b_, z, y, x, ci), generator=g).to(dev)
    w = (torch.randn((3, 3, 3, ci, co), generator=g)
         / (27 * ci) ** 0.5).to(dev)
    b = torch.randn((co,), generator=g).to(dev)
    go = torch.randn((b_, z, y, x, co), generator=g).to(dev)
    needs_x = ci > 1
    leaves = [xin.clone().requires_grad_(needs_x),
              w.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    from t3dct_torch.models import layers as L
    y_ = L.conv3d({"w": leaves[1], "b": leaves[2]}, leaves[0], relu=relu)
    assert y_.grad_fn is not None
    n0 = _counts()
    grads = torch.autograd.grad(y_, [t for t in leaves if t.requires_grad],
                                go)
    torch.cuda.synchronize()
    n1 = _counts()
    assert sum(n1) - sum(n0) == (1 if needs_x else 0)
    ref = [t.clone().requires_grad_(t.requires_grad) for t in leaves]
    yr = hopper_conv.conv3x3x3_bias_relu_plain(*ref, relu=False)
    _held(y_.detach(), torch.relu(yr.detach()) if relu else yr.detach())
    # under the Function's own ReLU mask: where y is a few ulp from 0 the
    # kernel's and cuDNN's sums may fall on either side of it
    if relu:
        yr = yr * (y_ > 0).detach()
    want = torch.autograd.grad(yr, [t for t in ref if t.requires_grad], go)
    for a, r in zip(grads, want):
        assert _grad_rel(a, r) <= 1e-4


def test_conv_weight_update_is_not_stale(dev):
    """Two training steps: the second forward packs the updated weights
    (the Adam update bumps ``w._version``, the pack cache's key) and
    equals the plain conv of the new weights, not of the old."""
    from t3dct_torch.models import layers as L
    from t3dct_torch.utils.optim import Adam
    g = torch.Generator().manual_seed(7)
    xin = torch.randn((1, 4, 16, 16, 32), generator=g).to(dev)
    w = (torch.randn((3, 3, 3, 32, 32), generator=g) / 30).to(dev)
    w.requires_grad_(True)
    b = torch.zeros(32, device=dev, requires_grad=True)
    adam = Adam([w, b], 1e-1)
    for step in range(2):
        w_now = w.detach().clone()
        y_ = L.conv3d({"w": w, "b": b}, xin, relu=False)
        want = hopper_conv.conv3x3x3_bias_relu_plain(
            xin, w_now, b.detach(), relu=False)
        torch.cuda.synchronize()
        _held(y_.detach(), want)
        if step:
            assert float((y_.detach() - first).abs().max()) > 1e-3
        first = y_.detach().clone()
        adam.step(torch.autograd.grad(y_.square().sum(), [w, b]))


def test_conv_backward_packs_the_flipped_weights_uncached(dev,
                                                          monkeypatch):
    """The backward's flipped weights, fresh each step, are packed without
    a cache entry: the cache holds the forward's weights only.  dW refuses
    to run with cuDNN's TF32 on."""
    from t3dct_torch.models import layers as L
    monkeypatch.setattr(hopper_conv, "_packed", {})
    g = torch.Generator().manual_seed(8)
    xin = torch.randn((1, 4, 16, 16, 32), generator=g).to(dev)
    xin.requires_grad_(True)
    w = (torch.randn((3, 3, 3, 32, 64), generator=g) / 30).to(dev)
    w.requires_grad_(True)
    b = torch.zeros(64, device=dev, requires_grad=True)
    y_ = L.conv3d({"w": w, "b": b}, xin, relu=True)
    torch.autograd.grad(y_.sum(), [xin, w, b])
    assert [k[0] for k in hopper_conv._packed] == [id(w)]
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        hopper_conv.conv3x3x3_weight_grad(xin.detach(), y_.detach())


def test_reference_paste_on_the_card_equals_cpu(dev):
    """The legacy ``paste_mode="reference"`` paste (id-order last write
    wins, cells leaving the canvas dropped) on the card: exactly the
    CPU's, for movements that overlap cells and push one off the
    canvas."""
    from t3dct_torch.ops.subregions import (build_subregion_atlas,
                                            move_cells_sampled)
    lab = np.zeros((40, 36, 6), np.int32)
    for i, (x, y) in enumerate([(8, 8), (14, 10), (30, 20), (20, 28)]):
        lab[x - 4:x + 4, y - 4:y + 4, 1:5] = i + 1
    atlas = build_subregion_atlas(torch.from_numpy(lab), 4, (9, 9, 5),
                                  interpolation_factor=3)
    card = type(atlas)(atlas.boxes.to(dev), atlas.origins.to(dev),
                       atlas.valid.to(dev), atlas.interpolation_factor,
                       atlas.image_shape)
    mv = torch.tensor([[3, 1, 0], [-2, 0, 2], [-40, 0, 0], [0, -6, 1]],
                      dtype=torch.int32)
    for kw in (dict(overlap_mode="last", out_of_range="drop"), {}):
        want = move_cells_sampled(atlas, mv, **kw)
        got = move_cells_sampled(card, mv.to(dev), **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_legacy_members_on_the_card_match_solo_and_cpu(dev):
    """The legacy ensemble's batched fit (``legacy_fit_members``, three
    members padded to the point sets' static size) on the card: each
    member within the f32 EM's noise of its solo fit on the card and of
    the CPU's batched fit."""
    from t3dct_torch.engine.legacy import (legacy_fit_and_predict,
                                           legacy_fit_members)
    from t3dct_torch.models.ffn import feature_distance_ffn
    params, state = feature_distance_ffn(torch.Generator().manual_seed(1),
                                         "cpu")
    rng = np.random.RandomState(0)
    pad, n, m = 40, 24, 26
    base = rng.uniform(0, 60, (n, 3)).astype(np.float32)
    tgt = np.full((pad, 3), 1e6, np.float32)
    tgt[:m] = np.concatenate([base + [1.0, -0.5, 0.3],
                              rng.uniform(0, 60, (m - n, 3))])
    inter = np.full((3, pad, 3), 1e6, np.float32)
    for e in range(3):
        inter[e, :n] = base + rng.randn(n, 3) * 0.3
    masks = np.zeros((3, pad), bool)
    masks[:, :n] = True
    tracked = np.stack([base * 1.01] * 3)
    host = [torch.from_numpy(a) for a in (inter, masks, tgt,
                                          np.arange(pad) < m, tracked)]
    card = [a.to(dev) for a in host]
    pc = {k: {s: w.to(dev) for s, w in v.items()} for k, v in params.items()}
    sc = {k: {s: w.to(dev) for s, w in v.items()} for k, v in state.items()}
    got = legacy_fit_members(pc, sc, card[0], card[1], card[2], card[3],
                             card[4], 40.0, 0.1, max_iteration=8)
    want = legacy_fit_members(params, state, *host[:4], host[4], 40.0, 0.1,
                              max_iteration=8)
    assert float((got.cpu() - want).abs().max()) <= EM_TOL
    for e in range(3):
        solo, _, _ = legacy_fit_and_predict(pc, sc, card[0][e], card[1][e],
                                            card[2], card[3], card[4][e],
                                            40.0, 0.1, max_iteration=8)
        assert float((got[e] - solo).abs().max()) <= EM_TOL


def test_unet_train_step_on_the_card_matches_cpu(dev, tmp_path):
    """One ``TrainingUNet3D`` step of a small variant-a spec on one
    augmented batch, on the card and on the CPU: the loss within 1e-4 and
    the parameters within 1e-4 in the norm (a first Adam step moves a
    weight by the sign of its gradient)."""
    from t3dct_torch.models import train_unet as tu
    from t3dct_torch.models.unet3d import UNet3D
    from t3dct_torch.utils.checkpoint import leaves_with_paths
    spec = UNet3D(variant="a", tile_shape=(24, 24, 8), pool=(2, 2, 1),
                  down_filters=((8, 8), (8, 16)), up_filters=((16, 16),
                                                              (8, 8)),
                  head_filters=(8,))
    img = np.random.RandomState(0).rand(48, 48, 8).astype(np.float32) * 300
    lab = (img > 200).astype(np.int32)
    out = {}
    for d in (dev, torch.device("cpu")):
        tr = tu.TrainingUNet3D(20.0, tmp_path / d.type, spec, batch_size=4,
                               device=d)
        tr.start_from(*spec.init(torch.Generator().manual_seed(3),
                                 device="cpu"))
        tr.load_dataset_arrays(img, lab, img, lab)
        tr.preprocess()
        tr._gen.manual_seed(7)
        loss = tr.train_step(*tr._train_batch(np.random.RandomState(2)))
        out[d.type] = float(loss), [v.detach().cpu() for _, v in
                                    leaves_with_paths(tr.params)]
    (lc, pc), (lh, ph) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    diff = sum(float(((a - b) ** 2).sum()) for a, b in zip(pc, ph))
    norm = sum(float((b ** 2).sum()) for b in ph)
    assert diff ** 0.5 <= 1e-4 * norm ** 0.5
