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
    assert _counts() == [n0[0] + 1, n0[1]]
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
    assert _counts() == [n0[0] + 1, n0[1]]
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
    assert _counts() == [n0[0], n0[1] + 1]
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
    assert _counts() == [n0[0], n0[1] + 1]
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
