"""The tensor-core conv's host side (``ops.hopper_conv``), on the CPU.

``csrc/conv3x3x3_wgmma.cu`` runs only on the card (``tests/
test_torch_cuda.py``); what surrounds it is checked here: the hi/lo weight
packing, the TF32 rounding, the routing rule and the tensor map's
arguments.  ``emulate`` repeats the kernel's arithmetic in plain PyTorch:
its stages and taps, the activations' hi/lo split, the packed weights read
through the core-matrix layout, and the per-stage partial sums.  The three
passes hold the JAX package's f32 ``models/layers.py::conv3d`` within the
card's parity budget; one pass does not, which is why the kernel makes
three."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch  # noqa: F401
from t3dct.models import layers as JL
from t3dct_torch.config import StarDistConfig
from t3dct_torch.models.stardist3d import StarDist3DNet
from t3dct_torch.models.unet3d import unet3_a
from t3dct_torch.ops import hopper_conv as hc

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# the card's parity budget (chip_smoke.CONV_RTOL / CONV_ATOL)
RTOL, ATOL = 1e-5, 1e-6
# backbone (32->32, 96->32, 32->128) and U-Net a (8->16, 32->8) widths
WIDTHS = [(32, 32), (96, 32), (32, 128), (8, 16), (32, 8)]
SHAPE = (3, 10, 12)


def _case(c_in, c_out, seed=0):
    """Input as the layers see it (ReLU'd), glorot-scale weights, a bias."""
    rng = np.random.RandomState(seed + c_in + 7 * c_out)
    x = np.maximum(rng.randn(*SHAPE, c_in), 0).astype(np.float32)
    lim = np.sqrt(6.0 / (27 * c_in + 27 * c_out))
    w = rng.uniform(-lim, lim, (3, 3, 3, c_in, c_out)).astype(np.float32)
    b = (rng.randn(c_out) * 0.1).astype(np.float32)
    return x, w, b


def tf32_truncate(t):
    """The TF32 value the tensor cores read from an f32 operand: the low 13
    mantissa bits dropped."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def unpack_weights_tc(packed, c_in, c_out):
    """The inverse of ``hc.pack_weights_tc``: DHWIO ``(hi, lo)``."""
    n_chunks, nb = packed.shape[0], packed.shape[-1] // hc.CK
    p = packed.reshape(n_chunks, c_in // hc.CK, 3, 3, 3, 2, nb // 8, 2, 8, 4)
    p = p.permute(2, 3, 4, 5, 1, 7, 9, 0, 6, 8).reshape(
        3, 3, 3, 2, c_in // hc.CK, hc.CK, n_chunks * nb)
    inv = sorted(range(hc.CK), key=hc.K_ORDER.__getitem__)
    p = p[:, :, :, :, :, inv].reshape(3, 3, 3, 2, c_in, n_chunks * nb)
    return p[:, :, :, 0, :, :c_out], p[:, :, :, 1, :, :c_out]


def _b_matrix(flat, nb):
    """The (8 k, nb n) matrix a wgmma B descriptor reads from ``flat``."""
    k = torch.arange(8)[:, None]
    n = torch.arange(nb)[None, :]
    return flat[((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4]


def emulate(x, w, b, passes=3):
    """The kernel's arithmetic on one (z, y, x, c_in) volume, in f32: stage
    (chunk, dz), tap (dy, dx), column k = channel ``K_ORDER[k]`` of the
    chunk; A split with ``tf32_round``, B's lo read as the tensor cores
    read an f32 operand (``tf32_truncate``); each stage's partial sum added
    to the total, then the bias."""
    z, y, xl, c_in = x.shape
    c_out = w.shape[4]
    packed, nb = hc.pack_weights_tc(w)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    order = list(hc.K_ORDER)
    out = []
    for nc in range(packed.shape[0]):
        total = torch.zeros((z * y * xl, nb))
        for s in range(packed.shape[1]):
            chunk, dz = divmod(s, 3)
            part = torch.zeros_like(total)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                a = xp[dz:dz + z, dy:dy + y, dx:dx + xl,
                       hc.CK * chunk:hc.CK * (chunk + 1)][..., order]
                a = a.reshape(-1, hc.CK)
                a_hi = hc.tf32_round(a)
                a_lo = hc.tf32_round(a - a_hi)
                b_hi = _b_matrix(packed[nc, s, tap, 0], nb)
                b_lo = tf32_truncate(_b_matrix(packed[nc, s, tap, 1], nb))
                if passes == 3:
                    part += a_lo @ b_hi + a_hi @ b_lo
                part += a_hi @ b_hi
            total += part
        out.append(total)
    res = torch.cat(out, dim=1)[:, :c_out].reshape(z, y, xl, c_out)
    return res + b


def _jax_conv(x, w, b):
    return np.asarray(JL.conv3d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                jnp.asarray(x)[None]))[0]


def _budget(ref):
    return RTOL * float(np.abs(ref).max()) + ATOL


@pytest.mark.parametrize("c_in,c_out", WIDTHS + [(8, 136), (16, 24)])
def test_packed_weights_round_trip(c_in, c_out):
    """hi + lo == w exactly, hi is TF32, and unpacking gives DHWIO back;
    c_out past one 128-channel tile and c_out not a tile width pad with
    zeros."""
    _, w, _ = _case(c_in, c_out)
    tw = torch.from_numpy(w)
    packed, nb = hc.pack_weights_tc(tw)
    n_chunks = -(-c_out // nb)
    assert nb == hc.n_tile(c_out) and nb in hc.N_TILES
    assert packed.shape == (n_chunks, 3 * c_in // 8, 9, 2, 8 * nb)
    assert packed.is_contiguous()
    hi, lo = unpack_weights_tc(packed, c_in, c_out)
    assert torch.equal(hi + lo, tw)
    assert torch.equal(hi, hc.tf32_round(tw))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert float(packed.abs().sum()) == pytest.approx(
        float(hi.abs().sum() + lo.abs().sum()), rel=1e-5)


def test_packed_layout_is_the_core_matrix_layout():
    """Element (k, n) of tap (dz, dy, dx), chunk c and N tile nc lies at
    ``((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4``, holding channel
    ``8 c + K_ORDER[k]``."""
    _, w, _ = _case(16, 136)
    tw = torch.from_numpy(w)
    packed, nb = hc.pack_weights_tc(tw)
    hi, lo = hc.split_tf32(tw)
    rng = np.random.RandomState(0)
    for _ in range(200):
        nc, c, dz, dy, dx, part, k = (rng.randint(m) for m in
                                      (2, 2, 3, 3, 3, 2, 8))
        n = rng.randint(nb)
        co = nc * nb + n
        want = 0.0 if co >= 136 else float(
            (hi, lo)[part][dz, dy, dx, 8 * c + hc.K_ORDER[k], co])
        got = packed[nc, 3 * c + dz, 3 * dy + dx, part,
                     ((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4]
        assert float(got) == want


def test_tf32_rounding_modes():
    """Ties round away from zero (``cvt.rna``); truncation drops the bits."""
    ulp = 2.0 ** -10               # TF32's ulp at 1.0
    v = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + ulp / 4,
                      -(1 + ulp / 2), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, 1.0, 1.0, -(1 + ulp), 3.0, 0.0])
    assert torch.equal(hc.tf32_round(v), want)
    assert torch.equal(tf32_truncate(v),
                       torch.tensor([1.0, 1.0, 1.0, -1.0, 3.0, 0.0]))
    x = torch.from_numpy(np.random.RandomState(1).randn(1000).astype(
        np.float32))
    hi, lo = hc.split_tf32(x)
    assert torch.equal(hi + lo, x)
    assert float((lo / x).abs().max()) <= 2.0 ** -11


@pytest.mark.parametrize("c_in,c_out", WIDTHS)
def test_three_pass_emulation_matches_jax_conv(c_in, c_out):
    x, w, b = _case(c_in, c_out)
    ref = _jax_conv(x, w, b)
    got = emulate(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(b)).numpy()
    assert np.abs(got - ref).max() <= _budget(ref)


@pytest.mark.parametrize("c_in,c_out", WIDTHS)
def test_one_pass_emulation_misses_the_budget(c_in, c_out):
    """A single TF32 product keeps ~11 bits: over budget at every width."""
    x, w, b = _case(c_in, c_out)
    ref = _jax_conv(x, w, b)
    got = emulate(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(b), passes=1).numpy()
    assert np.abs(got - ref).max() > 3 * _budget(ref)


@pytest.mark.parametrize("shape", [(2, 3, 10, 12, 8), (1, 5, 17, 19, 32)])
def test_emulation_matches_plain_batched(shape):
    """The plain version (what CPU tensors run) and the emulation agree
    per volume of a batch."""
    x, w, b = (torch.from_numpy(a) for a in _case(shape[-1], 16))
    xb = torch.from_numpy(np.random.RandomState(3).rand(*shape).astype(
        np.float32))
    plain = hc.conv3x3x3_bias_relu_plain(xb, w, b, relu=False)
    for i in range(shape[0]):
        ref = plain[i].numpy()
        assert np.abs(emulate(xb[i], w, b).numpy() - ref).max() <= \
            _budget(ref)


def _conv_weights(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _conv_weights(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _conv_weights(v)
    elif isinstance(tree, torch.Tensor) and tree.dim() == 5 and \
            tuple(tree.shape[:3]) == (3, 3, 3):
        yield tuple(tree.shape[3:])


def test_routing_of_the_models_layers():
    """Every 3x3x3 layer of the bench backbone and of U-Net a takes the
    tensor-core kernel, except the c_in = 1 stems, which take the direct
    one: from chip_smoke.py's layer tables and from the models' weights."""
    table = [(ci, co) for _, _, _, ci, co, _ in chip_smoke.CONV_LAYERS]
    table += [(ci, co) for (_, _, _, ci, co)
              in chip_smoke.unet_conv_layers(unet3_a())]
    cfg = StarDistConfig(n_rays=96, grid=chip_smoke.GRID,
                         anisotropy=(9.2, 1.0, 1.0), unet_n_filter_base=32,
                         net_conv_after_unet=128)
    gen = torch.Generator().manual_seed(0)
    backbone = list(_conv_weights(StarDist3DNet(cfg).init(gen, "cpu")))
    unet = list(_conv_weights(unet3_a().init(gen, device="cpu")[0]))
    assert sorted(set(backbone)) == sorted(
        {(ci, co) for _, _, _, ci, co, _ in chip_smoke.CONV_LAYERS})
    assert len(unet) == sum(chip_smoke.unet_conv_layers(unet3_a()).values())
    for ci, co in table + backbone + unet:
        want = "direct" if ci == 1 else "wgmma"
        assert hc.route(ci, co) == want, (ci, co)
    assert sum(ci == 1 for ci, _ in backbone) == 1
    assert sum(ci == 1 for ci, _ in unet) == 1


@pytest.mark.parametrize("c_out", [1, 3, 8, 16, 32, 40, 64])
def test_stems_route_to_the_direct_kernel(c_out):
    """c_in = 1 is off the tensor-core rule at every c_out; the direct
    kernel's output tile is the narrowest of 8 / 16 / 32 that holds c_out,
    and 32 (several tiles) above that."""
    assert hc.route(1, c_out) == "direct"
    tile = hc.direct_tile(c_out)
    holding = [t for t in hc.DIRECT_TILES if t >= c_out]
    assert tile == (min(holding) if holding else 32)


@pytest.mark.parametrize("shape,c_out", [
    ((1, 24, 204, 84), 32), ((16, 160, 160, 16), 8), ((5, 3, 17, 19), 40),
    ((1, 1, 9, 7), 1), ((2, 40, 300, 500), 16)])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_direct_plan_covers_every_output_once(shape, c_out, n_sm):
    """The grid the direct kernel is given, against a brute-force walk of
    its blocks decoded as the kernel decodes them: every (batch, z, y
    tile, x tile, channel) is written by exactly one block, and the z
    segments are cut only as far as the fill target asks."""
    b, z, y, x = shape
    tile, tx, zs, blocks = hc.direct_plan(shape, c_out, n_sm)
    assert tx == (16 if x <= 16 else 32)
    ntx, nty = -(-x // tx), -(-y // hc.direct_rows(tile, tx))
    assert hc.direct_rows(tile, tx) * tx * tile == 256 * 8 * 4
    nzs, nco = -(-z // zs), -(-c_out // tile)
    assert blocks == b * nco * nzs * nty * ntx
    hits = np.zeros((b, z, nty, ntx, nco * tile), np.int32)
    for blk in range(blocks):
        tx, blk = blk % ntx, blk // ntx
        ty, blk = blk % nty, blk // nty
        zseg, blk = blk % nzs, blk // nzs
        co, bi = blk % nco, blk // nco
        hits[bi, zseg * zs:min(zseg * zs + zs, z), ty, tx,
             co * tile:co * tile + tile] += 1
    assert (hits == 1).all()
    base = blocks // nzs
    fill = hc.DIRECT_FILL * n_sm
    # the fewest segments of equal length that fill the card (single
    # planes if none do)
    counts = {-(-z // n) for n in range(1, z + 1)}
    assert nzs == min([c for c in counts if base * c >= fill] or [z])
    assert zs == -(-z // nzs)


@pytest.mark.parametrize("shape", [(1, 24, 204, 84, 32), (16, 160, 160, 16, 8),
                                   (2, 3, 5, 7, 96)])
def test_tma_halo_args(shape):
    """dims innermost first with z and b apart, 16-byte strides (TMA's
    rule, which c_in % 8 == 0 meets), and one stage's halo box."""
    b, z, y, x, c = shape
    dims, strides, box = hc.tma_halo_args(shape)
    assert dims == (c, x, y, z, b)
    t = torch.empty(shape)
    assert strides == tuple(4 * s for s in t.stride()[::-1][1:])
    assert all(s % 16 == 0 for s in strides)
    assert box == (8, hc.TX + 2, hc.TY + 2, 1, 1)
    assert 4 * box[0] % 16 == 0 and max(box) <= 256


def test_wgmma_wrapper_refuses_widths_off_the_rule():
    """On a CUDA tensor the wgmma wrapper raises for widths it cannot take;
    the router sends them to the direct kernel instead (on the CPU both run
    the plain version)."""
    x = torch.zeros((2, 4, 4, 3))
    w = torch.zeros((3, 3, 3, 3, 8))
    b = torch.zeros((8,))
    with pytest.raises(ValueError):
        hc._launch_wgmma(x, w, b, True)
    assert torch.equal(hc.conv3x3x3_wgmma(x, w, b), hc.conv3x3x3_direct(
        x, w, b))


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__37968208_18_conv3x3x3_wgmma_cu_8fe3d87b17conv_wgmma_kernelILi128EEEv14CUtensorMap_stPKfS3_Pfiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__37968208_18_conv3x3x3_wgmma_cu_8fe3d87b17conv_wgmma_kernelILi128EEEv14CUtensorMap_stPKfS3_Pfiiiiiiii
    216 bytes stack frame, 364 bytes spill stores, 516 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 216 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z11flood_roundPKfPKiPi' for 'sm_90a'
ptxas info    : Function properties for _Z11flood_roundPKfPKiPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 4096 bytes smem
ptxas info    : Compiling entry function 'cc_flatten' for 'sm_90a'
ptxas info    : Used 12 registers
"""


def test_parse_ptxas_report():
    """chip_smoke.py prints each kernel's registers, spills and static
    shared memory from the ``-Xptxas -v`` report the build keeps."""
    from t3dct_torch.utils import cuda_build
    assert cuda_build.parse_ptxas(PTXAS) == [
        ("conv_wgmma_kernel<128>", 168, 364, 516, 0),
        ("flood_round", 32, 0, 0, 4096), ("cc_flatten", 12, 0, 0, 0)]
    assert "-v" in cuda_build.NVCC_FLAGS


def test_packed_weights_are_cached_per_tensor():
    w = torch.from_numpy(_case(8, 16)[1])
    p1, _ = hc.packed_weights(w)
    assert hc.packed_weights(w)[0] is p1
    w.mul_(2.0)     # an in-place change repacks
    p2, _ = hc.packed_weights(w)
    assert p2 is not p1
    assert torch.equal(sum(unpack_weights_tc(p2, 8, 16)), w)
