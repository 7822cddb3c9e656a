"""3x3x3 conv + bias (+ReLU): the router, its CUDA kernels' wrappers and
the plain version, in float32 or the JAX package's bfloat16 compute
dtype, and the legacy U-Net's bf16 block (conv, activation, BatchNorm).

``conv3x3x3_bias_relu`` replaces ``3deecelltracker_tpu/ops/pallas_conv.py::
conv3x3x3_fused`` (same contract: a channels-last ``(z, y, x, c_in)`` f32
volume, DHWIO weights, f32 accumulation), and also takes a batch
``(b, z, y, x, c_in)`` of volumes in one launch.  On a CUDA tensor it
launches exactly one of two hand-written kernels, chosen by :func:`route`:

- ``csrc/conv3x3x3_wgmma.cu`` (:func:`conv3x3x3_wgmma`) for ``c_in % 8 == 0``
  and ``c_out % 8 == 0``: an implicit GEMM on the tensor cores in three TF32
  passes, which keeps f32 accuracy (design and bound: the note at the top of
  that file).  Its weights are split into TF32 hi/lo halves and packed here
  (:func:`pack_weights_tc`), once per weight tensor; its 5-D tensor map is
  described here (:func:`tma_halo_args`) and made in the ``.cu``;
- ``csrc/conv3x3x3.cu`` (:func:`conv3x3x3_direct`) otherwise, i.e. the
  ``c_in = 1`` stems, whose 4-byte channel stride TMA cannot take: a direct
  convolution on the f32 CUDA cores, built for a layer bound by its bytes
  (exact widths, a z-march over a ring of halo planes, coalesced
  channels-last stores).  Its output tile and z-segments are planned here
  (:func:`direct_plan`).

``compute_dtype=torch.bfloat16`` is the JAX package's ``layers.conv3d(...,
compute_dtype=jnp.bfloat16)`` (XLA's conv of the bf16-rounded input and
weights, f32 products and sums, the f32 bias after), f32 out: widths that
are multiples of 8 take the bf16 tensor-core kernel
(``csrc/conv3x3x3_wgmma_bf16.cu``, :func:`conv3x3x3_wgmma_bf16`; the input
rounded to bf16 here, once, the weights rounded and packed by
:func:`pack_weights_bf16`), the c_in = 1 stems the bf16 stem kernel
(``csrc/conv3x3x3_bf16.cu``, :func:`conv3x3x3_direct_bf16`, operands
rounded on load).  Both kernels also compute the legacy U-Net's block in
one launch, :func:`conv3x3x3_block_bf16`: ``bf16_rne(BN(act(conv(x,
bf16(w)) + b)))`` with BatchNorm's eval parameters, bf16 in and out, which
is what JAX's next layer reads (it rounds its input to bf16 again).

On a CPU tensor every entry point runs its plain version
(:func:`conv3x3x3_bias_relu_plain`, :func:`conv3x3x3_block_bf16_plain`).
There is no fallback between them.

:class:`Conv3x3x3BiasReLU` is the router as an autograd function, for
training (the JAX package differentiates its conv in XLA), in float32; a
bfloat16 forward has no gradient (``ROADMAP.md`` A.4).  Its input
gradient is a SAME conv of the output gradient with the weights flipped on
their three spatial axes and ``c_in``/``c_out`` swapped, so it runs on the
same two kernels; the weight gradient is PyTorch's ``conv3d_weight`` with
TF32 off (the JAX package computes that product in XLA too, outside any
Pallas kernel).
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import cuda_build

# Both kernels index x, w and y with 64-bit offsets, so no batch that fits
# the card's memory overflows them; their limits are the grid's: the
# tensor-core kernel takes at most GRID_Z_MAX z-planes (raises) and
# GRID_Z_MAX volumes x N tiles a launch (split below), the direct kernel
# at most 2^31 - 1 blocks (its .cu refuses more, and the wrapper raises)
GRID_Z_MAX = 65535    # CUDA's limit on gridDim.y and gridDim.z
# csrc/conv3x3x3.cu: its output tiles (channels), the widths of its pixel
# tile, and the blocks per SM its grid aims for (two resident, two waves)
DIRECT_TILES = (8, 16, 32)
DIRECT_TX = (16, 32)
DIRECT_FILL = 4
# csrc/conv3x3x3_wgmma.cu: channels per K step (wgmma tf32 k8), its N tiles,
# and its 16 (x) by 8 (y) output tile
CK = 8
N_TILES = (8, 16, 32, 64, 128)
TX, TY = 16, 8
# column k of a K step holds channel K_ORDER[k] of the 8-channel chunk, so a
# thread's two channels of one pixel (columns t and t + 4) are one float2
K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
# csrc/conv3x3x3_wgmma_bf16.cu: its K step (wgmma bf16 k16), a stage's chunk
# of 16 channels (the 8 x 8 pixel tiles a warpgroup takes per N tile, MT,
# come from its plan, :func:`wgmma_bf16_plan`)
CK_BF16 = 16
# csrc/conv3x3x3_bf16.cu: the stem kernel's threads, 256 of a column run of
# STEM_RUN pixels x STEM_GROUP channels, and the widths of its pixel tile
STEM_GROUP = 8
STEM_RUN = 4
STEM_TX = (8, 16, 32)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# the block's activations (the kernels' codes) and LeakyReLU's slope, the
# JAX package's layers.LEAKY_ALPHA
ACTIVATIONS = {None: 0, "relu": 1, "leaky_relu": 2}
LEAKY_ALPHA = 0.3
BF16_GRAD = ("the gradient of a bfloat16 conv is not ported (ROADMAP.md "
             "A.4: the bf16 conv's gradient); train in float32")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (ties to even), as f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def check_compute_dtype(compute_dtype) -> bool:
    """True for bfloat16, False for float32; raises for any other."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be torch.float32 or "
                        f"torch.bfloat16, got {compute_dtype}")
    return compute_dtype == torch.bfloat16


def conv3x3x3_bias_relu_plain(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, relu: bool = True,
                              compute_dtype=torch.float32) -> torch.Tensor:
    """``relu(conv_same(x, w) + b)`` with ``F.conv3d``: x (z, y, x, c_in)
    or (b, z, y, x, c_in), w (3, 3, 3, c_in, c_out), b (c_out,) -> the same
    leading shape with c_out channels.  The bias is added after the
    convolution, as ``layers.conv3d`` does in JAX.  ``compute_dtype=
    torch.bfloat16`` convolves ``round_bf16(x)`` with ``round_bf16(w)`` in
    f32 (on the card with TF32 off): each product is exact, so this is
    JAX's bf16 conv up to summation order."""
    if check_compute_dtype(compute_dtype):
        x, w = round_bf16(x), round_bf16(w)
    xin = x if x.dim() == 5 else x[None]
    wt = w.permute(4, 3, 0, 1, 2)
    out = F.conv3d(xin.permute(0, 4, 1, 2, 3), wt, padding=1
                   ).permute(0, 2, 3, 4, 1) + b
    out = out if x.dim() == 5 else out[0]
    return torch.relu(out) if relu else out


def activation(y: torch.Tensor, act) -> torch.Tensor:
    """``act`` of ``y``: None, ``"relu"`` or ``"leaky_relu"`` (``where(y >=
    0, y, LEAKY_ALPHA * y)``, as ``models.layers.leaky_relu``)."""
    if act not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {list(ACTIVATIONS)}, "
                         f"got {act!r}")
    if act == "relu":
        return torch.relu(y)
    if act == "leaky_relu":
        return torch.where(y >= 0, y, LEAKY_ALPHA * y)
    return y


def conv3x3x3_block_bf16_plain(x: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor, mean: torch.Tensor,
                               inv: torch.Tensor, beta: torch.Tensor,
                               act=None) -> torch.Tensor:
    """The legacy U-Net's bf16 block with PyTorch ops: the plain bf16 conv
    of ``x`` (bf16 or f32, rounded), ``act``, BatchNorm in eval mode as
    ``models.layers.batchnorm`` computes it (``(y - mean) * inv + beta``,
    ``inv = rsqrt(var + eps) * scale``), then ``.to(torch.bfloat16)``
    (round to nearest even); (.., c_out) bf16, contiguous."""
    y = conv3x3x3_bias_relu_plain(x.float(), w, b, False, torch.bfloat16)
    return ((activation(y, act) - mean) * inv + beta).to(
        torch.bfloat16).contiguous()


def route(c_in: int, c_out: int, compute_dtype=torch.float32) -> str:
    """Which kernel takes a layer on the card: the tensor-core kernel when
    both widths are multiples of 8 (TMA's 16-byte stride rule and the k8
    step), ``"wgmma"`` in float32 and ``"wgmma_bf16"`` in bfloat16; the
    direct kernel otherwise, ``"direct"`` / ``"direct_bf16"``."""
    kernel = "wgmma" if c_in % CK == 0 and c_out % CK == 0 else "direct"
    return kernel + "_bf16" if check_compute_dtype(compute_dtype) else kernel


def direct_tile(c_out: int) -> int:
    """The direct kernel's output tile for ``c_out`` channels: the
    narrowest of ``DIRECT_TILES`` that holds them, 32 above that (several
    tiles)."""
    return next((n for n in DIRECT_TILES if n >= c_out), DIRECT_TILES[-1])


def direct_tx(x: int) -> int:
    """The x width of the direct kernel's pixel tile for a volume ``x``
    wide: 16 up to 16 (U-Net a's stem sees its 16-deep tiles as x), else
    32."""
    return DIRECT_TX[0] if x <= DIRECT_TX[0] else DIRECT_TX[1]


def direct_rows(tile: int, tx: int) -> int:
    """The y rows of the direct kernel's pixel tile for output tile
    ``tile`` and width ``tx``: 256 threads of 8 pixels x 4 channels."""
    return 256 * 4 * 8 // (tile * tx)


def direct_plan(shape: Sequence[int], c_out: int, n_sm: int
                ) -> Tuple[int, int, int, int]:
    """``(tile, tx, zs, blocks)`` of the direct kernel on a (b, z, y, x,
    c_in) batch: its output tile (:func:`direct_tile`), its pixel tile's
    width (:func:`direct_tx`), the z-planes each block
    marches over, and the grid.  A block owns one (y, x) tile, one c_out
    tile and one z-segment.  Each segment reads two extra halo planes, so z
    is cut into the fewest segments of equal length that give
    ``DIRECT_FILL`` blocks per SM (into single planes if none do)."""
    b, z, y, x = (int(s) for s in shape[:4])
    tile, tx = direct_tile(c_out), direct_tx(x)
    base = b * -(-c_out // tile) * -(-y // direct_rows(tile, tx)) * \
        -(-x // tx)
    zs = z_segment(z, base, n_sm)
    return tile, tx, zs, base * -(-z // zs)


def z_segment(z: int, base: int, n_sm: int) -> int:
    """The z-planes a block of a z-marching kernel takes: z cut into the
    fewest segments of equal length that give ``DIRECT_FILL`` blocks per
    SM with ``base`` blocks a plane (single planes if none do)."""
    return next((-(-z // n) for n in range(1, z + 1)
                 if base * -(-z // -(-z // n)) >= DIRECT_FILL * n_sm), 1)


def stem_tile(y: int, x: int, c_out: int) -> Tuple[int, int, int]:
    """The bf16 stem kernel's tile on a (y, x) plane: ``(tile, tx, ty)``,
    its output tile (:func:`direct_tile`), the width of its pixel tile (of
    ``STEM_TX``, the one that pads the fewest pixels, then the widest) and
    the rows that gives (256 threads of ``STEM_RUN`` pixels x 8
    channels)."""
    tile = direct_tile(c_out)
    lanes = 256 * STEM_GROUP // tile

    def key(tx):
        ty = lanes * STEM_RUN // tx
        return (-(-y // ty) * ty * -(-x // tx) * tx, -tx)
    tx = min(STEM_TX, key=key)
    return tile, tx, lanes * STEM_RUN // tx


@functools.lru_cache(maxsize=256)
def stem_plan(shape: Sequence[int], c_out: int, n_sm: int
              ) -> Tuple[int, int, int, int]:
    """``(tile, tx, zs, blocks)`` of the bf16 stem kernel (``csrc/
    conv3x3x3_bf16.cu``) on a (b, z, y, x, 1) batch: :func:`stem_tile`, the
    z-planes each block marches over (:func:`z_segment`) and the grid."""
    b, z, y, x = (int(s) for s in shape[:4])
    tile, tx, ty = stem_tile(y, x, c_out)
    base = b * -(-c_out // tile) * -(-y // ty) * -(-x // tx)
    zs = z_segment(z, base, n_sm)
    return tile, tx, zs, base * -(-z // zs)


# ---- the tensor-core kernel's host side ------------------------------------

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (``cvt.rna.tf32.
    f32``): the low 13 mantissa bits rounded off."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32_round(t)`` and ``lo = t - hi``, so that
    ``hi + lo == t`` exactly in f32."""
    hi = tf32_round(t)
    return hi, t - hi


def n_tile(c_out: int) -> int:
    """The kernel's N tile for ``c_out`` channels: the narrowest of
    ``N_TILES`` that holds them, 128 above that (several tiles)."""
    return next((n for n in N_TILES if n >= c_out), N_TILES[-1])


def pack_weights_tc(w: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """DHWIO ``w`` (3, 3, 3, c_in, c_out) -> ``(packed, nb)``: the kernel's
    weights, ``packed[nc, 3 * chunk + dz, 3 * dy + dx, part]`` for N tile
    ``nc`` (``nb`` channels, zero past ``c_out``), 8-channel chunk ``chunk``
    and ``part`` 0 = hi, 1 = lo (:func:`split_tf32`), each an (8 k, nb n)
    matrix in wgmma's K-major no-swizzle core-matrix layout: element (k, n)
    at ``((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4``, with column k
    holding channel ``K_ORDER[k]`` of the chunk.  One pipeline stage of the
    kernel, ``packed[nc, s]``, is contiguous."""
    c_in, c_out = int(w.shape[3]), int(w.shape[4])
    nb = n_tile(c_out)
    n_chunks = -(-c_out // nb)
    hi, lo = split_tf32(F.pad(w, (0, nb * n_chunks - c_out)))
    p = torch.stack((hi, lo), dim=3)                    # dz dy dx part ci n
    p = p.reshape(3, 3, 3, 2, c_in // CK, CK, n_chunks, nb)
    p = p[:, :, :, :, :, list(K_ORDER)]
    p = p.reshape(3, 3, 3, 2, c_in // CK, 2, 4, n_chunks, nb // 8, 8)
    # dz dy dx part chunk kh kl nc ng nl -> nc chunk dz dy dx part ng kh nl kl
    p = p.permute(7, 4, 0, 1, 2, 3, 8, 5, 9, 6).contiguous()
    return p.reshape(n_chunks, 3 * (c_in // CK), 9, 2, CK * nb), nb


def pack_weights_bf16(w: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """DHWIO ``w`` (3, 3, 3, c_in, c_out) -> ``(packed, nb)``: the bf16
    form's weights, rounded to bf16 (ties to even), ``packed[nc, 3 * chunk
    + dz, 3 * dy + dx]`` for N tile ``nc`` (``nb`` channels, zero past
    ``c_out``) and 16-channel chunk ``chunk`` (zero past ``c_in``), each a
    (16 k, nb n) matrix in wgmma's K-major no-swizzle core-matrix layout
    for 16-bit types: element (k, n) at ``((n // 8) * 2 + k // 8) * 64 +
    (n % 8) * 8 + k % 8``, column k holding channel k of the chunk.  One
    pipeline stage of the kernel, ``packed[nc, s]``, is contiguous."""
    c_in, c_out = int(w.shape[3]), int(w.shape[4])
    nb = n_tile(c_out)
    n_chunks = -(-c_out // nb)
    kc = -(-c_in // CK_BF16)
    p = F.pad(w, (0, nb * n_chunks - c_out, 0, kc * CK_BF16 - c_in)
              ).to(torch.bfloat16)
    p = p.reshape(3, 3, 3, kc, 2, 8, n_chunks, nb // 8, 8)
    # dz dy dx chunk kh kl nc ng nl -> nc chunk dz dy dx ng kh nl kl
    p = p.permute(6, 3, 0, 1, 2, 7, 4, 8, 5).contiguous()
    return p.reshape(n_chunks, 3 * kc, 9, CK_BF16 * nb), nb


def bf16_tiles(mt: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The bf16 tensor-core kernel's two block tiles ``(ty, tx)`` when a
    warpgroup takes ``mt`` tiles of 8 x 8 pixels stacked in y: the two
    warpgroups side by side, (8 mt, 16), or one above the other, tall,
    (16 mt, 8)."""
    return (8 * mt, 16), (16 * mt, 8)


def bf16_tile(y: int, x: int, mt: int = 1) -> Tuple[int, int]:
    """Of :func:`bf16_tiles`, the block tile ``(ty, tx)`` that pads fewer
    pixels of a (y, x) plane, the wide one on a tie."""
    return min(bf16_tiles(mt), key=lambda t: (-(-y // t[0]) * t[0] *
                                              -(-x // t[1]) * t[1], t[1] == 8))


def tma_halo_args_bf16(shape: Sequence[int], tile: Tuple[int, int]
                       ) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                  Tuple[int, ...]]:
    """The 5-D bf16 tensor map over a contiguous (b, z, y, x, c) batch for
    the bf16 kernel's block tile ``(ty, tx)``: dims (c, x, y, z, b), the
    byte strides of dims 1-4, and the box of one 8-channel halo plane,
    (8, tx + 2, ty + 2, 1, 1), 16 bytes a pixel."""
    b, z, y, x, c = (int(s) for s in shape)
    dims = (c, x, y, z, b)
    strides = (2 * c, 2 * c * x, 2 * c * x * y, 2 * c * x * y * z)
    return dims, strides, (CK, tile[1] + 2, tile[0] + 2, 1, 1)


def tma_halo_args(shape: Sequence[int]
                  ) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                             Tuple[int, ...]]:
    """The 5-D f32 tensor map over a contiguous (b, z, y, x, c) batch, as
    ``cuTensorMapEncodeTiled`` takes it: dims (c, x, y, z, b) innermost
    first, the byte strides of dims 1-4, and the box of one pipeline stage,
    an 8-channel (TY + 2, TX + 2) halo plane.  z and b stay separate dims,
    so a z-halo at a volume's edge reads TMA's zero fill, not the next
    volume."""
    b, z, y, x, c = (int(s) for s in shape)
    dims = (c, x, y, z, b)
    strides = (4 * c, 4 * c * x, 4 * c * x * y, 4 * c * x * y * z)
    return dims, strides, (CK, TX + 2, TY + 2, 1, 1)


# (id(w), tag) -> (weakref to w, w._version, packed, nb): weights are packed
# once per packing
_packed: Dict[Tuple[int, str], tuple] = {}


def cached_pack(w: torch.Tensor, tag: str,
                pack: Callable[[torch.Tensor], Tuple[torch.Tensor, int]]
                ) -> Tuple[torch.Tensor, int]:
    """``pack(w)``, a kernel's ``(packed, nb)``, cached under ``tag`` while
    ``w`` lives and is not modified in place."""
    key = (id(w), tag)
    hit = _packed.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2], hit[3]
    packed, nb = pack(w)
    if hit is None:
        weakref.finalize(w, _packed.pop, key, None)
    _packed[key] = (weakref.ref(w), w._version, packed, nb)
    return packed, nb


def packed_weights(w: torch.Tensor, bf16: bool = False
                   ) -> Tuple[torch.Tensor, int]:
    """:func:`pack_weights_tc` of ``w`` (``bf16``: :func:`pack_weights_bf16`),
    cached while ``w`` lives and is not modified in place."""
    if bf16:
        return cached_pack(w, "conv3x3x3_wgmma_bf16", pack_weights_bf16)
    return cached_pack(w, "conv3x3x3_wgmma", pack_weights_tc)


# ---- wrappers ---------------------------------------------------------------

def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           x_dtypes=(torch.float32,)) -> None:
    """Shapes, dtypes, contiguity and devices of a conv's operands: w, b
    (and anything after them) f32, x of ``x_dtypes``."""
    if x.dim() not in (4, 5):
        raise ValueError(f"x must be ([b,] z, y, x, c_in), got "
                         f"{tuple(x.shape)}")
    c_in = x.shape[-1]
    if tuple(w.shape[:4]) != (3, 3, 3, c_in) or w.dim() != 5:
        raise ValueError(f"w must be (3, 3, 3, {c_in}, c_out), got "
                         f"{tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[4],):
        raise ValueError(f"b must be ({w.shape[4]},), got {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        ok = x_dtypes if name == "x" else (torch.float32,)
        if t.dtype not in ok:
            raise TypeError(f"{name} must be {' or '.join(map(str, ok))}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _launch_direct(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   relu: bool) -> torch.Tensor:
    lib = cuda_build.load("conv3x3x3")
    fn = lib.conv3x3x3_direct_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    xb = x if x.dim() == 5 else x[None]
    nb, z, y, xl, c_in = xb.shape
    c_out = int(w.shape[4])
    out = torch.empty((nb, z, y, xl, c_out), dtype=torch.float32,
                      device=x.device)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, tx, zs, _ = direct_plan(xb.shape, c_out, n_sm)
    err = fn(xb.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), nb,
             z, y, xl, c_in, c_out, tile, tx, zs, int(relu),
             torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "conv3x3x3_direct")
    cuda_build.count_launch(conv3x3x3_direct)
    return out if x.dim() == 5 else out[0]


def _check_bn(bn, x: torch.Tensor, c_out: int) -> None:
    """The block's ``(mean, inv, beta)``: contiguous f32 (c_out,) on x's
    device."""
    for t in bn:
        if t.dtype != torch.float32 or tuple(t.shape) != (c_out,) or \
                not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"mean, inv and beta must be contiguous "
                             f"float32 ({c_out},) on {x.device}")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch_stem_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      act, bn=None) -> torch.Tensor:
    """The bf16 stem kernel (``csrc/conv3x3x3_bf16.cu``) on an f32 (or
    bf16, widened) input: f32 out with ``bn`` None (the bf16 layer), else
    the block, bf16 out."""
    fn = cuda_build.function(
        "conv3x3x3_bf16", "conv3x3x3_bf16",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    xb = (x if x.dim() == 5 else x[None]).float()
    nb, z, y, xl, c_in = xb.shape
    c_out = int(w.shape[4])
    mean, inv, beta = (None,) * 3 if bn is None else bn
    out = torch.empty((nb, z, y, xl, c_out), device=x.device,
                      dtype=torch.float32 if bn is None else torch.bfloat16)
    tile, tx, zs, _ = stem_plan(tuple(xb.shape), c_out,
                                cuda_build.sm_count(x.device))
    err = fn(xb.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(mean),
             _ptr(inv), _ptr(beta), out.data_ptr(), nb, z, y, xl, c_in,
             c_out, tile, tx, zs, int(bn is not None), ACTIVATIONS[act],
             cuda_build.raw_stream(x))
    cuda_build.check(err, "conv3x3x3_bf16")
    cuda_build.count_launch(conv3x3x3_direct_bf16)
    return out if x.dim() == 5 else out[0]


@functools.lru_cache(maxsize=256)
def _bf16_map_args(shape: Tuple[int, ...], nt: int):
    """``(tall, dims, strides, box)`` of the bf16 kernel's launch on a
    contiguous (b, z, y, x, c) bf16 batch with N tile ``nt``: its block
    tile (:func:`bf16_tile`) and tensor map (:func:`tma_halo_args_bf16`),
    the map's arguments as the ctypes arrays the ``.cu`` takes (builds
    it: the tiles a warpgroup takes are the ``.cu``'s ``Tile<NB>::MT``)."""
    tile = bf16_tile(shape[2], shape[3],
                     wgmma_bf16_plan(nt, shape[4])["mt"])
    dims, strides, box = tma_halo_args_bf16(shape, tile)
    return (int(tile[1] == 8), (ctypes.c_uint64 * 5)(*dims),
            (ctypes.c_uint64 * 4)(*strides), (ctypes.c_uint32 * 5)(*box))


def _launch_wgmma_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       act, bn=None, cache: bool = True) -> torch.Tensor:
    """The bf16 tensor-core kernel (``csrc/conv3x3x3_wgmma_bf16.cu``) on x
    rounded to bf16 (once, here, where it is f32): f32 out with ``bn``
    None (the bf16 layer), else the block, bf16 out; one launch.  Where
    c_in % 16 == 8 the last chunk's missing channels read a plane of
    zeros, so a non-finite x gives what the plain conv gives."""
    c_in, c_out = int(w.shape[3]), int(w.shape[4])
    if route(c_in, c_out) != "wgmma":
        raise ValueError(f"conv3x3x3_wgmma_bf16 takes c_in and c_out that "
                         f"are multiples of {CK}, got {c_in} -> {c_out}")
    xb = (x if x.dim() == 5 else x[None]).to(torch.bfloat16).contiguous()
    nb, z, y, xl, _ = xb.shape
    if xb.data_ptr() % 16:
        raise ValueError("conv3x3x3_wgmma_bf16 needs a 16-byte aligned x")
    mean, inv, beta = (None,) * 3 if bn is None else bn
    packed, nt = packed_weights(w, True) if cache else pack_weights_bf16(w)
    fn = cuda_build.function(
        "conv3x3x3_wgmma_bf16", "conv3x3x3_wgmma_bf16",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 4)
    out = torch.empty((nb, z, y, xl, c_out), device=x.device,
                      dtype=torch.float32 if bn is None else torch.bfloat16)
    tall, dims, strides, box = _bf16_map_args(tuple(xb.shape), nt)
    err = fn(xb.data_ptr(), packed.data_ptr(), b.data_ptr(), _ptr(mean),
             _ptr(inv), _ptr(beta), out.data_ptr(), nb, z, y, xl, c_in,
             c_out, nt, tall, int(bn is not None), ACTIVATIONS[act], dims,
             strides, box, cuda_build.raw_stream(x))
    cuda_build.check(err, "conv3x3x3_wgmma_bf16")
    cuda_build.count_launch(conv3x3x3_wgmma_bf16)
    return out if x.dim() == 5 else out[0]


def _launch_wgmma(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  relu: bool, cache: bool = True) -> torch.Tensor:
    c_in, c_out = int(w.shape[3]), int(w.shape[4])
    if route(c_in, c_out) != "wgmma":
        raise ValueError(f"conv3x3x3_wgmma takes c_in and c_out that are "
                         f"multiples of {CK}, got {c_in} -> {c_out}")
    xb = x if x.dim() == 5 else x[None]
    nb, z, y, xl, _ = xb.shape
    if xb.data_ptr() % 16 or z > GRID_Z_MAX:
        raise ValueError("conv3x3x3_wgmma needs a 16-byte aligned x and at "
                         f"most {GRID_Z_MAX} z-planes")
    packed, nt = packed_weights(w) if cache else pack_weights_tc(w)
    n_chunks = packed.shape[0]
    lib = cuda_build.load("conv3x3x3_wgmma")
    fn = lib.conv3x3x3_wgmma_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    out = torch.empty((nb, z, y, xl, c_out), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # grid.z holds batch x N tiles: split batches that overflow it
    per_launch = max(1, GRID_Z_MAX // n_chunks)
    for b0 in range(0, nb, per_launch):
        nb_i = min(per_launch, nb - b0)
        dims, strides, box = tma_halo_args((nb_i, z, y, xl, c_in))
        err = fn(xb[b0].data_ptr(), packed.data_ptr(), b.data_ptr(),
                 out[b0].data_ptr(), nb_i, z, y, xl, c_in, c_out, nt,
                 int(relu), (ctypes.c_uint64 * 5)(*dims),
                 (ctypes.c_uint64 * 4)(*strides),
                 (ctypes.c_uint32 * 5)(*box), stream)
        cuda_build.check(err, "conv3x3x3_wgmma")
        cuda_build.count_launch(conv3x3x3_wgmma)
    return out if x.dim() == 5 else out[0]


def direct_smem_bytes(c_in: int, tile: int, tx: int) -> int:
    """The dynamic shared memory of a block of the direct kernel for
    ``c_in`` channels, output tile ``tile`` and pixel tile width ``tx``, in
    bytes (builds it)."""
    fn = cuda_build.load("conv3x3x3").conv3x3x3_direct_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    out = fn(c_in, tile, tx)
    if out < 0:
        raise ValueError(f"no tile ({tile}, {tx}); the kernel has "
                         f"{DIRECT_TILES} x {DIRECT_TX}")
    return out


def stem_smem_bytes(tile: int, tx: int) -> int:
    """The dynamic shared memory of a block of the bf16 stem kernel for
    output tile ``tile`` and pixel tile width ``tx``, in bytes (builds
    it)."""
    fn = cuda_build.function("conv3x3x3_bf16", "conv3x3x3_bf16_smem_bytes",
                             [ctypes.c_int] * 2)
    out = fn(tile, tx)
    if out < 0:
        raise ValueError(f"no tile ({tile}, {tx}); the kernel has "
                         f"{DIRECT_TILES} x {STEM_TX}")
    return out


def wgmma_bf16_plan(nb: int, c_in: int, tall: bool = False
                    ) -> Dict[str, int]:
    """The bf16 tensor-core kernel's pipeline for N tile ``nb``, ``c_in``
    channels and the tile orientation, as the ``.cu`` plans it (builds
    it): ``resident`` (the N tile's weights loaded once a block) or
    streamed a stage at a time, ``stages`` in the ring, ``smem`` bytes of
    dynamic shared memory a block, ``blocks`` an SM is meant to hold,
    ``mt`` 8 x 8 pixel tiles a warpgroup (its block tiles
    :func:`bf16_tiles`)."""
    fn = cuda_build.function(
        "conv3x3x3_wgmma_bf16", "conv3x3x3_wgmma_bf16_plan",
        [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = (ctypes.c_int * 5)()
    if fn(nb, c_in, int(tall), out) < 0:
        raise ValueError(f"no N tile {nb}; the kernel has {N_TILES}")
    return dict(zip(("resident", "stages", "smem", "blocks", "mt"), out))


def wgmma_smem_bytes(nb: int, bf16: bool = False) -> int:
    """The dynamic shared memory of a block of the tensor-core kernel with
    N tile ``nb`` (``bf16``: of the bf16 kernel, weights streamed, its
    largest), in bytes, as the ``.cu`` sizes it (builds it)."""
    if bf16:
        return max(wgmma_bf16_plan(nb, 256, tall)["smem"]
                   for tall in (False, True))
    fn = cuda_build.function("conv3x3x3_wgmma", "conv3x3x3_wgmma_smem_bytes",
                             [ctypes.c_int])
    out = fn(nb)
    if out < 0:
        raise ValueError(f"no N tile {nb}; the kernel has {N_TILES}")
    return out


def conv3x3x3_direct(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """The f32 CUDA-core kernel (``csrc/conv3x3x3.cu``), any widths, built
    for the c_in = 1 stems: one launch per batch (counted in ``conv3x3x3_direct.launches``) on a CUDA
    tensor, the plain version on a CPU tensor."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3x3_bias_relu_plain(x, w, b, relu)
    return _launch_direct(x, w, b, relu)


def conv3x3x3_wgmma(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    relu: bool = True) -> torch.Tensor:
    """The three-pass TF32 tensor-core kernel (``csrc/conv3x3x3_wgmma.cu``),
    for widths that are multiples of 8: one launch per batch (counted in
    ``conv3x3x3_wgmma.launches``) on a CUDA tensor, the plain version on a
    CPU tensor."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3x3_bias_relu_plain(x, w, b, relu)
    return _launch_wgmma(x, w, b, relu)


BF16_IN = (torch.float32, torch.bfloat16)


def conv3x3x3_wgmma_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         relu: bool = True) -> torch.Tensor:
    """The bf16 tensor-core kernel (``csrc/conv3x3x3_wgmma_bf16.cu``) as
    JAX's bf16 layer, for widths that are multiples of 8: x (f32 or bf16)
    rounded to bf16, f32 out; one launch per batch (counted in
    ``conv3x3x3_wgmma_bf16.launches``) on a CUDA tensor, the plain bf16
    version on a CPU tensor."""
    _check(x, w, b, BF16_IN)
    if x.device.type == "cpu":
        return conv3x3x3_bias_relu_plain(x.float(), w, b, relu,
                                         torch.bfloat16)
    return _launch_wgmma_bf16(x, w, b, "relu" if relu else None)


def conv3x3x3_direct_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          relu: bool = True) -> torch.Tensor:
    """The bf16 stem kernel (``csrc/conv3x3x3_bf16.cu``) as JAX's bf16
    layer: x and w rounded to bf16 on load, f32 out, built for the c_in = 1
    stems (other widths take its simple kernel); one launch per batch
    (counted in ``conv3x3x3_direct_bf16.launches``) on a CUDA tensor, the
    plain bf16 version on a CPU tensor."""
    _check(x, w, b, BF16_IN)
    if x.device.type == "cpu":
        return conv3x3x3_bias_relu_plain(x.float(), w, b, relu,
                                         torch.bfloat16)
    return _launch_stem_bf16(x, w, b, "relu" if relu else None)


def conv3x3x3_block_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         mean: torch.Tensor, inv: torch.Tensor,
                         beta: torch.Tensor, act=None) -> torch.Tensor:
    """The legacy U-Net's block in bf16, ``bf16_rne((act(conv(x, bf16(w)) +
    b) - mean) * inv + beta)``, everything before the rounding in f32: x
    ([b,] z, y, x, c_in) bf16 (or f32, rounded), w DHWIO, b, and
    BatchNorm's ``mean``, ``inv = rsqrt(var + eps) * scale`` and ``beta``
    per channel (f32); ``act`` None, ``"relu"`` or ``"leaky_relu"``; bf16
    out.  On a CUDA tensor one launch of the kernel :func:`route` names for
    bf16 (counted under ``conv3x3x3_wgmma_bf16`` or
    ``conv3x3x3_direct_bf16``), its epilogue the bias, activation,
    BatchNorm and rounding; on a CPU tensor
    :func:`conv3x3x3_block_bf16_plain`."""
    _check(x, w, b, BF16_IN)
    c_out = int(w.shape[4])
    bn = (mean, inv, beta)
    _check_bn(bn, x, c_out)
    if act not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {list(ACTIVATIONS)}, "
                         f"got {act!r}")
    if x.device.type == "cpu":
        return conv3x3x3_block_bf16_plain(x, w, b, mean, inv, beta, act)
    if route(x.shape[-1], c_out) == "wgmma":
        return _launch_wgmma_bf16(x, w, b, act, bn)
    return _launch_stem_bf16(x, w, b, act, bn)


def conv3x3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        relu: bool = True, cache: bool = True,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """SAME 3x3x3 conv + bias (+ReLU) on one (z, y, x, c_in) f32 volume or
    a (b, z, y, x, c_in) batch of them, in ``compute_dtype`` (float32, or
    bfloat16 operands with f32 products and sums, as JAX's
    ``layers.conv3d``; x may then be bf16 too); the output is f32 either
    way.

    CUDA tensors launch the kernel :func:`route` names, once per batch;
    CPU tensors take the plain version.  ``cache=False`` packs ``w`` for
    the tensor-core kernel afresh instead of through :func:`cached_pack`,
    for a weight that is used once.
    """
    bf16 = check_compute_dtype(compute_dtype)
    _check(x, w, b, BF16_IN if bf16 else (torch.float32,))
    if x.device.type == "cpu":
        return conv3x3x3_bias_relu_plain(x.float(), w, b, relu,
                                         compute_dtype)
    wgmma = route(x.shape[-1], w.shape[4]) == "wgmma"
    if bf16:
        act = "relu" if relu else None
        return _launch_wgmma_bf16(x, w, b, act, cache=cache) if wgmma \
            else _launch_stem_bf16(x, w, b, act)
    if wgmma:
        return _launch_wgmma(x, w, b, relu, cache)
    return _launch_direct(x, w, b, relu)


def flipped_weights(w: torch.Tensor) -> torch.Tensor:
    """DHWIO ``w`` (3, 3, 3, c_in, c_out) -> the input gradient's weights
    (3, 3, 3, c_out, c_in): flipped on the three spatial axes, the two
    channel axes swapped, contiguous."""
    return w.flip((0, 1, 2)).transpose(3, 4).contiguous()


def conv3x3x3_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dW[kz, ky, kx, ci, co] = sum_v x[v + k - 1, ci] g[v, co]`` for a
    ([b,] z, y, x, c_in) input and the ([b,] z, y, x, c_out) gradient of
    the conv's pre-bias output: (3, 3, 3, c_in, c_out).  On the card it is
    cuDNN's, in full f32 as ``utils.device.select_device`` pins it (its
    TF32 default would put a ~1e-3 relative error into every weight
    gradient); it raises if TF32 is on."""
    if x.is_cuda and torch.backends.cudnn.allow_tf32:
        raise RuntimeError("cuDNN TF32 is on: the weight gradient needs "
                           "utils.device.pin_float32()")
    xb = x if x.dim() == 5 else x[None]
    gb = g if g.dim() == 5 else g[None]
    c_in, c_out = int(xb.shape[-1]), int(gb.shape[-1])
    dw = torch.nn.grad.conv3d_weight(
        xb.permute(0, 4, 1, 2, 3), (c_out, c_in, 3, 3, 3),
        gb.permute(0, 4, 1, 2, 3), padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


class Conv3x3x3BiasReLU(torch.autograd.Function):
    """:func:`conv3x3x3_bias_relu` with a gradient.  Forward: the router's
    kernel (its plain version on a CPU tensor).  Backward, with ``g' = g *
    (y > 0)`` under the ReLU (JAX's relu has gradient 0 at 0): dX, only
    when x needs it, is the SAME conv of ``g'`` with
    :func:`flipped_weights` through the router, on the card one more
    launch of the kernel :func:`route` picks for the swapped widths; db is
    ``g'`` summed over every axis but the channels; dW is
    :func:`conv3x3x3_weight_grad`.  A failed build or launch raises.  A
    ``compute_dtype=torch.bfloat16`` forward runs the bf16 kernels; its
    backward raises ``NotImplementedError`` (``ROADMAP.md`` A.4: no JAX
    trainer differentiates a bf16 conv)."""

    @staticmethod
    def forward(ctx, x, w, b, relu: bool, compute_dtype=torch.float32):
        y = conv3x3x3_bias_relu(x, w, b, relu, compute_dtype=compute_dtype)
        ctx.relu = relu
        ctx.bf16 = check_compute_dtype(compute_dtype)
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.bf16:
            raise NotImplementedError(BF16_GRAD)
        x, w, y = ctx.saved_tensors
        g = (g * (y > 0) if ctx.relu else g).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            wt = flipped_weights(w)
            dx = conv3x3x3_bias_relu(
                g, wt, torch.zeros(wt.shape[4], dtype=g.dtype,
                                   device=g.device), relu=False,
                cache=False)
        if ctx.needs_input_grad[1]:
            dw = conv3x3x3_weight_grad(x, g)
        if ctx.needs_input_grad[2]:
            db = g.reshape(-1, g.shape[-1]).sum(0)
        return dx, dw, db, None, None


conv3x3x3_direct.launches = 0
conv3x3x3_wgmma.launches = 0
conv3x3x3_direct_bf16.launches = 0
conv3x3x3_wgmma_bf16.launches = 0
KERNELS = (conv3x3x3_direct, conv3x3x3_wgmma, conv3x3x3_direct_bf16,
           conv3x3x3_wgmma_bf16)
