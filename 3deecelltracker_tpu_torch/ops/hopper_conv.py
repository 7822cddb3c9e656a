"""3x3x3 conv + bias (+ReLU): the router, its two CUDA kernels' wrappers and
the plain version.

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

On a CPU tensor every entry point runs :func:`conv3x3x3_bias_relu_plain`.
There is no fallback between the three.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import cuda_build

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


def conv3x3x3_bias_relu_plain(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor,
                              relu: bool = True) -> torch.Tensor:
    """``relu(conv_same(x, w) + b)`` with ``F.conv3d``: x (z, y, x, c_in)
    or (b, z, y, x, c_in), w (3, 3, 3, c_in, c_out), b (c_out,) -> the same
    leading shape with c_out channels.  The bias is added after the
    convolution, as ``layers.conv3d`` does in JAX."""
    xin = x if x.dim() == 5 else x[None]
    wt = w.permute(4, 3, 0, 1, 2)
    out = F.conv3d(xin.permute(0, 4, 1, 2, 3), wt, padding=1
                   ).permute(0, 2, 3, 4, 1) + b
    out = out if x.dim() == 5 else out[0]
    return torch.relu(out) if relu else out


def route(c_in: int, c_out: int) -> str:
    """Which kernel takes a layer on the card: ``"wgmma"`` when both widths
    are multiples of 8 (TMA's 16-byte stride rule and the k8 step),
    ``"direct"`` otherwise."""
    return "wgmma" if c_in % CK == 0 and c_out % CK == 0 else "direct"


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
    zs = next((-(-z // n) for n in range(1, z + 1)
               if base * -(-z // -(-z // n)) >= DIRECT_FILL * n_sm), 1)
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


def packed_weights(w: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """:func:`pack_weights_tc` of ``w``, cached while ``w`` lives and is
    not modified in place."""
    return cached_pack(w, "conv3x3x3_wgmma", pack_weights_tc)


# ---- wrappers ---------------------------------------------------------------

def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
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
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
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
    conv3x3x3_direct.launches += 1
    return out if x.dim() == 5 else out[0]


def _launch_wgmma(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  relu: bool) -> torch.Tensor:
    c_in, c_out = int(w.shape[3]), int(w.shape[4])
    if route(c_in, c_out) != "wgmma":
        raise ValueError(f"conv3x3x3_wgmma takes c_in and c_out that are "
                         f"multiples of {CK}, got {c_in} -> {c_out}")
    xb = x if x.dim() == 5 else x[None]
    nb, z, y, xl, _ = xb.shape
    if xb.data_ptr() % 16 or z > GRID_Z_MAX:
        raise ValueError("conv3x3x3_wgmma needs a 16-byte aligned x and at "
                         f"most {GRID_Z_MAX} z-planes")
    packed, nt = packed_weights(w)
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
        conv3x3x3_wgmma.launches += 1
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


def wgmma_smem_bytes(nb: int) -> int:
    """The dynamic shared memory of a block of the tensor-core kernel with
    N tile ``nb``, in bytes, as the ``.cu`` sizes it (builds it)."""
    fn = cuda_build.load("conv3x3x3_wgmma").conv3x3x3_wgmma_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
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


def conv3x3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        relu: bool = True) -> torch.Tensor:
    """SAME 3x3x3 conv + bias (+ReLU) on one (z, y, x, c_in) f32 volume or
    a (b, z, y, x, c_in) batch of them.

    CUDA tensors launch the kernel :func:`route` names, once per batch;
    CPU tensors take the plain version.
    """
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3x3_bias_relu_plain(x, w, b, relu)
    if route(x.shape[-1], w.shape[4]) == "wgmma":
        return _launch_wgmma(x, w, b, relu)
    return _launch_direct(x, w, b, relu)


conv3x3x3_direct.launches = 0
conv3x3x3_wgmma.launches = 0
KERNELS = (conv3x3x3_direct, conv3x3x3_wgmma)
