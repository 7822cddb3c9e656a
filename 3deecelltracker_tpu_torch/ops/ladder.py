"""The conv probe's kernel ladder: three CUDA kernel wrappers and their plain
versions.

They replace the Pallas constructs of ``scripts/probe_conv_fast.py::
pallas_ladder`` (entries A, B/B2 and C; entry E is the backbone conv,
``ops.hopper_conv``).  The probe times them beside the library conv at the
backbone's hot shape, (24, 204, 84) with c32 -> c32 and c32 -> c128, in the
JAX probe's layouts: channels-last ``(z, y, x, c)`` volumes, DHWIO weights.

- ``ladder_add_one`` (A): ``x + 1``;
- ``ladder_pointwise_matmul`` (B, B2): the per-voxel channel product
  ``einsum("zyxc,co->zyxo", x, w)``, a streaming kernel: persistent blocks,
  TMA tiles of rows in and out (:func:`pointwise_plan`);
- ``ladder_conv9view_bias_relu`` (C): the SAME 3x3x3 conv + bias + ReLU as
  nine (dy, dx) views of the z-packed volume ``vz`` (K = 3 * c_in), each a
  product with ``w9[dy, dx]``, on the tensor cores in three TF32 passes.
  The kernel reads the views and z-planes as offsets into TMA halo tiles of
  ``x`` itself, so ``vz`` is never formed; ``w9`` is split into TF32 hi/lo
  halves and packed once per weight tensor (:func:`pack_w9_tc`).

On a CUDA tensor each wrapper launches its kernel from ``csrc/ladder.cu``
(design and bound: see the notes there) and counts the launch in
``<wrapper>.launches``; on a CPU tensor it runs its plain version.  There is
no fallback between the two: what the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import cuda_build
from . import hopper_conv

GRID_Z_MAX = 65535    # CUDA's limit on gridDim.y and gridDim.z

_P, _I = ctypes.c_void_p, ctypes.c_int
_LL = ctypes.c_longlong
# csrc/ladder.cu's C interface
_ARGTYPES = {
    "ladder_add_one_f32": [_P, _P, _LL, _LL, _I, _P],
    "ladder_pointwise_matmul_f32": [_P] * 3 + [_LL] + [_I] * 4 + [_P],
    "ladder_pointwise_smem_bytes": [_I] * 3,
    "ladder_conv9view_bias_relu_f32": [_P] * 4 + [_I] * 7 + [_P] * 4,
    "ladder_conv9view_smem_bytes": [_I] * 2,
}


def _lib_fn(name: str):
    """The ctypes handle of ``name``, resolved once per process."""
    return cuda_build.function("ladder", name, _ARGTYPES[name])


def _check_f32(device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _aligned(*tensors: torch.Tensor) -> None:
    """TMA reads and writes 16-byte aligned global memory only."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the ladder's TMA kernels need 16-byte aligned "
                             "tensors")


# ---- A: x + 1 ---------------------------------------------------------------

# csrc/ladder.cu's add_one kernel: threads per block, float4s in flight per
# thread
ADD_ONE_THREADS = 256
ADD_ONE_UNROLL = 8


def add_one_plan(n: int, aligned: bool, resident: int) -> Tuple[int, int]:
    """``(n4, blocks)`` of the add_one kernel for ``n`` floats: the float4s
    of its stream (none when x or y is off a 16-byte line: then every float
    is scalar) and its grid, one thread per float4 (per float when scalar;
    at least one per float of the tail past the float4s), at most
    ``resident`` blocks (the card's: blocks per SM from the occupancy API
    times the SMs)."""
    n4 = n // 4 if aligned else 0
    work = max(n4, n - 4 * n4)
    return n4, max(1, min(resident, -(-work // ADD_ONE_THREADS)))


def ladder_add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def ladder_add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` of an f32 tensor of any shape, into a new tensor."""
    _check_f32(x.device, x=x)
    if x.device.type == "cpu":
        return ladder_add_one_plain(x)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    n4, blocks = add_one_plan(n, (x.data_ptr() | out.data_ptr()) % 16 == 0,
                              cuda_build.resident_blocks(
                                  "ladder", "ladder_add_one_blocks_per_sm",
                                  x.device))
    err = _lib_fn("ladder_add_one_f32")(x.data_ptr(), out.data_ptr(), n, n4,
                                        blocks, cuda_build.raw_stream(x))
    cuda_build.check(err, "ladder_add_one")
    ladder_add_one.launches += 1
    return out


ladder_add_one.launches = 0


# ---- B, B2: per-voxel channel product ---------------------------------------

# csrc/ladder.cu's pointwise kernel: rows per tile, its N tiles, the blocks
# per SM its persistent grid aims for, and the widest c_in and c_out its
# shared memory holds
PW_ROWS = 256
PW_N_TILES = (8, 16, 32)
PW_BLOCKS_PER_SM = 1
PW_C_IN_MAX = 64
PW_C_OUT_MAX = 128


def pointwise_plan(m: int, c_in: int, c_out: int, n_sm: int
                   ) -> Tuple[int, int, int, int, int]:
    """``(cp, cop, nb, tiles, blocks)`` of the pointwise kernel for an
    (m, c_in) @ (c_in, c_out) product: c_in and c_out padded to a multiple
    of 4 (TMA's 16-byte stride rule), the N tile (the narrowest of
    ``PW_N_TILES`` that holds ``cop``, 32 above that: several tiles, one x
    tile read once for all), the row tiles of ``PW_ROWS`` and the
    persistent grid: ``PW_BLOCKS_PER_SM`` blocks an SM, fewer where there
    are fewer tiles.  Block b takes tiles b, b + blocks, ..."""
    cp, cop = -(-c_in // 4) * 4, -(-c_out // 4) * 4
    nb = next((n for n in PW_N_TILES if n >= cop), PW_N_TILES[-1])
    tiles = -(-m // PW_ROWS)
    return cp, cop, nb, tiles, max(1, min(tiles, PW_BLOCKS_PER_SM * n_sm))


def pointwise_smem_bytes(c_in: int, c_out: int) -> int:
    """The dynamic shared memory of a block of the pointwise kernel for
    ``c_in`` -> ``c_out`` channels, in bytes (builds it)."""
    cp, cop, nb, _, _ = pointwise_plan(1, c_in, c_out, 1)
    return _lib_fn("ladder_pointwise_smem_bytes")(cp, cop, nb)


def ladder_pointwise_matmul_plain(x: torch.Tensor,
                                  w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...c,co->...o", x, w)


def ladder_pointwise_matmul(x: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """``einsum("...c,co->...o", x, w)``: every voxel's c_in channels times
    the (c_in, c_out) matrix ``w``, f32 accumulation.  On the card c_in is
    at most ``PW_C_IN_MAX`` and c_out at most ``PW_C_OUT_MAX``; widths off
    the 16-byte rule are padded with zeros here (a copy of x)."""
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"w must be ({x.shape[-1]}, c_out), got "
                         f"{tuple(w.shape)}")
    _check_f32(x.device, x=x, w=w)
    if x.device.type == "cpu":
        return ladder_pointwise_matmul_plain(x, w)
    c_in, c_out = (int(s) for s in w.shape)
    out = torch.empty(tuple(x.shape[:-1]) + (c_out,), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    if c_in == 0:
        return out.zero_()
    m = x.numel() // c_in
    if c_in > PW_C_IN_MAX or c_out > PW_C_OUT_MAX:
        raise ValueError(f"ladder_pointwise_matmul takes at most "
                         f"{PW_C_IN_MAX} -> {PW_C_OUT_MAX} channels on the "
                         f"card, got {c_in} -> {c_out}")
    cp, cop, nb, _, blocks = pointwise_plan(m, c_in, c_out,
                                            cuda_build.sm_count(x.device))
    x2 = x.reshape(m, c_in)
    if cp != c_in:
        x2 = F.pad(x2, (0, cp - c_in))
    wp = F.pad(w, (0, cop - c_out, 0, cp - c_in)).contiguous() \
        if (cp, cop) != (c_in, c_out) else w
    y2 = out.view(m, c_out) if cop == c_out else torch.empty(
        (m, cop), dtype=torch.float32, device=x.device)
    _aligned(x2, wp, y2)
    err = _lib_fn("ladder_pointwise_matmul_f32")(
        x2.data_ptr(), wp.data_ptr(), y2.data_ptr(), m, cp, cop, nb, blocks,
        cuda_build.raw_stream(x))
    cuda_build.check(err, "ladder_pointwise_matmul")
    ladder_pointwise_matmul.launches += 1
    if cop != c_out:
        out.view(m, c_out).copy_(y2[:, :c_out])
    return out


ladder_pointwise_matmul.launches = 0


# ---- C: the 9-view conv -----------------------------------------------------

# csrc/ladder.cu's nine-view kernel: channels per K step (wgmma tf32 k8), the
# 8-channel chunks one halo group may hold (its template instances), its
# 16 (x) by 8 (y) tile
C9_CK = hopper_conv.CK
C9_GROUPS = (4, 2, 1)
C9_TX, C9_TY = 16, 8


def pack_w9(w: torch.Tensor) -> torch.Tensor:
    """DHWIO (3, 3, 3, c_in, c_out) -> (3, 3, 3 * c_in, c_out): ``w9[dy,
    dx]`` stacks the three z-taps along K, in ``pack_vz``'s channel order."""
    ci, co = w.shape[3], w.shape[4]
    return w.permute(1, 2, 0, 3, 4).reshape(3, 3, 3 * ci, co).contiguous()


def pack_vz(x: torch.Tensor) -> torch.Tensor:
    """(z, y, x, c) -> the zero-padded, z-packed (z, y + 2, x + 2, 3 * c):
    channel block ``dz`` holds slice ``z + dz - 1``."""
    z = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    return torch.cat([xp[0:z], xp[1:z + 1], xp[2:z + 2]], dim=-1)


def c9_plan(c_in: int) -> Tuple[int, int, int]:
    """``(cp, gc, n_groups)``: c_in padded to the k8 step, the 8-channel
    chunks of one halo group (the largest of ``C9_GROUPS`` that divides the
    chunks: all of c_in 32 in one group) and the groups."""
    cp = -(-c_in // C9_CK) * C9_CK
    chunks = cp // C9_CK
    gc = next(d for d in C9_GROUPS if chunks % d == 0)
    return cp, gc, chunks // gc


def pack_w9_tc(w9: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``w9`` (3, 3, 3 * c_in, c_out) -> ``(packed, nb)``, the nine-view
    kernel's weights: ``packed[nt, grp, 3 * (3 * dy + dx) + dz, j, part]``
    for N tile ``nt`` (``nb`` channels, :func:`hopper_conv.n_tile`, zero
    past c_out), halo group ``grp``, view (dy, dx), z-plane dz, chunk ``j``
    of the group and ``part`` 0 = hi, 1 = lo (``hopper_conv.split_tf32``):
    an (8 k, nb n) matrix in wgmma's K-major no-swizzle core-matrix layout,
    element (k, n) at ``((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4``
    holding channel ``8 * (gc * grp + j) + K_ORDER[k]`` (zero past c_in) of
    z-plane dz, i.e. ``w9[dy, dx, dz * c_in + channel]``.  One pipeline
    stage, ``packed[nt, grp, s]``, is contiguous."""
    k3, c_out = int(w9.shape[2]), int(w9.shape[3])
    c_in = k3 // 3
    cp, gc, n_groups = c9_plan(c_in)
    nb = hopper_conv.n_tile(c_out)
    n_nt = -(-c_out // nb)
    w = w9.reshape(3, 3, 3, c_in, c_out)                  # dy dx dz c n
    hi, lo = hopper_conv.split_tf32(
        F.pad(w, (0, nb * n_nt - c_out, 0, cp - c_in)))
    p = torch.stack((hi, lo), dim=3)                      # dy dx dz part c n
    p = p.reshape(3, 3, 3, 2, n_groups, gc, C9_CK, n_nt, nb)
    p = p[:, :, :, :, :, :, list(hopper_conv.K_ORDER)]
    p = p.reshape(3, 3, 3, 2, n_groups, gc, 2, 4, n_nt, nb // 8, 8)
    # dy dx dz part grp j kh kl nt ng nl -> nt grp dy dx dz j part ng kh nl kl
    p = p.permute(8, 4, 0, 1, 2, 5, 3, 9, 6, 10, 7).contiguous()
    return p.reshape(n_nt, n_groups, 27, gc, 2, C9_CK * nb), nb


def c9_tma_args(shape) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                Tuple[int, ...]]:
    """The 5-D tensor map of the nine-view kernel over a contiguous (z, y,
    x, cp) volume: ``hopper_conv.tma_halo_args``'s dims and strides, and a
    box of one 8-channel chunk's (TY + 2, TX + 2) halo on all three
    z-planes."""
    dims, strides, box = hopper_conv.tma_halo_args((1,) + tuple(shape))
    return dims, strides, box[:3] + (3, 1)


def conv9view_smem_bytes(c_out: int, c_in: int) -> int:
    """The dynamic shared memory of a block of the nine-view kernel, in
    bytes (builds it)."""
    return _lib_fn("ladder_conv9view_smem_bytes")(
        hopper_conv.n_tile(c_out), c9_plan(c_in)[1])


def ladder_conv9view_bias_relu_plain(x: torch.Tensor, w9: torch.Tensor,
                                     b: torch.Tensor,
                                     relu: bool = True) -> torch.Tensor:
    """The nine (dy, dx) view products of ``pack_vz(x)`` with ``w9`` as
    plain matmuls, + b (+ReLU): x (z, y, x, c_in) -> (z, y, x, c_out)."""
    z, y, xl, _ = x.shape
    vz = pack_vz(x)
    k3, co = w9.shape[2], w9.shape[3]
    acc = torch.zeros((z * y * xl, co), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            v = vz[:, dy:dy + y, dx:dx + xl].reshape(z * y * xl, k3)
            acc = acc + torch.matmul(v, w9[dy, dx])
    out = acc.reshape(z, y, xl, co) + b
    return torch.relu(out) if relu else out


def ladder_conv9view_bias_relu(x: torch.Tensor, w9: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """``relu(conv_same(x, w) + b)`` for x (z, y, x, c_in) f32, ``w9 =
    pack_w9(w)`` (3, 3, 3 * c_in, c_out), b (c_out,).  On the card one
    launch computes the nine view products from TMA halo tiles of x, the
    bias and the ReLU; ``w9`` is packed on its first call
    (:func:`pack_w9_tc`, cached per tensor), and a c_in off the k8 step is
    padded with zero channels here (a copy of x)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (z, y, x, c_in), got {tuple(x.shape)}")
    k3 = 3 * x.shape[-1]
    if w9.dim() != 4 or tuple(w9.shape[:3]) != (3, 3, k3):
        raise ValueError(f"w9 must be (3, 3, {k3}, c_out), got "
                         f"{tuple(w9.shape)}")
    if tuple(b.shape) != (w9.shape[3],):
        raise ValueError(f"b must be ({w9.shape[3]},), got {tuple(b.shape)}")
    _check_f32(x.device, x=x, w9=w9, b=b)
    if x.device.type == "cpu":
        return ladder_conv9view_bias_relu_plain(x, w9, b)
    z, y, xl, c_in = (int(s) for s in x.shape)
    co = int(w9.shape[3])
    out = torch.empty((z, y, xl, co), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if z > GRID_Z_MAX or -(-co // hopper_conv.n_tile(co)) > GRID_Z_MAX:
        raise ValueError(f"{z} slices x {co} channels overflow the grid")
    cp, gc, _ = c9_plan(c_in)
    packed, nb = hopper_conv.cached_pack(w9, "ladder_conv9view", pack_w9_tc)
    xin = x if cp == c_in else F.pad(x, (0, cp - c_in))
    _aligned(xin)
    dims, strides, box = c9_tma_args(xin.shape)
    err = _lib_fn("ladder_conv9view_bias_relu_f32")(
        xin.data_ptr(), packed.data_ptr(), b.data_ptr(), out.data_ptr(), z, y,
        xl, cp, co, nb, gc, (ctypes.c_uint64 * 5)(*dims),
        (ctypes.c_uint64 * 4)(*strides), (ctypes.c_uint32 * 5)(*box),
        cuda_build.raw_stream(x))
    cuda_build.check(err, "ladder_conv9view_bias_relu")
    ladder_conv9view_bias_relu.launches += 1
    return out


ladder_conv9view_bias_relu.launches = 0

KERNELS = (ladder_add_one, ladder_pointwise_matmul,
           ladder_conv9view_bias_relu)
