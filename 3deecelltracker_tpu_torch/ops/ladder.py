"""The conv probe's kernel ladder: three CUDA kernel wrappers and their plain
versions.

They replace the Pallas constructs of ``scripts/probe_conv_fast.py::
pallas_ladder`` (entries A, B/B2 and C; entry E is the backbone conv,
``ops.hopper_conv``).  The probe times them beside the library conv at the
backbone's hot shape, (24, 204, 84) with c32 -> c32 and c32 -> c128, in the
JAX probe's layouts: channels-last ``(z, y, x, c)`` volumes, DHWIO weights.

- ``ladder_add_one`` (A): ``x + 1``;
- ``ladder_pointwise_matmul`` (B, B2): the per-voxel channel product
  ``einsum("zyxc,co->zyxo", x, w)``;
- ``ladder_conv9view_bias_relu`` (C): the SAME 3x3x3 conv + bias + ReLU as
  nine (dy, dx) views of the z-packed volume ``vz`` (K = 3 * c_in), each a
  product with ``w9[dy, dx]``.  The wrapper forms ``vz`` and the kernel
  reads the nine views from it by offset.

On a CUDA tensor each wrapper launches its kernel from ``csrc/ladder.cu``
(design and bound: see the notes there) and counts the launch in
``<wrapper>.launches``; on a CPU tensor it runs its plain version.  There is
no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build

GRID_Z_MAX = 65535    # CUDA's limit on gridDim.z


def _lib_fn(name: str, argtypes):
    fn = getattr(cuda_build.load("ladder"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


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


# ---- A: x + 1 ---------------------------------------------------------------

def ladder_add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def ladder_add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` of an f32 tensor of any shape, into a new tensor."""
    _check_f32(x.device, x=x)
    if x.device.type == "cpu":
        return ladder_add_one_plain(x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _lib_fn("ladder_add_one_f32", [ctypes.c_void_p] * 2
                 + [ctypes.c_longlong, ctypes.c_void_p])
    err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "ladder_add_one")
    ladder_add_one.launches += 1
    return out


ladder_add_one.launches = 0


# ---- B, B2: per-voxel channel product ---------------------------------------

def ladder_pointwise_matmul_plain(x: torch.Tensor,
                                  w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...c,co->...o", x, w)


def ladder_pointwise_matmul(x: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """``einsum("...c,co->...o", x, w)``: every voxel's c_in channels times
    the (c_in, c_out) matrix ``w``, f32 accumulation."""
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"w must be ({x.shape[-1]}, c_out), got "
                         f"{tuple(w.shape)}")
    _check_f32(x.device, x=x, w=w)
    if x.device.type == "cpu":
        return ladder_pointwise_matmul_plain(x, w)
    c_in, c_out = w.shape
    m = x.numel() // c_in
    out = torch.empty(tuple(x.shape[:-1]) + (c_out,), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn = _lib_fn("ladder_pointwise_matmul_f32", [ctypes.c_void_p] * 3
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, c_in, c_out,
             torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "ladder_pointwise_matmul")
    ladder_pointwise_matmul.launches += 1
    return out


ladder_pointwise_matmul.launches = 0


# ---- C: the 9-view conv -----------------------------------------------------

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
    pack_w9(w)`` (3, 3, 3 * c_in, c_out), b (c_out,).  On the card the
    wrapper forms ``pack_vz(x)`` in PyTorch and one launch computes the
    nine view products, the bias and the ReLU."""
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
    z, y, xl, _ = x.shape
    co = w9.shape[3]
    if z * -(-co // 128) > GRID_Z_MAX:
        raise ValueError(f"{z} slices x {co} channels overflow the grid")
    out = torch.empty((z, y, xl, co), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    vz = pack_vz(x)
    fn = _lib_fn("ladder_conv9view_bias_relu_f32", [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(vz.data_ptr(), w9.data_ptr(), b.data_ptr(), out.data_ptr(), z,
             y, xl, k3, co, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "ladder_conv9view_bias_relu")
    ladder_conv9view_bias_relu.launches += 1
    return out


ladder_conv9view_bias_relu.launches = 0

KERNELS = (ladder_add_one, ladder_pointwise_matmul,
           ladder_conv9view_bias_relu)
