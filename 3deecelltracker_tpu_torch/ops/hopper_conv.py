"""3x3x3 conv + bias (+ReLU): the CUDA kernel wrapper and its plain version.

``conv3x3x3_bias_relu`` replaces ``3deecelltracker_tpu/ops/pallas_conv.py::
conv3x3x3_fused`` (same contract: a channels-last ``(z, y, x, c_in)`` f32
volume, DHWIO weights, f32 accumulation), and also takes a batch
``(b, z, y, x, c_in)`` of volumes in one launch.  On a CUDA tensor it
launches the hand-written ``csrc/conv3x3x3.cu`` kernel (design and bound:
see the note at the top of that file); on a CPU tensor it runs
:func:`conv3x3x3_bias_relu_plain`.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import cuda_build

COT = 32              # output channels per block (csrc/conv3x3x3.cu)
GRID_Z_MAX = 65535    # CUDA's limit on gridDim.z


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


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            relu: bool) -> torch.Tensor:
    lib = cuda_build.load("conv3x3x3")
    fn = lib.conv3x3x3_bias_relu_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    xb = x if x.dim() == 5 else x[None]
    nb, z, y, xl, c_in = xb.shape
    c_out = w.shape[4]
    out = torch.empty((nb, z, y, xl, c_out), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # grid.z holds batch x z x c_out chunks: split batches that overflow it
    per_launch = max(1, GRID_Z_MAX // (z * -(-c_out // COT)))
    for b0 in range(0, nb, per_launch):
        nb_i = min(per_launch, nb - b0)
        err = fn(xb[b0].data_ptr(), w.data_ptr(), b.data_ptr(),
                 out[b0].data_ptr(), nb_i, z, y, xl, c_in, c_out, int(relu),
                 stream)
        cuda_build.check(err, "conv3x3x3_bias_relu")
        conv3x3x3_bias_relu.launches += 1
    return out if x.dim() == 5 else out[0]


def conv3x3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        relu: bool = True) -> torch.Tensor:
    """SAME 3x3x3 conv + bias (+ReLU) on one (z, y, x, c_in) f32 volume or
    a (b, z, y, x, c_in) batch of them.

    CUDA tensors launch the hand-written kernel, once per batch (counted in
    ``conv3x3x3_bias_relu.launches``); CPU tensors take the plain version.
    """
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3x3_bias_relu_plain(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, w, b, relu)


conv3x3x3_bias_relu.launches = 0
