"""3x3x3 conv + bias (+ReLU): the CUDA kernel wrapper and its plain version.

``conv3x3x3_bias_relu`` replaces ``3deecelltracker_tpu/ops/pallas_conv.py::
conv3x3x3_fused`` (same contract: one channels-last ``(z, y, x, c_in)`` f32
volume, DHWIO weights, f32 accumulation).  On a CUDA tensor it launches the
hand-written ``csrc/conv3x3x3.cu`` kernel (design and bound: see the note at
the top of that file); on a CPU tensor it runs
:func:`conv3x3x3_bias_relu_plain`.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import cuda_build


def conv3x3x3_bias_relu_plain(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor,
                              relu: bool = True) -> torch.Tensor:
    """``relu(conv_same(x, w) + b)`` with ``F.conv3d``: x (z, y, x, c_in),
    w (3, 3, 3, c_in, c_out), b (c_out,) -> (z, y, x, c_out).  The bias is
    added after the convolution, as ``layers.conv3d`` does in JAX."""
    xin = x.permute(3, 0, 1, 2).unsqueeze(0)
    wt = w.permute(4, 3, 0, 1, 2)
    out = F.conv3d(xin, wt, padding=1)[0].permute(1, 2, 3, 0) + b
    return torch.relu(out) if relu else out


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (z, y, x, c_in), got {tuple(x.shape)}")
    c_in = x.shape[3]
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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    z, y, xl, c_in = x.shape
    c_out = w.shape[4]
    out = torch.empty((z, y, xl, c_out), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
             z, y, xl, c_in, c_out, int(relu), stream)
    cuda_build.check(err, "conv3x3x3_bias_relu")
    conv3x3x3_bias_relu.launches += 1
    return out


def conv3x3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        relu: bool = True) -> torch.Tensor:
    """SAME 3x3x3 conv + bias (+ReLU) on one (z, y, x, c_in) f32 volume.

    CUDA tensors launch the hand-written kernel (counted in
    ``conv3x3x3_bias_relu.launches``); CPU tensors take the plain version.
    """
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3x3_bias_relu_plain(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, w, b, relu)


conv3x3x3_bias_relu.launches = 0
