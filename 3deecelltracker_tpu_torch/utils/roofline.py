"""The card's roofline for a kernel's least time, and the library yardstick.

``bound`` is the least time an H100 could take for a piece of work: the
larger of its bytes (each input read once, each output written once) at
HBM3's rate and its FLOP at the f32 peak outside the tensor cores (or, where
asked, another peak).  ``conv_tc_bound`` is the least time of the
three-pass TF32 conv (``csrc/conv3x3x3_wgmma.cu``): three TF32 products per
f32 multiply, at the dense TF32 tensor-core peak; ``conv_bf16_bound`` that
of its one-pass bf16 form, at the dense bf16 peak (f32 activations in and
out, as the JAX package's bf16 layers hand them on).
``library_conv`` is one cuDNN call for the SAME 3x3x3 conv + bias
(on bf16 tensors, cuDNN's bf16 conv); each is timed beside the port's
conv kernels and never runs on a port path.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, f32 FLOP/s outside the tensor
# cores and dense TF32 FLOP/s on the tensor cores, at the 700 W power limit
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_TF32_FLOP_S = 495e12
PEAK_BF16_FLOP_S = 989e12
# TF32 products per f32 multiply in the tensor-core conv (hi*hi, hi*lo,
# lo*hi)
TC_PASSES = 3


def bound(flop: float, nbytes: float, peak: float = PEAK_F32_FLOP_S
          ) -> Tuple[float, str]:
    """(least ms on the card, what sets it) for ``flop`` operations at
    ``peak`` FLOP/s (default: f32) on ``nbytes`` moved."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flop / peak * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_flop(x: torch.Tensor, c_out: int) -> float:
    """FLOP of a SAME 3x3x3 conv of ``x`` (channels last, any batch)."""
    return 2.0 * 27 * x.numel() * c_out


def conv_bytes(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> int:
    """x, w and b read once, the f32 output written once."""
    return nbytes(x, w, b) + x.numel() // x.shape[-1] * w.shape[-1] * 4


def conv_bound(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> Tuple[float, str]:
    """``bound`` of one SAME 3x3x3 conv in f32."""
    return bound(conv_flop(x, w.shape[-1]), conv_bytes(x, w, b))


def conv_tc_bound(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[float, str]:
    """``bound`` of the same conv in three TF32 passes on the tensor
    cores."""
    return bound(TC_PASSES * conv_flop(x, w.shape[-1]), conv_bytes(x, w, b),
                 PEAK_TF32_FLOP_S)


def conv_bf16_bound(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[float, str]:
    """``bound`` of the same conv in one bf16 pass on the tensor cores,
    reading x, w and b and writing the output in f32."""
    return bound(conv_flop(x, w.shape[-1]), conv_bytes(x, w, b),
                 PEAK_BF16_FLOP_S)


def library_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """One cuDNN call, conv + bias, on a channels-last volume or batch
    (NDHWC is cuDNN's channels_last_3d layout)."""
    xb = x if x.dim() == 5 else x[None]
    return F.conv3d(xb.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b,
                    padding=1)
