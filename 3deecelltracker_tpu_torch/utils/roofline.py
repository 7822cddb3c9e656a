"""The card's roofline for a kernel's least time, and the library yardstick.

``bound`` is the least time an H100 could take for a piece of work: the
larger of its bytes (each input read once, each output written once) at
HBM3's rate and its FLOP at the f32 peak outside the tensor cores.
``library_conv`` is one cuDNN call for the SAME 3x3x3 conv + bias; it is
timed beside the port's conv kernels and never runs on a port path.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# NVIDIA H100 SXM data sheet: HBM3 bytes/s and f32 FLOP/s outside the
# tensor cores, at the 700 W power limit
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def bound(flop: float, nbytes: float) -> Tuple[float, str]:
    """(least ms on the card, what sets it) for ``flop`` f32 operations on
    ``nbytes`` moved."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flop / PEAK_F32_FLOP_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_flop(x: torch.Tensor, c_out: int) -> float:
    """FLOP of a SAME 3x3x3 conv of ``x`` (channels last, any batch)."""
    return 2.0 * 27 * x.numel() * c_out


def conv_bound(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> Tuple[float, str]:
    """``bound`` of one SAME 3x3x3 conv: x, w and b read once, the f32
    output written once."""
    c_out = w.shape[-1]
    return bound(conv_flop(x, c_out),
                 nbytes(x, w, b) + x.numel() // x.shape[-1] * c_out * 4)


def library_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """One cuDNN call, conv + bias, on a channels-last volume or batch
    (NDHWC is cuDNN's channels_last_3d layout)."""
    xb = x if x.dim() == 5 else x[None]
    return F.conv3d(xb.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b,
                    padding=1)
