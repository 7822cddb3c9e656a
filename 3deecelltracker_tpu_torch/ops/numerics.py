"""Float32 arithmetic the parity with the JAX package depends on."""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.

    PyTorch's float32 ``sqrt`` kernel on the CPU is not correctly rounded:
    its vectorized path misses by an ulp on some inputs, and which elements
    take that path depends on how the tensor is split across threads.  The
    EDT costs the watershed compares with ``==`` and the polyhedron
    membership tests (``distance <= radius``) need XLA's bits, so the root
    is taken in float64 (correctly rounded there) and rounded once."""
    return torch.sqrt(x.double()).to(x.dtype)


def float64_to_float16(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 -> float16, as numpy casts.

    PyTorch converts float64 to float16 through float32, rounding twice,
    and a value just off a float16 midpoint can land on it and then round
    the wrong way.  Rounding to float32 by round-to-odd first (truncate,
    then set the last bit where inexact) keeps the information the second
    rounding needs, so that one is correct."""
    y = x.to(torch.float32)
    yd = y.double()
    inexact = yd != x
    bits = y.view(torch.int32)
    # sign-magnitude: one step down in the bit pattern is toward zero
    bits = torch.where(inexact & (yd.abs() > x.abs()), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float32).to(torch.float16)
