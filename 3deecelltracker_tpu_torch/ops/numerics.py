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
