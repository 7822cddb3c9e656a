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


def exp(x: torch.Tensor) -> torch.Tensor:
    """Float32 exponential within float32 rounding on every device.

    The card's float32 ``exp`` (CUDA's ``expf``) is a 2-ulp function: in
    the first PR-GLS E-steps of a bench-scene volume it misses the
    correctly rounded value in 19-20% of elements, by up to 1.7 ulp and
    with a mean of +0.05-0.07 ulp (0.4% of elements in later ones).  The
    refined EM (``m_step_refine``) turned that bias into a trajectory of
    its own: an identity switch on the card that no CPU run shows from the
    same inputs.  On the card the exponential is therefore taken in
    float64 and rounded once (:func:`correctly_rounded_exp`).  The CPU's
    float32 ``exp`` stays: it misses the correctly rounded value in under
    1% of those elements, by at most 0.54 ulp, and the CPU tests hold the
    port's EM trajectories to JAX's with it."""
    return correctly_rounded_exp(x) if x.is_cuda else torch.exp(x)


def correctly_rounded_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) rounded once to ``x``'s dtype from float64, where the
    exponential is within an ulp on either device: the correctly rounded
    float32 value, but for arguments within a float64 ulp of a float32
    rounding midpoint."""
    return torch.exp(x.double()).to(x.dtype)


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
