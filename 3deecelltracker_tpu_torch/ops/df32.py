"""Double-single (compensated float32) arithmetic for the PR-GLS M-step's
residuals (counterpart of ``3deecelltracker_tpu/ops/df32.py``).

Near EM convergence the M-step system reaches condition numbers of
1e6-1e7, where a plain float32 residual ``b - A x`` loses every digit to
cancellation.  ``ops.prgls``'s ``m_step_refine`` path factors a floored
system once and corrects against the true one with residuals computed
here: each value carried as an (hi, lo) pair of float32 with
|lo| <= ulp(hi) / 2, about 48 bits of mantissa.

The primitives are error-free transformations (Dekker 1971, Knuth TAOCP
4.2.2): ``two_sum`` (the exact error of an addition) and ``two_prod``
(Dekker's split with the constant 2^12 + 1, so the 12-bit halves
multiply exactly in float32's 24-bit mantissa).  They hold only while
every operation rounds on its own, in the order written.  So each step
here is one eager torch op: no ``torch.compile`` may trace this module,
and no fused multiply-add (``addcmul``, ``addmm``, ``baddbmm``) may stand
in for a product followed by a sum.  Eager PyTorch runs each elementwise
op as its own kernel, on the CPU and on the card, so nothing fuses them.

Every function broadcasts over leading axes.
"""

from __future__ import annotations

from typing import Tuple

import torch

_SPLIT = 4097.0      # 2**12 + 1, Dekker's splitting constant for float32

Pair = Tuple[torch.Tensor, torch.Tensor]


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """(s, e) with s = fl(a + b) and s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """:func:`two_sum` for |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a: torch.Tensor) -> Pair:
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """(p, e) with p = fl(a * b) and p + e == a * b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(x: Pair, y: Pair) -> Pair:
    """Double-single plus double-single (Dekker's add2)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return fast_two_sum(s, e)


def df_sum(hi: torch.Tensor, lo: torch.Tensor, axis: int) -> Pair:
    """The (hi, lo) pairs summed along ``axis`` by a pairwise tree of
    :func:`df_add` (the length padded with exact zeros to a power of two,
    at least 2), the JAX twin's tree."""
    hi = torch.movedim(hi, axis, 0)
    lo = torch.movedim(lo, axis, 0)
    k = hi.shape[0]
    p = 1 << max(1, (k - 1).bit_length())
    if p != k:
        pad = hi.new_zeros((p - k,) + tuple(hi.shape[1:]))
        hi = torch.cat([hi, pad])
        lo = torch.cat([lo, pad])
    while hi.shape[0] > 1:
        half = hi.shape[0] // 2
        hi, lo = df_add((hi[:half], lo[:half]), (hi[half:], lo[half:]))
    return hi[0], lo[0]


def compensated_residual(b: torch.Tensor, a: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """``b - a @ x`` with double-single products and sums, returned in
    float32: its error relative to the residual stays near float32's eps
    even where ``b`` and ``a @ x`` cancel almost entirely (iterative
    refinement's regime).  Shapes ``a`` (..., n, k), ``x`` (..., k, m),
    ``b`` (..., n, m); the (..., n, k, m) product pair is materialized
    (PR-GLS: n = k <= a few hundred, m = 3)."""
    f32 = torch.float32
    ph, pl = two_prod(a.to(f32)[..., :, :, None], x.to(f32)[..., None, :, :])
    sh, sl = df_sum(ph, pl, axis=-2)                  # (..., n, m)
    rh, re = two_sum(b.to(f32), -sh)
    return rh + (re - sl)
