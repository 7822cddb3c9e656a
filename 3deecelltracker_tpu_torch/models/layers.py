"""Functional NN building blocks on channels-last tensors.

Counterpart of ``3deecelltracker_tpu/models/layers.py``: 'same' convs,
BatchNorm (eps 1e-3, momentum 0.99), LeakyReLU alpha 0.3, nearest
upsampling.
Layouts are the JAX package's: (b, z, y, x, c) activations (the U-Net's
(b, x, y, z, c) tiles go through unchanged: every op here treats the three
spatial axes alike), DHWIO conv weights, (d_in, d_out) dense weights.
Every 3x3x3 conv goes through ``ops.hopper_conv``, which launches one of
its two hand-written CUDA kernels (the tensor-core one for widths that are
multiples of 8, the direct one for the c_in = 1 stems) with the bias and an
optional ReLU fused, through ``ops.hopper_conv.Conv3x3x3BiasReLU``, whose
input gradient runs on the same kernels; 1x1x1 convs are a plain matmul.
``compute_dtype`` is JAX's (``models/layers.py:50-60``, ``:120-126``):
float32 by default; ``torch.bfloat16`` rounds the input and the weights to
bf16 (ties to even) and keeps the products, sums and output in f32, the
bias added unrounded after; BatchNorm, activations, pools, upsampling and
concatenation stay f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.hopper_conv import (Conv3x3x3BiasReLU, check_compute_dtype,
                               round_bf16)
from ..utils.device import select_device

Params = Dict[str, torch.Tensor]

LEAKY_ALPHA = 0.3
BN_MOMENTUM = 0.99
BN_EPS = 1e-3


def glorot_uniform(shape: Sequence[int], fan_in: int, fan_out: int,
                   generator: torch.Generator,
                   device=None) -> torch.Tensor:
    """Seeded glorot-uniform init.  It does not reproduce JAX's numbers:
    parity tests carry weights across with ``utils.convert`` instead.
    ``device=None`` is the card (``utils.device.select_device``)."""
    device = select_device(device)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * limit).to(device)


def init_conv3d(kernel: Sequence[int], c_in: int, c_out: int,
                generator: torch.Generator, device=None) -> Params:
    device = select_device(device)
    rf = int(math.prod(kernel))
    w = glorot_uniform((*kernel, c_in, c_out), rf * c_in, rf * c_out,
                       generator, device)
    return {"w": w, "b": torch.zeros((c_out,), dtype=torch.float32,
                                     device=device)}


def conv3d(params: Params, x: torch.Tensor, compute_dtype=torch.float32, *,
           relu: bool = False) -> torch.Tensor:
    """SAME conv of (b, z, y, x, c_in) with DHWIO weights, + bias, with an
    optional fused ReLU, in ``compute_dtype`` (module docstring).  3x3x3
    kernels run a CUDA kernel, one launch for the whole batch (with a
    gradient under autograd in float32); 1x1x1 kernels are a matmul over
    channels."""
    w = params["w"]
    b = params.get("b")
    if b is None:
        b = torch.zeros((w.shape[-1],), dtype=torch.float32, device=w.device)
    k = tuple(w.shape[:3])
    if k == (1, 1, 1):
        w2 = w.reshape(w.shape[3], w.shape[4])
        if check_compute_dtype(compute_dtype):
            x, w2 = round_bf16(x), round_bf16(w2)
        y = torch.matmul(x, w2) + b
        return torch.relu(y) if relu else y
    if k != (3, 3, 3):
        raise NotImplementedError(f"conv kernel {k}")
    return Conv3x3x3BiasReLU.apply(x.contiguous(), w, b, relu, compute_dtype)


def batchnorm(params: Params, state: Params, x: torch.Tensor,
              train: bool = False, momentum: float = BN_MOMENTUM,
              eps: float = BN_EPS):
    """BatchNorm over the last axis.  Eval mode returns ``y`` from the
    running statistics; ``train=True`` returns ``(y, new_state)``: ``y``
    from the batch's mean and population variance (``jnp.var``'s, the
    mean of the centred squares) and the running statistics moved by
    ``momentum`` as JAX's ``layers.batchnorm`` does."""
    if not train:
        inv = torch.rsqrt(state["var"] + eps) * params["scale"]
        return (x - state["mean"]) * inv + params["bias"]
    axes = tuple(range(x.dim() - 1))
    mean = torch.mean(x, axes)
    centred = x - mean
    var = torch.mean(centred * centred, axes)
    new_state = {"mean": momentum * state["mean"] + (1 - momentum) * mean,
                 "var": momentum * state["var"] + (1 - momentum) * var}
    inv = torch.rsqrt(var + eps) * params["scale"]
    return (x - mean) * inv + params["bias"], new_state


def leaky_relu(x: torch.Tensor, alpha: float = LEAKY_ALPHA) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def max_pool3d(x: torch.Tensor, pool: Sequence[int]) -> torch.Tensor:
    """VALID max-pool of (b, z, y, x, c) with window == stride == pool:
    ``F.max_pool3d``, whose gradient goes to the first maximum of a window
    in (z, y, x) order, as XLA's select-and-scatter does for JAX's
    ``reduce_window`` max (``amax`` would split a tie)."""
    return F.max_pool3d(x.permute(0, 4, 1, 2, 3), tuple(int(p) for p in pool)
                        ).permute(0, 2, 3, 4, 1)


def upsample3d(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour upsampling (Keras UpSampling3D)."""
    for axis, s in zip((1, 2, 3), size):
        if s > 1:
            x = torch.repeat_interleave(x, int(s), dim=axis)
    return x


def dense(params: Params, x: torch.Tensor,
          compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ w (+ b)`` in ``compute_dtype`` (module docstring)."""
    w = params["w"]
    if check_compute_dtype(compute_dtype):
        x, w = round_bf16(x), round_bf16(w)
    y = torch.matmul(x, w)
    b: Optional[torch.Tensor] = params.get("b")
    return y + b if b is not None else y
