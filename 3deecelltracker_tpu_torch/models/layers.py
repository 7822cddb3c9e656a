"""Functional NN building blocks on channels-last tensors.

Counterpart of ``3deecelltracker_tpu/models/layers.py``: 'same' convs,
eval-mode BatchNorm (eps 1e-3), LeakyReLU alpha 0.3, nearest upsampling.
Layouts are the JAX package's: (b, z, y, x, c) activations, DHWIO conv
weights, (d_in, d_out) dense weights.  Every 3x3x3 conv goes through the
hand-written CUDA kernel (``ops.hopper_conv``) with bias and ReLU fused;
1x1x1 convs are a plain matmul.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from ..ops.hopper_conv import conv3x3x3_bias_relu

Params = Dict[str, torch.Tensor]

LEAKY_ALPHA = 0.3
BN_EPS = 1e-3


def glorot_uniform(shape: Sequence[int], fan_in: int, fan_out: int,
                   generator: torch.Generator,
                   device=None) -> torch.Tensor:
    """Seeded glorot-uniform init.  It does not reproduce JAX's numbers:
    parity tests carry weights across with ``utils.convert`` instead."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * limit).to(device)


def init_conv3d(kernel: Sequence[int], c_in: int, c_out: int,
                generator: torch.Generator, device=None) -> Params:
    rf = int(math.prod(kernel))
    w = glorot_uniform((*kernel, c_in, c_out), rf * c_in, rf * c_out,
                       generator, device)
    return {"w": w, "b": torch.zeros((c_out,), dtype=torch.float32,
                                     device=device)}


def conv3d(params: Params, x: torch.Tensor, relu: bool = False
           ) -> torch.Tensor:
    """SAME conv of (b, z, y, x, c_in) with DHWIO weights, + bias, with an
    optional fused ReLU.  3x3x3 kernels run the CUDA kernel per batch item;
    1x1x1 kernels are a matmul over channels."""
    w = params["w"]
    b = params.get("b")
    if b is None:
        b = torch.zeros((w.shape[-1],), dtype=torch.float32, device=w.device)
    k = tuple(w.shape[:3])
    if k == (1, 1, 1):
        y = torch.matmul(x, w.reshape(w.shape[3], w.shape[4])) + b
        return torch.relu(y) if relu else y
    if k != (3, 3, 3):
        raise NotImplementedError(f"conv kernel {k}")
    return torch.stack([conv3x3x3_bias_relu(xi.contiguous(), w, b, relu)
                        for xi in x])


def batchnorm(params: Params, state: Params, x: torch.Tensor,
              eps: float = BN_EPS) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis."""
    inv = torch.rsqrt(state["var"] + eps) * params["scale"]
    return (x - state["mean"]) * inv + params["bias"]


def leaky_relu(x: torch.Tensor, alpha: float = LEAKY_ALPHA) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def max_pool3d(x: torch.Tensor, pool: Sequence[int]) -> torch.Tensor:
    """VALID max-pool of (b, z, y, x, c) with window == stride == pool."""
    b, z, y, xl, c = x.shape
    pz, py, px = (int(p) for p in pool)
    x = x[:, :z // pz * pz, :y // py * py, :xl // px * px]
    x = x.reshape(b, z // pz, pz, y // py, py, xl // px, px, c)
    return x.amax(dim=(2, 4, 6))


def upsample3d(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour upsampling (Keras UpSampling3D)."""
    for axis, s in zip((1, 2, 3), size):
        if s > 1:
            x = torch.repeat_interleave(x, int(s), dim=axis)
    return x


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, params["w"])
    b: Optional[torch.Tensor] = params.get("b")
    return y + b if b is not None else y
