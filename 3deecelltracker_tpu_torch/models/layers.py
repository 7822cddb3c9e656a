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
concatenation stay f32.  :func:`conv_block_bf16` is the legacy U-Net's
inference block in bf16 (conv, activation and eval-mode BatchNorm in f32,
the output rounded to bf16, which is what the next bf16 conv reads): one
launch of a kernel with all of it in its epilogue.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.hopper_conv import (LEAKY_ALPHA, Conv3x3x3BiasReLU,
                               check_compute_dtype, conv3x3x3_block_bf16,
                               round_bf16)
from ..parallel.comm import all_reduce_sum, halo_extend
from ..parallel.mesh import MeshAxis
from ..utils.device import select_device

Params = Dict[str, torch.Tensor]

BN_MOMENTUM = 0.99
BN_EPS = 1e-3


def glorot_uniform(generator: torch.Generator, shape: Sequence[int],
                   fan_in: int, fan_out: int, dtype=torch.float32, *,
                   device=None) -> torch.Tensor:
    """Seeded glorot-uniform init, drawn in float32 and cast to ``dtype``.
    It does not reproduce JAX's numbers: parity tests carry weights across
    with ``utils.convert`` instead.  ``device=None`` is the card
    (``utils.device.select_device``)."""
    device = select_device(device)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * limit).to(device=device, dtype=dtype)


def init_conv3d(generator: torch.Generator, kernel: Sequence[int],
                c_in: int, c_out: int, use_bias: bool = True, *,
                device=None) -> Params:
    """``{"w": (*kernel, c_in, c_out) glorot[, "b": zeros]}``."""
    device = select_device(device)
    rf = int(math.prod(kernel))
    p = {"w": glorot_uniform(generator, (*kernel, c_in, c_out), rf * c_in,
                             rf * c_out, device=device)}
    if use_bias:
        p["b"] = torch.zeros((c_out,), dtype=torch.float32, device=device)
    return p


def init_bn(c: int, *, device=None) -> Tuple[Params, Params]:
    """Identity batchnorm over ``c`` channels: ``({"scale", "bias"},
    {"mean", "var"})``."""
    device = select_device(device)
    return ({"scale": torch.ones(c, device=device),
             "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device),
             "var": torch.ones(c, device=device)})


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               use_bias: bool = True, *, device=None) -> Params:
    """``{"w": (d_in, d_out) glorot[, "b": zeros]}``."""
    device = select_device(device)
    p = {"w": glorot_uniform(generator, (d_in, d_out), d_in, d_out,
                             device=device)}
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def conv3d(params: Params, x: torch.Tensor, compute_dtype=torch.float32, *,
           relu: bool = False, spatial: Optional[MeshAxis] = None
           ) -> torch.Tensor:
    """SAME conv of (b, z, y, x, c_in) with DHWIO weights, + bias, with an
    optional fused ReLU, in ``compute_dtype`` (module docstring).  3x3x3
    kernels run a CUDA kernel, one launch for the whole batch (with a
    gradient under autograd in float32); 1x1x1 kernels are a matmul over
    channels.  ``spatial``: the mesh axis that dim 1 is split over; a
    3x3x3 conv then extends the local shard by one plane from each
    neighbour (``parallel.comm.halo_extend``, zeros past the ends; the
    gradient goes back), runs the kernel on the extended shard and crops
    the two extra output planes: the SAME conv of the whole tensor, this
    rank's block of it."""
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
    if spatial is not None:
        y = Conv3x3x3BiasReLU.apply(halo_extend(spatial, x, 1).contiguous(),
                                    w, b, relu, compute_dtype)
        return y[:, 1:-1]
    return Conv3x3x3BiasReLU.apply(x.contiguous(), w, b, relu, compute_dtype)


def batchnorm(params: Params, state: Params, x: torch.Tensor,
              train: bool, momentum: float = BN_MOMENTUM,
              eps: float = BN_EPS, *, group: Optional[MeshAxis] = None):
    """BatchNorm over the last axis.  Eval mode returns ``y`` from the
    running statistics; ``train=True`` returns ``(y, new_state)``: ``y``
    from the batch's mean and population variance (``jnp.var``'s, the
    mean of the centred squares) and the running statistics moved by
    ``momentum`` as JAX's ``layers.batchnorm`` does.  ``group``: the mesh
    axis over whose ranks the batch is split; the batch's sum and element
    count, then its sum of centred squares, are summed over it (with their
    gradient), so every rank normalizes by the whole batch's statistics
    and moves the same running ones."""
    if not train:
        inv = torch.rsqrt(state["var"] + eps) * params["scale"]
        return (x - state["mean"]) * inv + params["bias"]
    axes = tuple(range(x.dim() - 1))
    if group is None:
        mean = torch.mean(x, axes)
        centred = x - mean
        var = torch.mean(centred * centred, axes)
    else:
        c = x.shape[-1]
        local = torch.cat([torch.sum(x, axes),
                           x.new_full((1,), float(x.numel() // c))])
        total = all_reduce_sum(group, local)
        count = total[c]
        mean = total[:c] / count
        centred = x - mean
        var = all_reduce_sum(group, torch.sum(centred * centred, axes)) \
            / count
    new_state = {"mean": momentum * state["mean"] + (1 - momentum) * mean,
                 "var": momentum * state["var"] + (1 - momentum) * var}
    inv = torch.rsqrt(var + eps) * params["scale"]
    return (x - mean) * inv + params["bias"], new_state


def conv_block_bf16(conv: Params, bn: Params, state: Params,
                    x: torch.Tensor, activation=None,
                    eps: float = BN_EPS) -> torch.Tensor:
    """The legacy U-Net's block at inference in bf16, JAX's ``conv3d(...,
    bfloat16) -> act -> batchnorm(train=False)`` followed by the rounding
    to bf16 that JAX's next conv makes: ``(b, z, y, x, c_in)`` bf16 (or
    f32) -> ``(b, z, y, x, c_out)`` bf16.  BatchNorm's ``inv`` is
    :func:`batchnorm`'s expression; ``activation`` None, ``"relu"`` or
    ``"leaky_relu"``.  A 3x3x3 conv, one launch of
    ``ops.hopper_conv.conv3x3x3_block_bf16`` (its plain version on the
    CPU); no gradient."""
    w = conv["w"]
    if tuple(w.shape[:3]) != (3, 3, 3):
        raise NotImplementedError(f"conv block kernel {tuple(w.shape[:3])}")
    b = conv.get("b")
    if b is None:
        b = torch.zeros((w.shape[-1],), dtype=torch.float32, device=w.device)
    inv = torch.rsqrt(state["var"] + eps) * bn["scale"]
    return conv3x3x3_block_bf16(x.contiguous(), w, b, state["mean"], inv,
                                bn["bias"], activation)


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
