"""3-D U-Net family of the legacy v0.4 path (counterpart of
``3deecelltracker_tpu/models/unet3d.py``: ``UNet3D``, ``unet3_a``/``b``/
``c``).

Blocks are conv3x3x3 -> activation -> eval-mode BatchNorm (BN after the
activation, as the reference blocks do).  Down levels pool after their two
blocks; up levels transform, upsample and concatenate the skip; head blocks
run at full resolution; a 1x1x1 conv + sigmoid gives the cell probability.
Layout (b, x, y, z, c), weights DHWIO; params ``{name: {"conv": {"w", "b"},
"bn": {"scale", "bias"}}, "out": {"conv": ...}}`` and state ``{name:
{"mean", "var"}}``, keyed like the JAX pytree.  Every 3x3x3 conv is a
hand-written CUDA kernel (``ops.hopper_conv``) without its ReLU; the
activation and BN stay in PyTorch, and the 1x1x1 output conv is a product.
``apply(compute_dtype=torch.bfloat16)`` runs every conv block and the
output conv in bf16 (``layers.conv3d``), the rest in f32, as JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from ..utils.device import select_device
from . import layers as L

Params = Dict[str, Any]
State = Dict[str, Any]

STANDIN_GAIN = 8.0   # logit per LCN unit of the stand-in's output conv


@dataclasses.dataclass(frozen=True)
class UNet3D:
    """Static architecture spec; parameters live in separate dicts."""
    variant: str = "a"                      # 'a' | 'b' | 'c'
    tile_shape: Tuple[int, int, int] = (160, 160, 16)
    pool: Tuple[int, int, int] = (2, 2, 1)
    depth: int = 3
    down_filters: Tuple[Tuple[int, int], ...] = ((8, 16), (16, 32), (32, 64))
    up_filters: Tuple[Tuple[int, int], ...] = ((64, 64), (32, 32), (16, 16))
    head_filters: Tuple[int, ...] = (8, 8)
    activation: str = "leaky_relu"          # 'leaky_relu' | 'relu'

    def block_plan(self, c_in: int = 1
                   ) -> Tuple[List[Tuple[str, int, int]], int]:
        """(ordered (name, c_in, c_out) of every conv block, channels into
        the output conv)."""
        plan = []
        c = c_in
        skips: List[int] = []
        for lvl, (f1, f2) in enumerate(self.down_filters):
            plan += [(f"down{lvl}_0", c, f1), (f"down{lvl}_1", f1, f2)]
            c = f2
            skips.append(f2)
        for i, (f1, f2) in enumerate(self.up_filters):
            plan += [(f"up{i}_0", c, f1), (f"up{i}_1", f1, f2)]
            c = f2 + skips[len(self.up_filters) - 1 - i]
        for i, f in enumerate(self.head_filters):
            plan.append((f"head{i}", c, f))
            c = f
        return plan, c

    def init(self, generator: torch.Generator, c_in: int = 1,
             device=None) -> Tuple[Params, State]:
        """Seeded glorot convs and identity BatchNorms (not JAX's numbers;
        parity tests carry weights across with ``utils.convert``).
        ``device=None`` is the card."""
        device = select_device(device)
        params: Params = {}
        state: State = {}
        plan, c_last = self.block_plan(c_in)
        for name, cin, cout in plan:
            params[name] = {
                "conv": L.init_conv3d((3, 3, 3), cin, cout, generator,
                                      device),
                "bn": {"scale": torch.ones(cout, device=device),
                       "bias": torch.zeros(cout, device=device)}}
            state[name] = {"mean": torch.zeros(cout, device=device),
                           "var": torch.ones(cout, device=device)}
        params["out"] = {"conv": L.init_conv3d((1, 1, 1), c_last, 1,
                                               generator, device)}
        return params, state

    def apply(self, params: Params, state: State, x: torch.Tensor,
              train: bool = False, compute_dtype=torch.float32):
        """Forward: x (b, x, y, z, c) -> sigmoid probabilities (b, x, y, z,
        1) in float32; every conv computes in ``compute_dtype`` (JAX
        ``models/unet3d.py:80-116``).  Eval mode (BatchNorm from the running
        statistics) returns the probabilities; ``train=True`` (BatchNorm
        from the batch, running statistics moved as JAX's ``layers.
        batchnorm`` moves them) returns ``(probs, new_state)``."""
        act = L.leaky_relu if self.activation == "leaky_relu" else torch.relu
        new_state: State = {}

        def block(name, h):
            h = act(L.conv3d(params[name]["conv"], h, compute_dtype))
            if not train:
                return L.batchnorm(params[name]["bn"], state[name], h)
            h, new_state[name] = L.batchnorm(params[name]["bn"],
                                             state[name], h, train=True)
            return h

        skips = []
        h = x
        for lvl in range(len(self.down_filters)):
            h = block(f"down{lvl}_1", block(f"down{lvl}_0", h))
            skips.append(h)
            h = L.max_pool3d(h, self.pool)
        for i in range(len(self.up_filters)):
            h = block(f"up{i}_1", block(f"up{i}_0", h))
            h = L.upsample3d(h, self.pool)
            h = torch.cat([h, skips[len(self.up_filters) - 1 - i]], dim=-1)
        for i in range(len(self.head_filters)):
            h = block(f"head{i}", h)
        probs = torch.sigmoid(L.conv3d(params["out"]["conv"], h,
                                       compute_dtype))
        return (probs, new_state) if train else probs

    def receptive_radius(self) -> Tuple[int, int, int]:
        """Per-axis receptive radius of :meth:`apply` (JAX
        ``models/unet3d.py:117-137``): an output voxel farther than this
        from a region's boundary is unaffected by anything beyond it.  Two
        3^3 convs per down level (+1 each at that level's stride), its pool
        window (+(pool - 1) * stride), two convs per up level before its
        upsample, and the full-resolution head convs."""
        n_levels = len(self.down_filters)
        radii = []
        for d in range(3):
            p = self.pool[d]
            r = 0
            for lvl in range(n_levels):
                r += 2 * p ** lvl + (p - 1) * p ** lvl
            for i in range(len(self.up_filters)):
                r += 2 * p ** (n_levels - i)
            radii.append(r + len(self.head_filters))
        return tuple(radii)


def unet3_a() -> UNet3D:
    """Reference ``unet3_a`` (unet3d.py:26-37)."""
    return UNet3D(variant="a", tile_shape=(160, 160, 16), pool=(2, 2, 1),
                  down_filters=((8, 16), (16, 32), (32, 64)),
                  up_filters=((64, 64), (32, 32), (16, 16)),
                  head_filters=(8, 8), activation="leaky_relu")


def unet3_b() -> UNet3D:
    """Reference ``unet3_b`` (unet3d.py:40-67)."""
    return UNet3D(variant="b", tile_shape=(96, 96, 8), pool=(2, 2, 1),
                  down_filters=((64, 64), (128, 128)),
                  up_filters=((256, 256), (128, 128)),
                  head_filters=(64, 64), activation="relu")


def unet3_c() -> UNet3D:
    """Reference ``unet3_c`` (unet3d.py:70-81)."""
    return UNet3D(variant="c", tile_shape=(64, 64, 64), pool=(2, 2, 2),
                  down_filters=((8, 16), (16, 32), (32, 64)),
                  up_filters=((64, 64), (32, 32), (16, 16)),
                  head_filters=(8, 8), activation="leaky_relu")


def get_unet(variant: str) -> UNet3D:
    return {"a": unet3_a, "b": unet3_b, "c": unet3_c}[variant]()


def with_intensity_path(params: Params, spec: UNet3D,
                        threshold: float = 1.0) -> Params:
    """Copy of ``params`` whose probability follows the normalized
    intensity: ``down0_0``/``down0_1`` pass input channel 0 to output
    channel 0 through the centre tap (that channel's other weights and its
    bias zeroed), the head convs read only that skip channel (all other
    head weights zero), and the 1x1x1 output maps it to the logit
    ``STANDIN_GAIN * (h - threshold)``, so a voxel is a cell (probability
    > 0.5) where its LCN value exceeds ``threshold`` (up to the BatchNorms'
    1/sqrt(1 + eps) per block).  Every other weight keeps its seeded random
    value and still computes, so the time per volume is real.  It stands in
    for trained weights in random-weight runs (tests, the chip smoke run)."""
    out = {name: {part: {k: v.clone() for k, v in layer.items()}
                  for part, layer in blocks.items()}
           for name, blocks in params.items()}
    skip0 = spec.up_filters[-1][1]     # skip 0 follows the last up output
    heads = [f"head{i}" for i in range(len(spec.head_filters))]
    for name in ("down0_0", "down0_1", *heads):
        w, b = out[name]["conv"]["w"], out[name]["conv"]["b"]
        if name.startswith("head"):
            w.zero_()
            b.zero_()
        else:
            w[..., 0] = 0.0
            b[0] = 0.0
        w[1, 1, 1, skip0 if name == "head0" else 0, 0] = 1.0
    w, b = out["out"]["conv"]["w"], out["out"]["conv"]["b"]
    w.zero_()
    w[0, 0, 0, 0, 0] = STANDIN_GAIN
    b.fill_(-STANDIN_GAIN * threshold)
    return out
