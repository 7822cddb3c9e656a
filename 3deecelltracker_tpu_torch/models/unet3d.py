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
``apply(compute_dtype=torch.bfloat16)`` computes every conv block and the
output conv in bf16 as JAX's: at inference each block is one kernel launch
(``layers.conv_block_bf16``: conv, activation and BN in its epilogue) whose
output is stored in bf16, as JAX's next conv rounds it, and activations
stay bf16 through pools, upsampling and concatenation (rounding to nearest
is monotone, so it commutes with them; ``pool_max`` and ``upsample_cat``
do them channels-last, without the copies of ``layers.max_pool3d``,
``upsample3d`` and ``torch.cat``); training keeps JAX's f32 route.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from ..ops.hopper_conv import check_compute_dtype
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

    def init(self, generator: torch.Generator, c_in: int = 1, *,
             device=None) -> Tuple[Params, State]:
        """Seeded glorot convs and identity BatchNorms (not JAX's numbers;
        parity tests carry weights across with ``utils.convert``).
        ``device=None`` is the card."""
        device = select_device(device)
        params: Params = {}
        state: State = {}
        plan, c_last = self.block_plan(c_in)
        for name, cin, cout in plan:
            bn, state[name] = L.init_bn(cout, device=device)
            params[name] = {"conv": L.init_conv3d(generator, (3, 3, 3), cin,
                                                  cout, device=device),
                            "bn": bn}
        params["out"] = {"conv": L.init_conv3d(generator, (1, 1, 1), c_last,
                                               1, device=device)}
        return params, state

    def apply(self, params: Params, state: State, x: torch.Tensor,
              train: bool = False, compute_dtype=torch.float32, *,
              mesh_axes=None):
        """Forward: x (b, x, y, z, c) -> sigmoid probabilities (b, x, y, z,
        1) in float32; every conv computes in ``compute_dtype`` (JAX
        ``models/unet3d.py:80-116``).  Eval mode (BatchNorm from the running
        statistics) returns the probabilities, in bfloat16 through
        ``layers.conv_block_bf16`` with bf16 activations; ``train=True``
        (BatchNorm from the batch, running statistics moved as JAX's
        ``layers.batchnorm`` moves them) returns ``(probs, new_state)``.

        ``mesh_axes`` (``train=True``): ``(batch, spatial)``, ``x`` this
        rank's block of a batch split over mesh axes
        (``parallel.mesh.MeshAxis``): ``batch`` holds every rank with a
        part of the batch (the BatchNorms' statistics are summed over it),
        ``spatial`` the ranks that x (dim 1) is split over, or None (each
        3x3x3 conv takes one halo plane from its neighbours); pools, upsampling and
        the 1x1x1 conv stay local, so the x shard must be a multiple of the
        product of the x pool factors over the down levels."""
        act = L.leaky_relu if self.activation == "leaky_relu" else torch.relu
        new_state: State = {}
        fused = check_compute_dtype(compute_dtype) and not train
        stats = spatial = None
        if mesh_axes is not None:
            if not train:
                raise ValueError("mesh_axes is for train=True")
            stats, spatial = mesh_axes
            if spatial is not None:
                self.check_x_shard(int(x.shape[1]), spatial.size)

        def block(name, h):
            if fused:
                return L.conv_block_bf16(params[name]["conv"],
                                         params[name]["bn"], state[name], h,
                                         self.activation)
            h = act(L.conv3d(params[name]["conv"], h, compute_dtype,
                             spatial=spatial))
            if not train:
                return L.batchnorm(params[name]["bn"], state[name], h, False)
            h, new_state[name] = L.batchnorm(params[name]["bn"],
                                             state[name], h, train=True,
                                             group=stats)
            return h

        pool = pool_max if fused else L.max_pool3d
        skips = []
        h = x
        for lvl in range(len(self.down_filters)):
            h = block(f"down{lvl}_1", block(f"down{lvl}_0", h))
            skips.append(h)
            h = pool(h, self.pool)
        for i in range(len(self.up_filters)):
            h = block(f"up{i}_1", block(f"up{i}_0", h))
            skip = skips[len(self.up_filters) - 1 - i]
            if fused:
                h = upsample_cat(h, skip, self.pool)
                continue
            h = L.upsample3d(h, self.pool)
            h = torch.cat([h, skip], dim=-1)
        for i in range(len(self.head_filters)):
            h = block(f"head{i}", h)
        probs = torch.sigmoid(L.conv3d(params["out"]["conv"], h,
                                       compute_dtype))
        return (probs, new_state) if train else probs

    def check_x_shard(self, shard: int, n: int) -> None:
        """Raise ``ValueError`` unless an x shard of ``shard`` voxels (a
        tile x of ``shard * n`` over ``n`` ranks) pools without a halo:
        a multiple of the x pool factors' product over the down levels."""
        f = self.pool[0] ** len(self.down_filters)
        if shard % f:
            raise ValueError(
                f"the x shard {shard} (tile x {shard * n} over {n} spatial "
                f"ranks) is not a multiple of {f}, the product of the x "
                f"pool factors {self.pool[0]} over "
                f"{len(self.down_filters)} down levels")

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


def pool_max(h: torch.Tensor, pool) -> torch.Tensor:
    """VALID max-pool of a (b, x, y, z, c) tensor with window == stride ==
    ``pool``, as one reduction over its channels-last windows: the values
    of ``layers.max_pool3d`` without its gradient (the bf16 inference
    path's; ``F.max_pool3d`` would copy to channels-first and back)."""
    b, c = h.shape[0], h.shape[-1]
    n = [s // p for s, p in zip(h.shape[1:4], pool)]
    h = h[:, :n[0] * pool[0], :n[1] * pool[1], :n[2] * pool[2]]
    return h.reshape(b, n[0], pool[0], n[1], pool[1], n[2], pool[2],
                     c).amax(dim=(2, 4, 6))


def upsample_cat(h: torch.Tensor, skip: torch.Tensor, pool) -> torch.Tensor:
    """``torch.cat([layers.upsample3d(h, pool), skip], -1)`` written into
    one buffer, the nearest upsampling a broadcast copy (the bf16
    inference path's)."""
    b, x, y, z, c = h.shape
    out = h.new_empty((b, x * pool[0], y * pool[1], z * pool[2],
                       c + skip.shape[-1]))
    out[..., c:] = skip
    out.view(b, x, pool[0], y, pool[1], z, pool[2], -1)[..., :c] = \
        h[:, :, None, :, None, :, None]
    return out


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
