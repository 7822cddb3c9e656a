"""StarDist3D network (arch ``"tpu"`` or ``"keras"``) and the sparse
candidate gather.

Counterpart of ``3deecelltracker_tpu/models/stardist3d.py`` (:33-290 and
:340-427).  Arch ``"tpu"``: grid max-pool before the stem, a
depth-``unet_n_depth`` U-Net of 3x3x3 conv+ReLU layers, a 3x3x3 feature
conv and 1x1x1 prob/dist heads at grid resolution.  Arch ``"keras"``: the
topology of the stardist-0.8 / csbdeep Keras model the reference wraps,
which every pretrained reference checkpoint has: conv blocks at full
resolution before each grid pool, csbdeep's filter schedule (the last conv
of the middle and up blocks at half width) and upsample -> concat([up,
skip]) -> convs.  Layout (b, z, y, x, c); params are a flat dict keyed like
the JAX pytree (``"stem"``, ``"down0_0"``, ``"pre0_0"``, ...), each
``{"w", "b"}``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..config import StarDistConfig
from ..utils.device import select_device
from . import layers as L

Params = Dict[str, Dict[str, torch.Tensor]]

ARCHS = ("tpu", "keras")


@dataclasses.dataclass(frozen=True)
class StarDist3DNet:
    """``arch``: ``"tpu"`` (default) or ``"keras"`` (the reference's Keras
    topology, for checkpoints imported with ``utils.keras_import``).

    ``fused_up``: the JAX twin's sub-pixel phase decomposition of the "tpu"
    up-blocks' first conv, which computes the same network in another XLA
    layout (JAX ``models/stardist3d.py:49-55``).  The port's conv kernels
    take the upsampled, concatenated input either way, so ``True`` and
    ``False`` run the same network here."""
    config: StarDistConfig
    arch: str = "tpu"
    fused_up: bool = False

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"arch must be 'tpu' or 'keras', got "
                             f"{self.arch!r}")

    # ---- the Keras topology's layer plan ---------------------------------
    def _keras_pools(self):
        """Pooling steps that bring full resolution down to ``grid``
        (stardist model3d: ``pool = 1 + (grid > pooled)`` loop)."""
        grid = tuple(self.config.grid)
        for g in grid:
            if g < 1 or (g & (g - 1)) != 0:
                raise ValueError(
                    f"grid entries must be powers of 2, got {grid!r} "
                    "(the pooling schedule doubles until it equals grid)")
        pooled = (1, 1, 1)
        pools = []
        while pooled != grid:
            pool = tuple(2 if g > p else 1 for g, p in zip(grid, pooled))
            pooled = tuple(p * q for p, q in zip(pooled, pool))
            pools.append(pool)
        return pools

    def _keras_plan(self):
        """Ordered (name, c_in, c_out, kernel) conv specs in Keras creation
        order, the order of the weights in a saved ``.h5``."""
        cfg = self.config
        base, k = cfg.unet_n_filter_base, tuple(cfg.unet_kernel_size)
        ncv, depth = cfg.unet_n_conv_per_depth, cfg.unet_n_depth
        plan = []
        c = cfg.n_channel_in
        for step, _pool in enumerate(self._keras_pools()):
            for i in range(ncv):
                plan.append((f"pre{step}_{i}", c, base, k))
                c = base
        for n in range(depth):
            for i in range(ncv):
                plan.append((f"down{n}_{i}", c, base * 2 ** n, k))
                c = base * 2 ** n
        for i in range(ncv - 1):
            plan.append((f"middle{i}", c, base * 2 ** depth, k))
            c = base * 2 ** depth
        plan.append((f"middle{ncv - 1}", c, base * 2 ** max(0, depth - 1), k))
        c = base * 2 ** max(0, depth - 1)
        for n in reversed(range(depth)):
            c = c + base * 2 ** n            # concat with the level-n skip
            for i in range(ncv - 1):
                plan.append((f"up{n}_{i}", c, base * 2 ** n, k))
                c = base * 2 ** n
            plan.append((f"up{n}_{ncv - 1}", c, base * 2 ** max(0, n - 1), k))
            c = base * 2 ** max(0, n - 1)
        plan.append(("features", c, cfg.net_conv_after_unet, k))
        plan.append(("prob_head", cfg.net_conv_after_unet, 1, (1, 1, 1)))
        plan.append(("dist_head", cfg.net_conv_after_unet, cfg.n_rays,
                     (1, 1, 1)))
        return plan

    def conv_plan(self):
        """Ordered (name, c_in, c_out, kernel) of every conv layer of this
        arch (for ``"keras"``, :meth:`_keras_plan`)."""
        if self.arch == "keras":
            return self._keras_plan()
        cfg = self.config
        k = tuple(cfg.unet_kernel_size)
        ncv = cfg.unet_n_conv_per_depth
        f = cfg.unet_n_filter_base
        filters = [f * (2 ** lvl) for lvl in range(cfg.unet_n_depth + 1)]
        plan = [("stem", cfg.n_channel_in, f, k)]
        c = f
        for lvl in range(cfg.unet_n_depth):
            for i in range(ncv):
                plan.append((f"down{lvl}_{i}", c, filters[lvl], k))
                c = filters[lvl]
        for i in range(ncv):
            plan.append((f"bottom_{i}", c, filters[-1], k))
            c = filters[-1]
        for lvl in reversed(range(cfg.unet_n_depth)):
            for i in range(ncv):
                plan.append((f"up{lvl}_{i}",
                             (c + filters[lvl]) if i == 0 else filters[lvl],
                             filters[lvl], k))
            c = filters[lvl]
        plan.append(("features", c, cfg.net_conv_after_unet, k))
        plan.append(("prob_head", cfg.net_conv_after_unet, 1, (1, 1, 1)))
        plan.append(("dist_head", cfg.net_conv_after_unet, cfg.n_rays,
                     (1, 1, 1)))
        return plan

    def init(self, generator: torch.Generator, *, device=None) -> Params:
        """Seeded glorot init (not JAX's numbers; see ``layers``);
        ``device=None`` is the card."""
        device = select_device(device)
        return {name: L.init_conv3d(generator, kernel, cin, cout,
                                    device=device)
                for name, cin, cout, kernel in self.conv_plan()}

    def apply(self, params: Params, x: torch.Tensor,
              compute_dtype=torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (b, z, y, x, c) -> (prob (b, z/g, y/g, x/g, 1),
        dist (b, ..., n_rays)).  Spatial dims must be divisible by
        ``div_by``.  Every conv computes in ``compute_dtype`` (JAX's
        default float32; ``torch.bfloat16`` as ``layers.conv3d``)."""
        if self.arch == "keras":
            return self._apply_keras(params, x, compute_dtype)
        cfg = self.config

        def conv(name, h):
            return L.conv3d(params[name], h, compute_dtype, relu=True)

        h = x
        if any(g > 1 for g in cfg.grid):
            h = L.max_pool3d(h, cfg.grid)
        h = conv("stem", h)
        skips = []
        ncv = cfg.unet_n_conv_per_depth
        for lvl in range(cfg.unet_n_depth):
            for i in range(ncv):
                h = conv(f"down{lvl}_{i}", h)
            skips.append(h)
            h = L.max_pool3d(h, cfg.unet_pool)
        for i in range(ncv):
            h = conv(f"bottom_{i}", h)
        for lvl in reversed(range(cfg.unet_n_depth)):
            h = L.upsample3d(h, cfg.unet_pool)
            h = torch.cat([h, skips[lvl]], dim=-1)
            for i in range(ncv):
                h = conv(f"up{lvl}_{i}", h)
        return self._heads(params, conv("features", h), compute_dtype)

    def _apply_keras(self, params: Params, x: torch.Tensor,
                     compute_dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The Keras topology's forward (JAX ``_apply_keras``): pre-grid
        conv blocks and grid pools, down, middle, then upsample ->
        concat([up, skip]) -> convs; the same (prob, dist) at grid
        resolution as arch ``"tpu"``."""
        cfg = self.config

        def conv(name, h):
            return L.conv3d(params[name], h, compute_dtype, relu=True)

        ncv, depth = cfg.unet_n_conv_per_depth, cfg.unet_n_depth
        h = x
        for step, pool in enumerate(self._keras_pools()):
            for i in range(ncv):
                h = conv(f"pre{step}_{i}", h)
            h = L.max_pool3d(h, pool)
        skips = []
        for n in range(depth):
            for i in range(ncv):
                h = conv(f"down{n}_{i}", h)
            skips.append(h)
            h = L.max_pool3d(h, cfg.unet_pool)
        for i in range(ncv):
            h = conv(f"middle{i}", h)
        for n in reversed(range(depth)):
            h = L.upsample3d(h, cfg.unet_pool)
            h = torch.cat([h, skips[n]], dim=-1)
            for i in range(ncv):
                h = conv(f"up{n}_{i}", h)
        return self._heads(params, conv("features", h), compute_dtype)

    @staticmethod
    def _heads(params: Params, feat: torch.Tensor,
               compute_dtype=torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        prob = torch.sigmoid(L.conv3d(params["prob_head"], feat,
                                      compute_dtype))
        return prob, L.conv3d(params["dist_head"], feat, compute_dtype)

    @property
    def div_by(self) -> Tuple[int, int, int]:
        cfg = self.config
        return tuple(g * p ** cfg.unet_n_depth
                     for g, p in zip(cfg.grid, cfg.unet_pool))

    def receptive_field(self) -> Tuple[int, int, int]:
        """Per-axis receptive-field radius of the (prob, dist) outputs in
        input voxels (JAX ``StarDist3DNet.receptive_field``): an output
        voxel depends only on inputs within it, so tiles with a shrink
        margin at least this wide reproduce the whole-volume outputs in
        their centres.  A conv of kernel k at jump j widens the radius by
        (k // 2) * j; a p-pool adds (p - 1) * j and multiplies the jump; a
        nearest upsample divides it and adds (p - 1) fine voxels of
        alignment slack."""
        cfg = self.config
        k = tuple(cfg.unet_kernel_size)
        ncv = cfg.unet_n_conv_per_depth
        j, r = [1, 1, 1], [0, 0, 0]

        def convs(n):
            for ax in range(3):
                r[ax] += n * (k[ax] // 2) * j[ax]

        def pool(p):
            for ax in range(3):
                r[ax] += (p[ax] - 1) * j[ax]
                j[ax] *= p[ax]

        def upsample(p):
            for ax in range(3):
                j[ax] //= p[ax]
                r[ax] += (p[ax] - 1) * j[ax]

        if self.arch == "keras":
            for p in self._keras_pools():     # pre-grid blocks, grid pools
                convs(ncv)
                pool(p)
        else:
            pool(cfg.grid)                    # the grid max-pool, the stem
            convs(1)
        for _ in range(cfg.unet_n_depth):
            convs(ncv)
            pool(cfg.unet_pool)
        convs(ncv)                        # bottom / middle
        for _ in range(cfg.unet_n_depth):
            upsample(cfg.unet_pool)
            convs(ncv)
        convs(1)                          # features
        return tuple(int(v) for v in r)


def _pass_through(params: Params, config: StarDistConfig,
                  arch: str) -> Params:
    """A copy of ``params`` with every weight scaled by 0.05 and the
    pass-through path of :func:`with_intensity_path` added along the
    ``arch`` plan.  Both archs concatenate the skip after the upsampled
    tensor, so an up block's first conv reads the skip's channel 0 at
    index ``cin - base * 2**level``."""
    f = config.unet_n_filter_base
    out = {name: {k: v.clone() for k, v in layer.items()}
           for name, layer in params.items()}
    for name, cin, cout, kernel in StarDist3DNet(config, arch).conv_plan():
        w, b = out[name]["w"], out[name]["b"]
        w.mul_(0.05)
        if name == "prob_head":
            w.zero_()
            w[0, 0, 0, 0, 0] = 12.0
            b.fill_(-6.0)
        elif name == "dist_head":
            b.fill_(3.0)
        else:
            src = 0
            if name.startswith("up") and name.endswith("_0"):
                src = cin - f * 2 ** int(name[2:name.index("_")])
            w[1, 1, 1, src, 0] += 1.0
    return out


def with_intensity_path(params: Params, config: StarDistConfig) -> Params:
    """Copy of arch ``"tpu"`` ``params`` with a pass-through path added:
    all weights are scaled by 0.05, every 3x3x3 layer's centre tap then
    maps input channel 0 (for the first up conv, the skip's channel 0) to
    output channel 0 with weight +1, the prob head reads
    ``sigmoid(12 * ch0 - 6)`` and the dist head's bias is 3 (voxels).  The
    normalized background (~0.05) then scores ~0.005 and a cell's peak
    (~1) ~0.998.  On a normalized microscopy volume the detections then
    follow the bright cells, which gives random-weight runs (tests, the
    chip smoke run) a realistic candidate count without trained weights."""
    return _pass_through(params, config, "tpu")


def with_keras_intensity_path(params: Params,
                              config: StarDistConfig) -> Params:
    """:func:`with_intensity_path` for arch ``"keras"`` params: the same
    pass-through along the Keras plan, the full-resolution pre-grid
    blocks included."""
    return _pass_through(params, config, "keras")


def neighborhood_max_3x3x3(prob: torch.Tensor) -> torch.Tensor:
    """3x3x3 max filter with truncated edge neighbourhoods, over the last
    three axes of ``prob`` (leading axes are a batch)."""
    flat = prob.reshape((-1, 1) + tuple(prob.shape[-3:]))
    return F.max_pool3d(flat, kernel_size=3, stride=1,
                        padding=1).reshape(prob.shape)


def local_maxima_3x3x3(prob: torch.Tensor) -> torch.Tensor:
    """Voxels equal to their 3x3x3 neighbourhood max (edges truncated)."""
    return prob >= neighborhood_max_3x3x3(prob)


def stable_topk_desc(values: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics: the k largest, ties toward the lower index
    (``torch.topk`` does not promise that order)."""
    v, idx = torch.sort(values, descending=True, stable=True)
    return v[:k], idx[:k]


def sparse_candidates(prob: torch.Tensor, dist: torch.Tensor,
                      grid: Tuple[int, int, int], prob_thresh: float,
                      max_candidates: int = 512, border: int = 2,
                      lmax_prefilter: bool = True):
    """Fixed-size top-k candidates above ``prob_thresh`` outside a
    ``border`` of grid voxels, with ``lmax_prefilter`` among the 3x3x3 prob
    local maxima only (one candidate per prob peak; False: every voxel, the
    letter of stardist's candidate set, budget permitting).  prob (gz, gy,
    gx); dist (gz, gy, gx, n_rays).  Returns
    (probs (K,), dists (K, n_rays), points (K, 3) int32 zyx, valid (K,))."""
    gz, gy, gx = prob.shape
    b = border
    dev = prob.device
    zz = torch.arange(gz, device=dev)[:, None, None]
    yy = torch.arange(gy, device=dev)[None, :, None]
    xx = torch.arange(gx, device=dev)[None, None, :]
    interior = ((zz >= b) & (zz < gz - b) & (yy >= b) & (yy < gy - b)
                & (xx >= b) & (xx < gx - b))
    if lmax_prefilter:
        interior = interior & local_maxima_3x3x3(prob)
    masked = torch.where(interior, prob, -torch.inf).reshape(-1)
    k = min(max_candidates, masked.numel())
    top_p, top_idx = stable_topk_desc(masked, k)
    if k < max_candidates:
        top_p = F.pad(top_p, (0, max_candidates - k), value=-torch.inf)
        top_idx = F.pad(top_idx, (0, max_candidates - k))
    valid = top_p > prob_thresh
    pts = torch.stack([top_idx // (gy * gx), (top_idx // gx) % gy,
                       top_idx % gx], dim=1).to(torch.int32)
    points = pts * torch.tensor(grid, dtype=torch.int32, device=dev)
    dists = torch.clamp_min(dist.reshape(-1, dist.shape[-1])[top_idx], 1e-3)
    return torch.where(valid, top_p, 0.0), dists, points, valid


def upsample_prob_map(prob: torch.Tensor, grid: Tuple[int, int, int],
                      out_shape: Tuple[int, int, int]) -> torch.Tensor:
    """The grid-resolution (z, y, x) prob map repeated by ``grid`` and
    cropped to ``out_shape`` (stardist's ``resizer.after``)."""
    out = L.upsample3d(prob[None, ..., None], grid)[0, ..., 0]
    return out[:out_shape[0], :out_shape[1], :out_shape[2]]
