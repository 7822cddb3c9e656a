"""StarDist3D network, arch ``"tpu"``, and the sparse candidate gather.

Counterpart of ``3deecelltracker_tpu/models/stardist3d.py`` (:152-199 and
:340-416): grid max-pool before the stem, a depth-``unet_n_depth`` U-Net of
3x3x3 conv+ReLU layers, a 3x3x3 feature conv and 1x1x1 prob/dist heads at
grid resolution.  Layout (b, z, y, x, c); params are a flat dict keyed like
the JAX pytree (``"stem"``, ``"down0_0"``, ...), each ``{"w", "b"}``.
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


@dataclasses.dataclass(frozen=True)
class StarDist3DNet:
    config: StarDistConfig

    def conv_plan(self):
        """Ordered (name, c_in, c_out, kernel) of every conv layer."""
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

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Seeded glorot init (not JAX's numbers; see ``layers``);
        ``device=None`` is the card."""
        device = select_device(device)
        return {name: L.init_conv3d(kernel, cin, cout, generator, device)
                for name, cin, cout, kernel in self.conv_plan()}

    def apply(self, params: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (b, z, y, x, c) -> (prob (b, z/g, y/g, x/g, 1),
        dist (b, ..., n_rays)).  Spatial dims must be divisible by
        ``div_by``."""
        cfg = self.config

        def conv(name, h):
            return L.conv3d(params[name], h, relu=True)

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
        feat = conv("features", h)
        prob = torch.sigmoid(L.conv3d(params["prob_head"], feat))
        dist = L.conv3d(params["dist_head"], feat)
        return prob, dist

    @property
    def div_by(self) -> Tuple[int, int, int]:
        cfg = self.config
        return tuple(g * p ** cfg.unet_n_depth
                     for g, p in zip(cfg.grid, cfg.unet_pool))


def with_intensity_path(params: Params, config: StarDistConfig) -> Params:
    """Copy of ``params`` with a pass-through path added: all weights are
    scaled by 0.05, every 3x3x3 layer's centre tap then maps input channel
    0 (for the first up conv, the skip's channel 0) to output channel 0
    with weight +1, the prob head reads ``sigmoid(12 * ch0 - 6)`` and the
    dist head's bias is 3 (voxels).  The normalized background (~0.05)
    then scores ~0.005 and a cell's peak (~1) ~0.998.  On a normalized microscopy volume the detections then
    follow the bright cells, which gives random-weight runs (tests, the
    chip smoke run) a realistic candidate count without trained weights."""
    net = StarDist3DNet(config)
    out = {name: {k: v.clone() for k, v in layer.items()}
           for name, layer in params.items()}
    f = config.unet_n_filter_base
    for name, cin, cout, kernel in net.conv_plan():
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
                lvl = int(name[2:name.index("_")])
                src = cin - f * 2 ** lvl
            w[1, 1, 1, src, 0] += 1.0
    return out


def local_maxima_3x3x3(prob: torch.Tensor) -> torch.Tensor:
    """Voxels equal to their 3x3x3 neighbourhood max (edges truncated)."""
    neigh = F.max_pool3d(prob[None, None], kernel_size=3, stride=1,
                         padding=1)[0, 0]
    return prob >= neigh


def stable_topk_desc(values: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics: the k largest, ties toward the lower index
    (``torch.topk`` does not promise that order)."""
    v, idx = torch.sort(values, descending=True, stable=True)
    return v[:k], idx[:k]


def sparse_candidates(prob: torch.Tensor, dist: torch.Tensor,
                      grid: Tuple[int, int, int], prob_thresh: float,
                      max_candidates: int = 512, border: int = 2):
    """Fixed-size top-k candidates above ``prob_thresh`` among the 3x3x3
    prob local maxima (the JAX twin's ``lmax_prefilter=True``, the only
    setting the main path uses).  prob (gz, gy, gx); dist (gz, gy, gx,
    n_rays).  Returns
    (probs (K,), dists (K, n_rays), points (K, 3) int32 zyx, valid (K,))."""
    gz, gy, gx = prob.shape
    b = border
    dev = prob.device
    zz = torch.arange(gz, device=dev)[:, None, None]
    yy = torch.arange(gy, device=dev)[None, :, None]
    xx = torch.arange(gx, device=dev)[None, None, :]
    interior = ((zz >= b) & (zz < gz - b) & (yy >= b) & (yy < gy - b)
                & (xx >= b) & (xx < gx - b))
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
