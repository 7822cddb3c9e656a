"""The StarDist3D network of a configuration file in plain PyTorch: the
reference forward that the benchmark holds the port's backbone to.

The topology is stardist's 3-D U-Net as the configuration states it (the
port's arch ``"tpu"``): a max-pool by ``grid`` before the stem, a 3x3x3
conv + ReLU stem of ``unet_n_filter_base`` channels, ``unet_n_depth``
levels of ``unet_n_conv_per_depth`` 3x3x3 conv + ReLU with a ``unet_pool``
max-pool after each, as many convs at the bottom, then per level a nearest
upsample, the level's skip concatenated after it and the level's convs, a
3x3x3 conv + ReLU of ``net_conv_after_unet`` channels and two 1x1x1 heads:
``sigmoid`` for the object probability and a linear one for the
``n_rays`` distances.  Convolutions are SAME, weights DHWIO as the model
folder's ``weights.npz`` stores them.

Plain ``torch.nn.functional`` calls only.  :func:`exact` runs them with
TF32 off (the configuration's float32); :func:`tf32` with TF32 on, the
control a float32 configuration is held against.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, Dict[str, torch.Tensor]]


def conv_plan(cfg: dict) -> List[Tuple[str, int, int, int, int]]:
    """(name, c_in, c_out, kernel edge, level) of every conv, in order;
    ``level`` counts the U-Net pools above the grid resolution."""
    f = cfg["unet_n_filter_base"]
    ncv = cfg["unet_n_conv_per_depth"]
    depth = cfg["unet_n_depth"]
    filters = [f * 2 ** lvl for lvl in range(depth + 1)]
    plan = [("stem", cfg["n_channel_in"], f, 3, 0)]
    c = f
    for lvl in range(depth):
        for i in range(ncv):
            plan.append((f"down{lvl}_{i}", c, filters[lvl], 3, lvl))
            c = filters[lvl]
    for i in range(ncv):
        plan.append((f"bottom_{i}", c, filters[-1], 3, depth))
        c = filters[-1]
    for lvl in reversed(range(depth)):
        for i in range(ncv):
            plan.append((f"up{lvl}_{i}", c + filters[lvl] if i == 0
                         else filters[lvl], filters[lvl], 3, lvl))
            c = filters[lvl]
    plan.append(("features", c, cfg["net_conv_after_unet"], 3, 0))
    plan.append(("prob_head", cfg["net_conv_after_unet"], 1, 1, 0))
    plan.append(("dist_head", cfg["net_conv_after_unet"], cfg["n_rays"], 1, 0))
    return plan


def div_by(cfg: dict) -> Tuple[int, int, int]:
    return tuple(g * p ** cfg["unet_n_depth"]
                 for g, p in zip(cfg["grid"], cfg["unet_pool"]))


def load_weights(path, device) -> Weights:
    """``{layer: {"w", "b"}}`` float32 tensors from a ``weights.npz`` whose
    keys are ``<layer>/w`` and ``<layer>/b``."""
    out: Weights = {}
    with np.load(str(path)) as data:
        for key in data.files:
            layer, leaf = key.split("/")
            out.setdefault(layer, {})[leaf] = torch.from_numpy(
                np.asarray(data[key], np.float32)).to(device)
    return out


@contextlib.contextmanager
def _tf32(on: bool) -> Iterator[None]:
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def exact():
    """Float32 products and sums: TF32 off for cuDNN and cuBLAS."""
    return _tf32(False)


def tf32():
    """The control: TF32 products (10-bit mantissas) in every conv and
    matmul."""
    return _tf32(True)


def _conv(layer: Dict[str, torch.Tensor], h: torch.Tensor,
          relu: bool) -> torch.Tensor:
    """SAME conv of NCDHW ``h`` with DHWIO weights, + bias."""
    w = layer["w"].permute(4, 3, 0, 1, 2)
    y = F.conv3d(h, w, layer["b"], padding=w.shape[-1] // 2)
    return torch.relu(y) if relu else y


def forward(cfg: dict, weights: Weights, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, z, y, x) normalized float32, each side a multiple of
    :func:`div_by` -> (prob (b, gz, gy, gx), dist (b, gz, gy, gx, n_rays))
    at grid resolution."""
    ncv, depth = cfg["unet_n_conv_per_depth"], cfg["unet_n_depth"]
    h = x[:, None].float()
    if any(g > 1 for g in cfg["grid"]):
        h = F.max_pool3d(h, tuple(cfg["grid"]))
    h = _conv(weights["stem"], h, True)
    skips = []
    for lvl in range(depth):
        for i in range(ncv):
            h = _conv(weights[f"down{lvl}_{i}"], h, True)
        skips.append(h)
        h = F.max_pool3d(h, tuple(cfg["unet_pool"]))
    for i in range(ncv):
        h = _conv(weights[f"bottom_{i}"], h, True)
    for lvl in reversed(range(depth)):
        h = F.interpolate(h, scale_factor=tuple(float(p) for p in
                                                cfg["unet_pool"]),
                          mode="nearest")
        h = torch.cat([h, skips[lvl]], dim=1)
        for i in range(ncv):
            h = _conv(weights[f"up{lvl}_{i}"], h, True)
    feat = _conv(weights["features"], h, True)
    prob = torch.sigmoid(_conv(weights["prob_head"], feat, False))[:, 0]
    dist = _conv(weights["dist_head"], feat, False).permute(0, 2, 3, 4, 1)
    return prob, dist


def reflect_pad_to(x: torch.Tensor, mult: Tuple[int, int, int]
                   ) -> torch.Tensor:
    """(z, y, x) padded at the end of each axis to a multiple of ``mult`` by
    reflection without repeating the edge (numpy's ``"reflect"``)."""
    pads = [(-s) % m for s, m in zip(x.shape, mult)]
    return F.pad(x[None, None], (0, pads[2], 0, pads[1], 0, pads[0]),
                 mode="reflect")[0, 0]


def normalize(raw: np.ndarray, device) -> torch.Tensor:
    """csbdeep's percentile normalization of a raw volume: (x - p1) /
    (p99.8 - p1 + 1e-20) in float32, percentiles by numpy (linear)."""
    mi, ma = np.percentile(raw, (1.0, 99.8))
    x = torch.from_numpy(np.ascontiguousarray(raw)).to(device).float()
    return (x - np.float32(mi)) / (np.float32(ma) - np.float32(mi)
                                   + np.float32(1e-20))
