"""StarDist3D instance program (counterpart of
``3deecelltracker_tpu/engine/stardist.py:173-217``, ``:292-325``).

One call per volume: normalize the raw volume on the device with the
host's 1/99.8 percentiles, reflect-pad to the network's ``div_by``, run the
backbone, gather the sparse candidates, then overlap matrix, greedy NMS
and, when asked, the label render.  Outputs stay on the device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from ..config import StarDistConfig
from ..models.stardist3d import StarDist3DNet, sparse_candidates
from ..ops.nms import greedy_nms, overlap_matrix, render_polyhedra_labels
from ..ops.rays import rays_golden_spiral
from ..utils.convert import load_npz, stardist_params_from_numpy
from ..utils.device import select_device


class StarDist3D:
    """StarDist3D model (arch ``"tpu"``) with its per-volume instance
    program.  ``params``: the network's ``{layer: {"w", "b"}}`` tensors
    (``utils.convert`` for JAX weights, ``StarDist3DNet.init`` for a seeded
    random init)."""

    def __init__(self, config: StarDistConfig, params,
                 max_candidates: int = 1024,
                 render_box: Tuple[int, int, int] = (33, 65, 65),
                 device=None):
        self.config = config
        self.device = select_device(device)
        self.net = StarDist3DNet(config)
        self.params = {name: {k: v.to(self.device, torch.float32)
                              .contiguous() for k, v in layer.items()}
                       for name, layer in params.items()}
        self.rays = torch.from_numpy(rays_golden_spiral(
            config.n_rays, config.anisotropy)).to(self.device)
        self.max_candidates = int(max_candidates)
        self.render_box = tuple(int(b) for b in render_box)
        self.thresholds = dict(prob=config.prob_thresh,
                               nms=config.nms_thresh)

    @staticmethod
    def load(model_dir: Union[str, Path], device=None) -> "StarDist3D":
        """Read a JAX-package model folder (``config.json`` +
        ``weights.npz`` [+ ``thresholds.json``]) with numpy alone."""
        model_dir = Path(model_dir)
        with open(model_dir / "config.json") as fh:
            raw = json.load(fh)
        arch = raw.pop("arch", "tpu")
        if arch != "tpu":
            raise NotImplementedError(f"arch {arch!r}: the port has 'tpu'")
        for key in ("grid", "anisotropy", "unet_pool", "unet_kernel_size",
                    "train_patch_size"):
            if raw.get(key) is not None:
                raw[key] = tuple(raw[key])
        dev = select_device(device)
        params = stardist_params_from_numpy(
            load_npz(model_dir / "weights.npz"), dev)
        model = StarDist3D(StarDistConfig(**raw), params=params, device=dev)
        if (model_dir / "thresholds.json").exists():
            with open(model_dir / "thresholds.json") as fh:
                model.thresholds = json.load(fh)
        return model

    def predict_instances_device(self, x_raw: torch.Tensor,
                                 norm_minmax: Tuple[float, float],
                                 return_labels: bool = True):
        """The instance program on one raw (z, y, x) volume (any dtype),
        normalized on the device with ``norm_minmax``, the host's 1/99.8
        percentiles, by csbdeep's formula.

        Returns ``(kept, probs, dists, points, prob_map, labels)`` on the
        device: kept (K,) bool, probs (K,), dists (K, n_rays), points (K, 3)
        int32 zyx, the grid-resolution prob map as float16 (as the JAX
        program ships it), and int32 (z, y, x) labels or None."""
        cfg = self.config
        dev = self.device
        orig_shape = tuple(int(s) for s in x_raw.shape)
        gshape = tuple(-(-s // g) for s, g in zip(orig_shape, cfg.grid))
        mi = torch.tensor(norm_minmax[0], dtype=torch.float32, device=dev)
        ma = torch.tensor(norm_minmax[1], dtype=torch.float32, device=dev)
        x = (x_raw.to(dev).to(torch.float32) - mi) / (ma - mi + 1e-20)
        pads = [(-s) % d for s, d in zip(orig_shape, self.net.div_by)]
        xp = F.pad(x[None, None], (0, pads[2], 0, pads[1], 0, pads[0]),
                   mode="reflect")[0, 0]
        prob_g, dist_g = self.net.apply(self.params, xp[None, ..., None])
        prob_g, dist_g = prob_g[0, ..., 0], dist_g[0]
        probs, dists, points, valid = sparse_candidates(
            prob_g, dist_g, cfg.grid, self.thresholds["prob"],
            max_candidates=self.max_candidates)
        prob_map = prob_g[:gshape[0], :gshape[1], :gshape[2]].to(
            torch.float16)
        valid = (valid & (points[:, 0] < orig_shape[0])
                 & (points[:, 1] < orig_shape[1])
                 & (points[:, 2] < orig_shape[2]))
        centers = points.to(torch.float32)
        overlaps = overlap_matrix(centers, dists, self.rays, valid,
                                  prob=probs)
        kept = greedy_nms(probs, overlaps, valid, self.thresholds["nms"])
        labels = None
        if return_labels:
            labels = render_polyhedra_labels(
                centers, dists, self.rays, probs, kept, orig_shape,
                self.render_box)
        return kept, probs, dists, points, prob_map, labels
