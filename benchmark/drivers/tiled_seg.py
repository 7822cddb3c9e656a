"""Segmentation of volumes too large for one backbone pass:
``StarDist3D.predict_instances_tiled_device``, one volume after another,
as ``predict_and_save(tile_shape=)`` calls it per volume.

Per volume: the host's 1/99.8 percentiles (the port's
``io/imageio.py::fast_percentiles``, as its drivers take them), the
upload, the tiled call with the cell's tiles, margins, candidates a tile
and tile batch, and every output fetched to the host (the labels too).  A
volume is done when its outputs are on the host.  Set-up makes the
recording and runs ``warmup_items`` volumes.

What is checked, once the window has closed, on ``samples`` volumes drawn
from the seed: the whole prob map and the kept instances' distances
against the plain reference's tiled maps; the kept instances against the
scene's true centres; the labels against the reference's rendering of the
kept instances (the render judged from the program's kept instances, the
network judged apart).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..harness import work as work_mod
from ..harness.driver import REPO, Driver as Base, TimedNet, sample_items
from ..harness.scene import Scene, SceneSpec
from ..harness.trace import warm_profiler
from ..reference import render as ref_render
from ..reference import stardist_net as ref
from ..reference import tiles as ref_tiles
from ..reference import truth


class Driver(Base):

    def setup(self) -> None:
        from t3dct_torch.engine.stardist import StarDist3D
        from t3dct_torch.io.imageio import fast_percentiles
        from t3dct_torch.utils.device import upload_raw
        cfg, cell = self.cfg, self.cell
        self.percentiles, self.upload = fast_percentiles, upload_raw
        self.scene = Scene(SceneSpec.from_dict(self.traffic["scene"]),
                           self.seed, self.device)
        self.model = StarDist3D.load(REPO / cfg["model_dir"],
                                     device=self.device)
        self.model.max_candidates = int(cell["max_candidates"])
        self.model.render_box = tuple(cell["render_box"])
        self.tiling = dict(tile_shape=tuple(cell["tile_shape"]),
                           shrink=tuple(cell["shrink"]),
                           tile_candidates=int(cell["tile_candidates"]),
                           tile_batch=int(cell["tile_batch"]))
        self.samples = sample_items(self.seed, int(cell["samples"]), 1,
                                    int(cell["sample_span"]))
        self.captured: Dict[int, dict] = {}
        for t in range(1, int(cell["warmup_items"]) + 1):
            self._segment(t)
        if self.traced:
            warm_profiler()
            self.timed_net = TimedNet(self.model.net)
            self.model.net = self.timed_net
        self.work = work_mod.layer_work(
            ref.conv_plan(cfg["model"]), cfg["model"],
            self.traffic["scene"]["shape"], cfg["precision"])

    def _segment(self, t: int):
        vol = self.scene.volume(t)
        mi, ma = self.percentiles(vol, (1.0, 99.8))
        with self.stage("seg"):
            out = self.model.predict_instances_tiled_device(
                self.upload(vol, self.device),
                (np.float32(mi), np.float32(ma)), **self.tiling)
        kept, probs, dists, points, prob_map, labels = (
            o.cpu() for o in out)
        return dict(kept=kept, probs=probs, dists=dists, points=points,
                    prob=prob_map, labels=labels)

    def run_window(self, seconds: float) -> None:
        self.open_window(seconds)
        self.captured.clear()
        if self.timer is not None:
            self.timer.times.clear()
        t = 1
        while self.request():
            out = self._segment(t)
            if t in self.samples:
                self.captured[t] = out
            t += 1

    def end_to_end(self) -> Dict[str, float]:
        return {"volumes_per_s": self.window.rate}

    def attempted_failed(self) -> Tuple[int, int]:
        return self.window.completed, 0

    def free(self) -> None:
        del self.model
        self.timed_net = None
        torch.cuda.empty_cache()

    def check(self) -> Dict[str, Tuple[float, float]]:
        cfg, cell, lim = self.cfg, self.cell, self.cell["limits"]
        mcfg = cfg["model"]
        weights = ref.load_weights(REPO / cfg["weights"], self.device)
        zyx_scale = np.asarray(mcfg["anisotropy"], np.float64)
        g = truth.gate(self.scene.centres(1) * zyx_scale)
        rays = torch.from_numpy(ref_render.golden_spiral(
            mcfg["n_rays"], mcfg["anisotropy"])).to(self.device)
        grid = torch.tensor(mcfg["grid"], device=self.device)
        prob_gap = dist_gap = label_mismatch = 0.0
        missed = extra = 0
        for t, got in sorted(self.captured.items()):
            x = ref.normalize(self.scene.volume(t), self.device)
            with ref.exact(), torch.no_grad():
                prob, dist = ref_tiles.tiled_maps(
                    mcfg, weights, x, cell["tile_shape"], cell["shrink"])
            prob_gap = max(prob_gap, float(
                (got["prob"].to(self.device) - prob).abs().max()))
            kept = got["kept"].to(self.device)
            pts = got["points"].to(self.device)[kept].long()
            gi = pts // grid
            inside = ((gi >= 0) & (gi < torch.tensor(
                prob.shape, device=self.device))).all(dim=1)
            if not bool(inside.all()):
                dist_gap = float("inf")     # a kept point off the volume
            gi = gi[inside]
            if len(gi):
                want = torch.clamp_min(dist[gi[:, 0], gi[:, 1], gi[:, 2]],
                                       1e-3)
                dist_gap = max(dist_gap, float((got["dists"].to(
                    self.device)[kept][inside] - want).abs().max()))
            m, e = truth.instances_against_truth(
                pts.cpu().numpy() * zyx_scale,
                self.scene.centres(t) * zyx_scale, g)
            missed, extra = max(missed, m), max(extra, e)
            lab = ref_render.render(
                pts, got["dists"].to(self.device)[kept],
                got["probs"].to(self.device)[kept], rays,
                tuple(self.traffic["scene"]["shape"]),
                tuple(cell["render_box"]))
            mine = got["labels"].to(self.device)
            fg = (lab > 0) | (mine > 0)
            label_mismatch = max(label_mismatch, float(
                ((lab != mine) & fg).sum()) / max(1, int(fg.sum())))
            del prob, dist
        return {
            "prob_gap": (prob_gap, lim["prob_gap"]),
            "dist_gap": (dist_gap, lim["dist_gap"]),
            "cells_missed": (float(missed), lim["cells_missed"]),
            "extra_instances": (float(extra), lim["extra_instances"]),
            "label_mismatch": (label_mismatch, lim["label_mismatch"]),
            "samples_unchecked": (float(len(self.samples)
                                        - len(self.captured)), 0.0),
        }
