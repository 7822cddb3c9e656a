"""The v1.0 tracking path: ``engine/pipeline.py::segment_and_track_arrays``
in single mode over a looping recording, one volume after another.

Set-up loads the StarDist model and the FFN named by the configuration
and makes the recording from the seed.  Then one call of the entry point
runs over a generator of volumes: vol 1 (the proofread volume, segmented
only; the call interpolates its labels), then ``warmup_items`` volumes
that build every kernel and warm every shape, all of it set-up; the
window opens when the next volume is asked for and closes at the first
request after ``--seconds``, which ends the generator and so the call.

What is checked, once the window has closed (``check``):

* the network's outputs on ``samples`` volumes drawn from the seed (the
  backbone's whole prob and dist maps, as the timed path computed them)
  against the plain reference forward in float32;
* the instances the timed path kept on those volumes against the scene's
  true centres: true cells missed, instances kept where no cell is;
* the tracked coordinates of vol 1's cells in every volume of the window
  against their true centres: the worst volume's count of cells farther
  than the identity gate, and the worst volume's median distance, in x and
  y, between a cell's tracked move since vol 1 and its true move.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from ..harness import work as work_mod
from ..harness.driver import REPO, Driver as Base, TimedNet, sample_items
from ..harness.scene import Scene, SceneSpec
from ..harness.trace import warm_profiler
from ..reference import stardist_net as ref
from ..reference import truth


class WindowTimer:
    """The entry point's ``timer=``: the driver's synchronized stages while
    the window is open in a traced run, nothing otherwise."""

    def __init__(self, drv: Base):
        self.drv = drv

    def stage(self, name: str):
        w = self.drv.window
        if w is None or w.opened is None or w.closed is not None:
            return contextlib.nullcontext()
        return self.drv.stage(name)


class Driver(Base):

    def setup(self) -> None:
        import t3dct_torch
        from t3dct_torch.config import TrackingConfig
        from t3dct_torch.engine.stardist import StarDist3D
        from t3dct_torch.utils.convert import ffn_from_numpy, load_npz
        cfg, cell = self.cfg, self.cell
        self.scene = Scene(SceneSpec.from_dict(self.traffic["scene"]),
                           self.seed, self.device)
        self.model = StarDist3D.load(REPO / cfg["model_dir"],
                                     device=self.device)
        self.model.max_candidates = int(cell["max_candidates"])
        self.model.render_box = tuple(cell["render_box"])
        tree = load_npz(REPO / cfg["ffn"])
        self.ffn = ffn_from_numpy(tree["0"], tree["1"], self.device)
        self.tracking = TrackingConfig(**cell["tracking"])
        self.entry = t3dct_torch.engine.pipeline.segment_and_track_arrays
        self.labels1_xyz = self.scene.labels1.transpose(1, 2, 0)
        self.first_timed = 2 + int(cell["warmup_items"])
        self.samples = sample_items(self.seed, int(cell["samples"]),
                                    self.first_timed,
                                    int(cell["sample_span"]))
        self.captured: Dict[int, dict] = {}
        self.t_now = 0
        self._instrument()
        if self.traced:
            warm_profiler()
            self.timed_net = TimedNet(self.model.net)
            self.model.net = self.timed_net
        self.work = work_mod.layer_work(
            ref.conv_plan(cfg["model"]), cfg["model"],
            self.traffic["scene"]["shape"], cfg["precision"])

    def _instrument(self) -> None:
        """Keep the network outputs and kept instances of the sampled
        volumes as the timed path produces them, on the host (so that
        they add nothing to the card's peak)."""
        model = self.model
        forward_grid = model.forward_grid
        predict = model.predict_instances_device

        def forward_grid_kept(x):
            out = forward_grid(x)
            if self.t_now in self.samples:
                self.captured.setdefault(self.t_now, {}).update(
                    prob=out[0].cpu(), dist=out[1].cpu())
            return out

        def predict_kept(*args, **kwargs):
            out = predict(*args, **kwargs)
            if self.t_now in self.samples:
                self.captured[self.t_now].update(
                    kept=out[0].cpu(), points=out[3].cpu())
            return out

        model.forward_grid = forward_grid_kept
        model.predict_instances_device = predict_kept

    def _call(self, volumes, timer=None):
        cfg = self.cfg
        return self.entry(volumes, self.model, self.labels1_xyz, self.ffn,
                          tuple(cfg["voxel_size"]),
                          int(cfg["interpolation_factor"]), self.tracking,
                          device=self.device, timer=timer)

    def run_window(self, seconds: float) -> None:
        self.open_window(seconds)

        def volumes():
            t = 1
            while True:
                if t >= self.first_timed and not self.request():
                    return
                self.t_now = t
                yield self.scene.volume(t)
                t += 1

        self.result = self._call(volumes(), timer=WindowTimer(self))
        st = self.result.stats
        self.stats["prgls_iterations"] = [
            float(st[t]["prgls_iterations"]) for t in sorted(st)
            if t >= self.first_timed]

    def end_to_end(self) -> Dict[str, float]:
        return {"volumes_per_s": self.window.rate}

    def attempted_failed(self) -> Tuple[int, int]:
        return self.window.completed, 0

    def free(self) -> None:
        del self.model, self.ffn
        self.timed_net = None
        torch.cuda.empty_cache()

    def check(self) -> Dict[str, Tuple[float, float]]:
        cfg, lim = self.cfg, self.cell["limits"]
        weights = ref.load_weights(REPO / cfg["weights"], self.device)
        vs = np.asarray(cfg["voxel_size"], np.float64)     # (x, y, z) frame
        zyx_scale = vs[[2, 0, 1]]
        g = truth.gate(self.scene.centres(1) * zyx_scale)
        prob_gap = dist_gap = 0.0
        missed = extra = 0
        for t, got in sorted(self.captured.items()):
            x = ref.reflect_pad_to(ref.normalize(self.scene.volume(t),
                                                 self.device),
                                   ref.div_by(cfg["model"]))
            with ref.exact(), torch.no_grad():
                prob, dist = ref.forward(cfg["model"], weights, x[None])
            prob_gap = max(prob_gap, float((got["prob"].to(self.device)
                                            - prob[0]).abs().max()))
            dist_gap = max(dist_gap, float((got["dist"].to(self.device)
                                            - dist[0]).abs().max()))
            pts = got["points"][got["kept"]].numpy().astype(np.float64)
            m, e = truth.instances_against_truth(
                pts * zyx_scale, self.scene.centres(t) * zyx_scale, g)
            missed, extra = max(missed, m), max(extra, e)
        del weights
        tracked = {t: c for t, c in self.result.coords.items()}
        true_xyz = {t: self.scene.centres(t)[:, [1, 2, 0]] * vs
                    for t in tracked}
        # in-plane moves: the scene's z drift (0.3 voxel) is below the
        # z sampling, so no tracker can follow it (PERF.md, sd_worm_track)
        errs, moves = truth.tracking_errors(tracked, true_xyz, g, (0, 1))
        _, moves3 = truth.tracking_errors(tracked, true_xyz, g)
        worst_lost = max(int((e > g).sum()) for t, e in errs.items()
                         if t > 1)

        def worst(d):
            return max(float(np.median(m)) for t, m in d.items() if t > 1)
        worst_move = worst(moves)
        print(f"readings: gate {g:.4f} real units, {len(errs) - 1} tracked "
              f"volumes; worst volume's median distance from the true "
              f"centre {worst(errs):.4f}, worst cell's "
              f"{max(float(e.max()) for e in errs.values()):.4f}; worst "
              f"volume's median move error in (x, y) {worst_move:.4f}, in "
              f"(x, y, z) {worst(moves3):.4f}", file=sys.stderr)
        return {
            "prob_gap": (prob_gap, lim["prob_gap"]),
            "dist_gap": (dist_gap, lim["dist_gap"]),
            "cells_missed": (float(missed), lim["cells_missed"]),
            "extra_instances": (float(extra), lim["extra_instances"]),
            "track_move_err": (worst_move, lim["track_move_err"]),
            "track_lost": (float(worst_lost), lim["track_lost"]),
            "samples_unchecked": (float(len(self.samples)
                                        - len(self.captured)), 0.0),
        }
