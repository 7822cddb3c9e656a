"""StarDist3D training steps as ``TrainStarDist3D.train`` runs them: the
host sampler's batch, its GT on the card (``make_gt``), then
``train_step`` (loss, gradient, Adam).

Set-up builds one trainer with the configuration's recipe, starts it from
the configuration's initial weights, and drives it from the seed through
its first ``warmup_items`` steps with the window's own call and feed;
the same trainer then runs the window.  The training data are the
recording's pool volumes, each normalized by its 1/99.8 percentiles, with
their truth labels.

Checked (``check``): the reference (``reference/train.py``) runs the
first three steps from the same initial weights on the same volumes:
each step's loss, the first gradient by leaf (the program's read from
Adam's first moment after step one, ``mu / (1 - b1)``) and each leaf's
change after the three steps (read before step four), each as the gap
between the two sides' norms over the reference's norm of that leaf or
of the median leaf, whichever is larger.  Leaves whose reference gradient
is under a thousandth of the median leaf's are left out of the change.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import numpy as np
import torch

from ..harness import work as work_mod
from ..harness.driver import REPO, Driver as Base
from ..harness.scene import Scene, SceneSpec
from ..harness.trace import warm_profiler
from ..reference import stardist_net as ref
from ..reference import train as ref_train

CHECKED_STEPS = 3


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Each leaf's | |got| - |want| | / max(|want|, median |want|)."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    out = {}
    for k, w in norms.items():
        if keep is not None and k not in keep:
            continue
        g = float(torch.linalg.vector_norm(got[k].double().to(
            want[k].device)))
        out[k] = abs(g - w) / max(w, med)
    return out


def worst_leaves(name: str, gaps: Dict[str, float]) -> float:
    """The worst gap; the three worst leaves printed as a reading."""
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    print(f"readings: {name} worst leaves "
          + ", ".join(f"{k} {v:.3e}" for k, v in top), file=sys.stderr)
    return top[0][1]


class Driver(Base):

    def setup(self) -> None:
        self.build()
        self.warm()

    def build(self) -> None:
        """The trainer, from the configuration's initial weights, and the
        training data."""
        from t3dct_torch.config import StarDistConfig
        from t3dct_torch.models.train_stardist import TrainStarDist3D
        cfg, cell = self.cfg, self.cell
        self.hp = dict(cell["trainer"], seed=self.seed % 2 ** 32)
        self.scene = Scene(SceneSpec.from_dict(self.traffic["scene"]),
                           self.seed, self.device, all_labels=True)
        self.X = [ref.normalize(v, self.device).cpu().numpy()
                  for v in self.scene.pool]
        self.Y = list(self.scene.labels)
        mcfg = {k: tuple(v) if isinstance(v, list) else v
                for k, v in cfg["model"].items()}
        hp = self.hp
        self.trainer = TrainStarDist3D(
            StarDistConfig(**mcfg), seed=hp["seed"],
            learning_rate=hp["learning_rate"],
            dist_loss_weight=hp["dist_loss_weight"],
            max_dist=hp["max_dist"], batch_size=hp["batch_size"],
            prob_fg_weight=hp["prob_fg_weight"],
            background_reg=hp["background_reg"],
            foreground_prob=hp["foreground_prob"], device=self.device)
        init = np.load(REPO / cfg["train_init"])
        self.init = {}
        for key in init.files:
            layer, leaf = key.split("/")
            self.init.setdefault(layer, {})[leaf] = torch.from_numpy(
                np.asarray(init[key], np.float32))
        self.trainer.start_from(self.init)

    def warm(self) -> None:
        """The first ``warmup_items`` steps through the window's own call:
        the three checked ones among them."""
        from t3dct_torch.utils.checkpoint import leaves_with_paths
        cfg, cell, hp = self.cfg, self.cell, self.hp
        self.names = [p for p, _ in leaves_with_paths(self.trainer.params)]
        self.losses = []
        for i in range(int(cell["warmup_items"])):
            self.losses.append(self._step())
            if i == 0:
                b1 = self.trainer.optimizer.b1
                self.first_grad = {n: (mu / (1 - b1)).detach().cpu()
                                   for n, mu in zip(self.names,
                                                    self.trainer.optimizer.mu)}
            if i == CHECKED_STEPS - 1:
                self.after = {n: p.detach().cpu().clone() for n, p in
                              leaves_with_paths(self.trainer.params)}
        self.losses = [float(v) for v in self.losses[:CHECKED_STEPS]]
        if self.traced:
            warm_profiler()
            make_gt = self.trainer.make_gt

            def make_gt_timed(labels):
                with self.stage("gt"):
                    return make_gt(labels)

            self.trainer.make_gt = make_gt_timed
        patch = cfg["model"]["train_patch_size"]
        self.work = {k: dict(v, flop=v["flop"] * hp["batch_size"])
                     for k, v in work_mod.layer_work(
                         ref.conv_plan(cfg["model"]), cfg["model"], patch,
                         cfg["precision"]).items()}

    def _step(self) -> torch.Tensor:
        tr = self.trainer
        if not self.traced:
            return tr.train_step(*tr.sample_batch(self.X, self.Y))
        # spans of the trace (no synchronization): the breakdown names
        # the part of the step the host was in
        with torch.profiler.record_function("sample_batch"):
            batch = tr.sample_batch(self.X, self.Y)
        with torch.profiler.record_function("train_step"):
            return tr.train_step(*batch)

    def run_window(self, seconds: float) -> None:
        self.open_window(seconds)
        if self.timer is not None:
            self.timer.times.clear()
        while self.request(sync=True):
            self._step()

    def end_to_end(self) -> Dict[str, float]:
        return {"train_steps_per_s": self.window.rate}

    def attempted_failed(self) -> Tuple[int, int]:
        return self.window.completed, 0

    def free(self) -> None:
        del self.trainer
        torch.cuda.empty_cache()

    def check(self) -> Dict[str, Tuple[float, float]]:
        lim = self.cell["limits"]
        with ref.exact():
            losses, first, change = ref_train.run_steps(
                self.cfg["model"], self.init, self.X, self.Y, self.hp,
                CHECKED_STEPS, self.device)
        loss_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(self.losses, losses))
        grad_gap = worst_leaves("grad_gap", leaf_gaps(self.first_grad,
                                                      first))
        norms = {k: float(torch.linalg.vector_norm(v)) for k, v in
                 first.items()}
        med = float(np.median(list(norms.values())))
        moved = {k for k, v in norms.items() if v >= 1e-3 * med}
        got_change = {n: self.after[n] - self._init_leaf(n)
                      for n in self.names}
        change_gap = worst_leaves("change_gap", leaf_gaps(
            got_change, change, keep=moved))
        return {
            "loss_gap": (loss_gap, lim["loss_gap"]),
            "grad_gap": (grad_gap, lim["grad_gap"]),
            "change_gap": (change_gap, lim["change_gap"]),
        }

    def _init_leaf(self, name: str) -> torch.Tensor:
        layer, leaf = name.split("/")
        return self.init[layer][leaf]
