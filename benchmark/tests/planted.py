"""Faults planted under a cell's timed path, and the control put in the
program's place: what each number that decides ``correct`` is held
against.

``FAULTS[driver][name]`` is a function ``plant(drv)`` that breaks the
program underneath a driver and returns a function that undoes it: after
``setup`` and before the window, or, for the trainer, whose checked steps
run in set-up, between ``build`` and ``warm``.  ``control(drv)`` replaces what the
window produced with the plain reference computed one precision lower
(TF32 for the configurations' float32), after ``free`` and before
``check``.

On the card, ``python benchmark/tests/readings.py`` reads every number
under sound runs, each fault and the control, at the cells' own sizes; the
CPU tests (``test_faults.py``) drive tiny runs and see each fault and the
control come out not correct.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from benchmark.reference import stardist_net as ref
from benchmark.reference import tiles as ref_tiles
from benchmark.reference import train as ref_train


def _patch(obj, name: str, new) -> Callable[[], None]:
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


# ---- v1_track -----------------------------------------------------------
def _pipeline():
    import t3dct_torch
    return t3dct_torch.engine.pipeline


def v1_state_unchanged(drv):
    """Tracking returns the coordinates it was given: a step that leaves
    its state unchanged."""
    pipe = _pipeline()
    real = pipe.track_from_seg

    def stuck(ffn_params, ffn_state, confirmed_raw, *args, **kwargs):
        out = real(ffn_params, ffn_state, confirmed_raw, *args, **kwargs)
        return out._replace(corrected_raw=confirmed_raw.clone())
    return _patch(pipe, "track_from_seg", stuck)


def v1_coords_altered(drv):
    """Every tracked coordinate moved 20 voxels along the first axis where
    tracking produces it."""
    pipe = _pipeline()
    real = pipe.track_from_seg

    def moved(*args, **kwargs):
        out = real(*args, **kwargs)
        c = out.corrected_raw.clone()
        c[:, 0] += 20.0
        return out._replace(corrected_raw=c)
    return _patch(pipe, "track_from_seg", moved)


class _ShiftedNet:
    """A network whose probabilities come out 0.01 higher."""

    def __init__(self, net):
        self._net = net

    def apply(self, *args, **kwargs):
        prob, dist = self._net.apply(*args, **kwargs)
        return prob + 0.01, dist

    def __getattr__(self, name):
        return getattr(self._net, name)


def prob_altered(drv):
    """The network's probabilities raised by 0.01 where they are made."""
    return _patch(drv.model, "net", _ShiftedNet(drv.model.net))


def points_altered(drv):
    """Every kept instance moved 20 voxels along y where segmentation
    produces it."""
    model = drv.model
    # the call that makes the kept instances under each entry
    name = "_merge_tiles" if hasattr(drv, "tiling") else \
        "instances_from_grid"
    real = getattr(model, name)

    def moved(*args, **kwargs):
        out = list(real(*args, **kwargs))
        pts = out[3].clone()
        pts[:, 1] += 20
        out[3] = pts
        return tuple(out)
    return _patch(model, name, moved)


# ---- tiled_seg ----------------------------------------------------------
def tiled_half_batch(drv):
    """Half of every tile batch left out: its tiles return no prob, no
    candidate."""
    model = drv.model
    real = model._tile_batch

    def half(xn, chunk, *args, **kwargs):
        prob_c, probs, dists, points, valid = real(xn, chunk, *args,
                                                   **kwargs)
        h = len(chunk) // 2
        prob_c, probs, valid = prob_c.clone(), probs.clone(), valid.clone()
        prob_c[h:] = 0
        probs[h:] = 0
        valid[h:] = False
        return prob_c, probs, dists, points, valid
    return _patch(model, "_tile_batch", half)


def tiled_labels_altered(drv):
    """Every rendered label volume shifted by one voxel along x."""
    model = drv.model
    real = model._nms_render

    def shifted(*args, **kwargs):
        kept, labels = real(*args, **kwargs)
        if labels is not None:
            labels = torch.roll(labels, 1, dims=-1)
        return kept, labels
    return _patch(model, "_nms_render", shifted)


# ---- train_stardist -------------------------------------------------------
def train_state_unchanged(drv):
    """Adam's step leaves the parameters as they were."""
    opt = drv.trainer.optimizer
    real = opt.step

    def no_update(grads):
        saved = [p.detach().clone() for p in opt.params]
        real(grads)
        with torch.no_grad():
            for p, s in zip(opt.params, saved):
                p.copy_(s)
    return _patch(opt, "step", no_update)


def train_half_batch(drv):
    """The loss over the first half of the batch only (its mean taken over
    the rest)."""
    tr = drv.trainer
    real = tr.loss

    def half(params, x, prob_gt, dist_gt, axis=None):
        h = max(1, x.shape[0] // 2)
        return real(params, x[:h], prob_gt[:h], dist_gt[:h], axis)
    return _patch(tr, "loss", half)


def train_loss_altered(drv):
    """The loss a step returns raised by 1% where it is made."""
    tr = drv.trainer
    real = tr.train_step

    def altered(*args):
        return real(*args) * 1.01
    return _patch(tr, "train_step", altered)


FAULTS: Dict[str, Dict[str, Callable]] = {
    "v1_track": {"state_unchanged": v1_state_unchanged,
                 "coords_altered": v1_coords_altered,
                 "prob_altered": prob_altered,
                 "points_altered": points_altered},
    "tiled_seg": {"half_batch": tiled_half_batch,
                  "prob_altered": prob_altered,
                  "points_altered": points_altered,
                  "labels_altered": tiled_labels_altered},
    "train_stardist": {"state_unchanged": train_state_unchanged,
                       "half_batch": train_half_batch,
                       "loss_altered": train_loss_altered},
}


# ---- the control ----------------------------------------------------------
def control(drv) -> None:
    """Replace the program's checked outputs with the reference's, computed
    with TF32 products (call after ``free``, before ``check``)."""
    name = type(drv).__module__.rsplit(".", 1)[-1]
    cfg = drv.cfg
    if name == "train_stardist":
        with ref.tf32():
            losses, first, change = ref_train.run_steps(
                cfg["model"], drv.init, drv.X, drv.Y, drv.hp, 3,
                drv.device)
        drv.losses = losses
        drv.first_grad = {n: g.cpu() for n, g in first.items()}
        drv.after = {n: drv._init_leaf(n) + change[n].cpu()
                     for n in change}
        return
    from benchmark.harness.driver import REPO
    weights = ref.load_weights(REPO / cfg["weights"], drv.device)
    for t, got in drv.captured.items():
        x = ref.normalize(drv.scene.volume(t), drv.device)
        with ref.tf32(), torch.no_grad():
            if name == "v1_track":
                xp = ref.reflect_pad_to(x, ref.div_by(cfg["model"]))
                prob, dist = ref.forward(cfg["model"], weights, xp[None])
                got["prob"], got["dist"] = prob[0].cpu(), dist[0].cpu()
            else:
                prob, dist = ref_tiles.tiled_maps(
                    cfg["model"], weights, x, drv.cell["tile_shape"],
                    drv.cell["shrink"])
                grid = torch.tensor(cfg["model"]["grid"], device=drv.device)
                kept = got["kept"].to(drv.device)
                gi = got["points"].to(drv.device).long() // grid
                d = got["dists"].clone().to(drv.device)
                d[kept] = torch.clamp_min(
                    dist[gi[kept, 0], gi[kept, 1], gi[kept, 2]], 1e-3)
                got["prob"], got["dists"] = prob.cpu(), d.cpu()
