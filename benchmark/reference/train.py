"""StarDist3D training steps in plain PyTorch and NumPy: the reference for
the port's ``TrainStarDist3D`` steps.

One step, as stardist trains (the reference's ``stardistwrapper.py``
protocol and stardist's loss):

1. ``batch`` patches drawn by the trainer's sampler: a volume at random, a
   patch start around a random foreground voxel with probability
   ``foreground_prob`` (else anywhere), then a random permutation and flips
   of y and x and an intensity change ``x * U(0.6, 2) + U(-0.2, 0.2)``; all
   from one ``numpy.random.RandomState`` in that order (copied below, as
   the benchmark's own sampler, so that it draws the same patches).
2. The targets at the grid's voxels: the object probability (the
   Euclidean distance, at the anisotropy's spacing, to the nearest voxel
   that is background or has a face neighbour of another label or outside
   the patch, plus one, over its object's maximum), and for every ray the
   steps ``t = 1 .. max_dist`` along ``round(ray * t)`` that stay in the
   voxel's own label.
3. The loss: binary cross-entropy of the probability (foreground weighted
   by ``prob_fg_weight``), plus ``dist_loss_weight`` times the
   probability-weighted mean absolute ray error with its background term.
4. Its gradient by autograd through :func:`stardist_net.forward`, and one
   Adam step with optax's arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage

from . import render, stardist_net


class Sampler:
    """The trainer's patch sampler (``TrainStarDist3D._sample_patch`` and
    stardist's augmenter), drawing from ``RandomState(seed)``."""

    def __init__(self, seed: int, patch: Sequence[int], foreground_prob:
                 float):
        self.rng = np.random.RandomState(seed)
        self.patch = tuple(patch)
        self.fg_prob = float(foreground_prob)
        self._fg: Dict[int, np.ndarray] = {}

    def patch_pair(self, X, Y):
        rng, patch = self.rng, self.patch
        i = rng.randint(len(X))
        x, y = X[i], Y[i]
        starts = None
        if self.fg_prob > 0 and rng.rand() < self.fg_prob:
            if i not in self._fg:
                self._fg[i] = np.argwhere(y > 0)
            fg = self._fg[i]
            if len(fg):
                c = fg[rng.randint(len(fg))]
                starts = [rng.randint(max(0, cc - p + 1),
                                      min(cc, s - p) + 1)
                          for cc, p, s in zip(c, patch, y.shape)]
        if starts is None:
            starts = [rng.randint(0, max(s - p, 0) + 1)
                      for p, s in zip(patch, y.shape)]
        sl = tuple(slice(s, s + p) for s, p in zip(starts, patch))
        xp, yp = x[sl].astype(np.float32), y[sl].astype(np.int32)
        perm = tuple(rng.permutation((1, 2)))
        axes = [0, perm[0], perm[1]]
        xp, yp = xp.transpose(axes), yp.transpose(axes)
        for ax in (1, 2):
            if rng.rand() > 0.5:
                xp, yp = np.flip(xp, axis=ax), np.flip(yp, axis=ax)
        xp = xp * rng.uniform(0.6, 2.0) + rng.uniform(-0.2, 0.2)
        return np.ascontiguousarray(xp), np.ascontiguousarray(yp)

    def batch(self, X, Y, n: int) -> Tuple[np.ndarray, np.ndarray]:
        pairs = [self.patch_pair(X, Y) for _ in range(n)]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))


def edt_prob(lab: np.ndarray, anisotropy: Sequence[float]) -> np.ndarray:
    """stardist's object probability of one (z, y, x) label patch."""
    fg = lab > 0
    diff = np.zeros(lab.shape, bool)
    padded = np.pad(lab, 1)
    for ax in range(3):
        for step in (-1, 1):
            nb = np.roll(padded, step, axis=ax)[1:-1, 1:-1, 1:-1]
            diff |= nb != lab
    inner = fg & ~diff
    d = ndimage.distance_transform_edt(inner, sampling=anisotropy) \
        + fg.astype(np.float64)
    out = np.zeros(lab.shape, np.float64)
    for lbl in np.unique(lab[fg]):
        m = lab == lbl
        out[m] = d[m] / max(d[m].max(), 1e-6)
    return out.astype(np.float32)


def star_dist(lab: torch.Tensor, rays: np.ndarray, max_dist: int,
              grid: Sequence[int]) -> torch.Tensor:
    """(b, z', y', x', n_rays) ray distances of (b, z, y, x) labels at the
    voxels ``[::gz, ::gy, ::gx]``; outside the patch is background."""
    b, z, y, x = lab.shape
    pad = max_dist + 1
    lp = torch.nn.functional.pad(lab, (pad,) * 6)
    gz, gy, gx = grid
    own = lab[:, ::gz, ::gy, ::gx]
    fg = own > 0
    out = []
    steps = np.arange(1, max_dist + 1, dtype=np.float64)
    for r in np.asarray(rays, np.float64):
        offs = np.round(r[None, :] * steps[:, None]).astype(np.int64)
        alive = fg.clone()
        dist = torch.zeros(own.shape, device=lab.device)
        for oz, oy, ox in offs:
            nb = lp[:, pad + oz:pad + oz + z:gz, pad + oy:pad + oy + y:gy,
                    pad + ox:pad + ox + x:gx]
            alive = alive & (nb == own)
            dist += alive
        out.append(dist)
    return torch.stack(out, dim=-1)


def targets(yb: np.ndarray, cfg: dict, max_dist: int, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    gz, gy, gx = cfg["grid"]
    prob = np.stack([edt_prob(y, cfg["anisotropy"]) for y in yb])
    rays = render.golden_spiral(cfg["n_rays"], cfg["anisotropy"])
    dist = star_dist(torch.from_numpy(yb).to(device), rays, max_dist,
                     cfg["grid"])
    return (torch.from_numpy(prob[:, ::gz, ::gy, ::gx].copy()).to(device),
            dist)


def loss_fn(cfg: dict, weights, x, prob_gt, dist_gt, hp: dict
            ) -> torch.Tensor:
    prob, dist = stardist_net.forward(cfg, weights, x)
    eps = 1e-7
    p = torch.clamp(prob, eps, 1 - eps)
    y = prob_gt
    bce = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    w_fg = 1.0 + (hp["prob_fg_weight"] - 1.0) * (y > 0).float()
    loss_prob = torch.sum(w_fg * bce) / torch.sum(w_fg)
    w = prob_gt[..., None]
    loss_dist = torch.sum(w * torch.abs(dist - dist_gt)) / \
        (torch.sum(w) * dist.shape[-1] + eps)
    loss_dist = loss_dist + hp["background_reg"] * torch.mean(
        (1.0 - w) * torch.abs(dist))
    return loss_prob + hp["dist_loss_weight"] * loss_dist


class Adam:
    """optax's Adam: bias corrections in float32."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr = params, lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.count += 1
        dev = self.params[0].device
        bc1 = 1 - torch.tensor(self.b1, device=dev) ** self.count
        bc2 = 1 - torch.tensor(self.b2, device=dev) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            p.add_(-self.lr * (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))


def run_steps(cfg: dict, init, X, Y, hp: dict, n_steps: int, device):
    """The reference's first ``n_steps`` from ``init`` ({name: {"w", "b"}}
    tensors): (losses, first gradients by leaf name, parameter changes by
    leaf name after the steps)."""
    params = {n: {k: v.detach().clone().to(device).requires_grad_(True)
                  for k, v in layer.items()} for n, layer in init.items()}
    names = [(n, k) for n in sorted(params) for k in sorted(params[n])]
    leaves = [params[n][k] for n, k in names]
    opt = Adam(leaves, hp["learning_rate"])
    sampler = Sampler(hp["seed"], cfg["train_patch_size"],
                      hp["foreground_prob"])
    losses, first = [], None
    for _ in range(n_steps):
        xb, yb = sampler.batch(X, Y, hp["batch_size"])
        prob_gt, dist_gt = targets(yb, cfg, hp["max_dist"], device)
        loss = loss_fn(cfg, params, torch.from_numpy(xb).to(device),
                       prob_gt, dist_gt, hp)
        grads = torch.autograd.grad(loss, leaves)
        if first is None:
            first = {f"{n}/{k}": g.detach().clone()
                     for (n, k), g in zip(names, grads)}
        opt.step(grads)
        losses.append(float(loss.detach()))
    change = {f"{n}/{k}": (params[n][k].detach()
                           - init[n][k].to(device)) for n, k in names}
    return losses, first, change
