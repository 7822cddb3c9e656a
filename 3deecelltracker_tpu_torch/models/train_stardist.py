"""StarDist3D training (counterpart of ``3deecelltracker_tpu/models/
train_stardist.py``; the reference trains through stardist's Keras
``fit``, config heuristics ``stardistwrapper.py:213-281``, augmenter
:330-364).

A step: random patches of ``train_patch_size`` from (image, label)
volumes, foreground-biased, with yx flips/rotations and an intensity
change (host numpy, the trainer's ``np.random.RandomState`` consumed in
JAX's order) -> the GT on the device (``ops.stardist_gt``: ``edt_prob`` and
``star_dist3d``, at the grid's voxels) -> stardist's loss (BCE on the
object probability, optionally foreground-weighted, plus the
prob-weighted ray-distance MAE with its background term, weights 1 : 0.2)
-> its gradient (every 3x3x3 conv through ``ops.hopper_conv.
Conv3x3x3BiasReLU``) -> Adam (``utils.optim``, optax's arithmetic).

Over a mesh (``mesh=``, JAX's ``data_axis`` sharding): every rank draws the
whole batch from the same sampler and keeps its rows of ``data_axis``
(the mesh's other axes hold replicas), builds their GT, and computes its
term of the whole batch's loss (the means' denominators summed over the
axis); the gradients and the loss are summed over the axis in one
``all_reduce`` and every rank takes the same Adam step.  The lead rank's
parameters are broadcast, every rank takes its validation loss, and it
alone writes the model folder.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import StarDistConfig
from ..ops.rays import rays_golden_spiral
from ..ops.stardist_gt import edt_prob, star_dist3d
from ..utils.checkpoint import leaves_with_paths, load_pytree
from ..utils.device import fresh_tensors, select_device
from ..utils.optim import Adam
from ..parallel.comm import all_reduce_grads
from ..parallel.training import (agreed, broadcast_trees_,
                                 check_trainer_mesh, lead_read, lead_write,
                                 mesh_rows)
from .stardist3d import StarDist3DNet
from .train_ffn import clip_prob

GT_MAX_LABELS = 512


def random_fliprot(img: np.ndarray, mask: np.ndarray,
                   rng: np.random.RandomState,
                   axis=(1, 2)) -> Tuple[np.ndarray, np.ndarray]:
    """yx permutation + flips (``stardistwrapper.py:330-348``)."""
    perm = tuple(rng.permutation(axis))
    transpose_axis = np.arange(mask.ndim)
    for a, p in zip(axis, perm):
        transpose_axis[a] = p
    img = img.transpose(tuple(transpose_axis))
    mask = mask.transpose(tuple(transpose_axis))
    for ax in axis:
        if rng.rand() > 0.5:
            img = np.flip(img, axis=ax)
            mask = np.flip(mask, axis=ax)
    return img, mask


def random_intensity_change(img: np.ndarray,
                            rng: np.random.RandomState) -> np.ndarray:
    """``stardistwrapper.py:350-352``."""
    return img * rng.uniform(0.6, 2.0) + rng.uniform(-0.2, 0.2)


def augmenter(x: np.ndarray, y: np.ndarray,
              rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    """``stardistwrapper.augmenter`` (:355-364)."""
    x, y = random_fliprot(x, y, rng)
    x = random_intensity_change(x, rng)
    return x, y


class TrainStarDist3D:
    """Trainer for ``engine.stardist.StarDist3D`` models, with JAX's
    arguments and defaults (see its docstring for ``batch_size``,
    ``background_reg``, ``foreground_prob`` and ``prob_fg_weight``).

    The parameters start from ``StarDist3DNet.init`` with a
    ``torch.Generator`` seeded with ``seed`` (other numbers than JAX's
    init); :meth:`start_from` replaces them, e.g. with JAX's init through
    ``utils.convert``.  ``seed`` also seeds the patch sampler, as in JAX.
    ``device``: the card unless ``"cpu"`` is passed.  ``mesh``: a
    ``DeviceMesh`` (``parallel.make_mesh``) that every rank of it passes,
    the batch split over its ``data_axis`` (module docstring);
    ``ValueError`` unless ``batch_size`` divides by that axis."""

    def __init__(self, config: StarDistConfig,
                 basedir: Union[str, Path] = "stardist_models",
                 model_name: str = "stardist",
                 learning_rate: float = 3e-4,
                 dist_loss_weight: float = 0.2,
                 max_dist: int = 32, seed: int = 0,
                 batch_size: int = 2,
                 prob_fg_weight: float = 1.0,
                 background_reg: float = 1e-4,
                 foreground_prob: float = 0.9,
                 mesh=None, data_axis: str = "data", *, device=None):
        self.device = select_device(device)
        self.mesh = mesh
        self._whole = self._data = None
        self._rows = slice(None)
        if mesh is not None:
            self._whole, self._data = check_trainer_mesh(
                mesh, self.device, (data_axis,))
            self._rows = mesh_rows(self._data, int(batch_size))
        self.config = config
        self.net = StarDist3DNet(config)
        self.params = fresh_tensors(
            self.net.init(torch.Generator().manual_seed(seed), self.device),
            self.device, True)
        broadcast_trees_(self._whole, self.params)
        self.optimizer = Adam([v for _, v in
                               leaves_with_paths(self.params)],
                              learning_rate)
        self.rays = rays_golden_spiral(config.n_rays, config.anisotropy)
        self.dist_loss_weight = dist_loss_weight
        self.prob_fg_weight = float(prob_fg_weight)
        self.background_reg = float(background_reg)
        self.foreground_prob = float(foreground_prob)
        self._fg_cache = {}      # id(label volume) -> (volume, fg coords)
        self.max_dist = max_dist
        self.basedir = Path(basedir)
        self.model_name = model_name
        self.rng = np.random.RandomState(seed)
        self.batch_size = int(batch_size)
        self.val_losses: List[float] = []

    def start_from(self, params) -> None:
        """Train from ``params`` (``{layer: {"w", "b"}}`` of arrays or
        tensors) with a fresh optimizer state, as setting ``params`` on
        JAX's trainer before its first step does.  The seeded init and the
        Adam state that ``__init__`` built are dropped.  Over a mesh, the
        lead rank's values on every rank."""
        self.params = fresh_tensors(params, self.device, True)
        broadcast_trees_(self._whole, self.params)
        self.optimizer = Adam([v for _, v in
                               leaves_with_paths(self.params)],
                              self.optimizer.learning_rate)

    # ---- GT -------------------------------------------------------------
    def make_gt(self, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(b, z, y, x) int labels on the device -> (prob_gt (b, z', y',
        x'), dist_gt (..., n_rays)) at the grid's voxels."""
        gz, gy, gx = self.config.grid
        prob_gt = edt_prob(labels, max_labels=GT_MAX_LABELS,
                           anisotropy=self.config.anisotropy)
        dist_gt = star_dist3d(labels, self.rays, max_dist=self.max_dist,
                              grid=self.config.grid)
        return prob_gt[:, ::gz, ::gy, ::gx], dist_gt

    # ---- loss -----------------------------------------------------------
    def loss(self, params, x: torch.Tensor, prob_gt: torch.Tensor,
             dist_gt: torch.Tensor, axis=None) -> torch.Tensor:
        """JAX's ``_loss`` (``models/train_stardist.py:154-175``): x (b, z,
        y, x); prob_gt (b, gz, gy, gx); dist_gt (..., rays).  ``axis``: the
        mesh axis (``parallel.mesh.MeshAxis``) whose ranks hold the batch's
        rows, each a block of this shape; this rank's term of the whole
        batch's loss, every mean's denominator (``sum(w_fg)``, ``sum(w)``,
        the counts) the whole batch's, which carries no gradient."""
        prob, dist = self.net.apply(params, x[..., None])
        prob = prob[..., 0]
        eps = 1e-7
        p = clip_prob(prob, eps)
        y = prob_gt
        bce = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        w = prob_gt[..., None]
        weighted = self.prob_fg_weight != 1.0
        w_fg = 1.0 + (self.prob_fg_weight - 1.0) * (y > 0) if weighted \
            else None
        sum_w = torch.sum(w)
        sum_fg = torch.sum(w_fg) if weighted else sum_w
        if axis is not None:
            sum_w, sum_fg = all_reduce_grads(axis, [sum_w, sum_fg])

        def mean(t):
            if axis is None:
                return torch.mean(t)
            return torch.sum(t) / (t.numel() * axis.size)
        loss_prob = torch.sum(w_fg * bce) / sum_fg if weighted else mean(bce)
        loss_dist = torch.sum(w * torch.abs(dist - dist_gt)) / \
            (sum_w * dist.shape[-1] + eps)
        if self.background_reg > 0:
            loss_dist = loss_dist + self.background_reg * mean(
                (1.0 - w) * torch.abs(dist))
        return loss_prob + self.dist_loss_weight * loss_dist

    def train_step(self, x: torch.Tensor, prob_gt: torch.Tensor,
                   dist_gt: torch.Tensor) -> torch.Tensor:
        """Loss, gradient and one Adam update in place; the loss stays on
        the device.  Over a mesh, ``x`` and the GT are this rank's rows and
        the loss the whole batch's."""
        loss = self.loss(self.params, x, prob_gt, dist_gt, self._data)
        grads = torch.autograd.grad(loss, self.optimizer.params)
        loss = loss.detach()
        if self._data is not None:
            *grads, loss = all_reduce_grads(self._data,
                                            [*grads, loss.reshape(1)])
            loss = loss[0]
        self.optimizer.step(grads)
        return loss

    # ---- data ------------------------------------------------------------
    def _fg_indices(self, y: np.ndarray) -> np.ndarray:
        """Cached foreground voxel coordinates of a label volume
        (stardist's ``train_sample_cache``), scoped to one :meth:`train`
        call: the stored reference keeps ``y`` alive, so the identity guard
        cannot be fooled by a reused ``id``."""
        cached = self._fg_cache.get(id(y))
        if cached is None or cached[0] is not y:
            self._fg_cache[id(y)] = (y, np.argwhere(y > 0))
            cached = self._fg_cache[id(y)]
        return cached[1]

    def _sample_patch(self, X: List[np.ndarray], Y: List[np.ndarray]):
        i = self.rng.randint(len(X))
        x, y = X[i], Y[i]
        patch = self.config.train_patch_size
        starts = None
        if self.foreground_prob > 0 and \
                self.rng.rand() < self.foreground_prob:
            fg = self._fg_indices(y)
            if len(fg):
                c = fg[self.rng.randint(len(fg))]
                starts = [self.rng.randint(max(0, cc - p + 1),
                                           min(cc, s - p) + 1)
                          for cc, p, s in zip(c, patch, y.shape)]
        if starts is None:
            starts = [self.rng.randint(0, max(s - p, 0) + 1)
                      for p, s in zip(patch, y.shape)]
        sz, sy, sx = starts
        pz, py, px = patch
        xp = x[sz:sz + pz, sy:sy + py, sx:sx + px]
        yp = y[sz:sz + pz, sy:sy + py, sx:sx + px]
        return augmenter(xp.astype(np.float32), yp.astype(np.int32),
                         self.rng)

    def sample_batch(self, X: List[np.ndarray], Y: List[np.ndarray],
                     rows: slice = slice(None)
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``batch_size`` patches drawn, and ``rows`` of them on the device
        with their GT: (x, prob_gt, dist_gt)."""
        pairs = [self._sample_patch(X, Y)
                 for _ in range(self.batch_size)][rows]
        xb = np.stack([np.ascontiguousarray(x) for x, _ in pairs])
        yb = np.stack([np.ascontiguousarray(y) for _, y in pairs])
        xb = torch.from_numpy(xb).to(self.device)
        prob_gt, dist_gt = self.make_gt(torch.from_numpy(yb).to(
            self.device))
        return xb, prob_gt, dist_gt

    @property
    def learning_rate(self) -> float:
        """The rate as optax's state holds it, in float32."""
        return float(np.float32(self.optimizer.learning_rate))

    def _val_loss(self, val_batches) -> float:
        """The mean loss of the whole validation batches (the lead rank's
        over a mesh)."""
        with torch.no_grad():
            return agreed(self._whole, float(np.mean(
                [float(self.loss(self.params, *b)) for b in val_batches])))

    def _assign(self, tree) -> None:
        """Copy ``tree``'s values into the parameters in place (the lead
        rank's over a mesh)."""
        with torch.no_grad():
            for (_, dst), (_, src) in zip(leaves_with_paths(self.params),
                                          leaves_with_paths(tree)):
                dst.copy_(src)
        broadcast_trees_(self._whole, self.params)

    # ---- loop ------------------------------------------------------------
    def train(self, X: List[np.ndarray], Y: List[np.ndarray],
              epochs: int = 10, steps_per_epoch: int = 100,
              X_val: Optional[List[np.ndarray]] = None,
              Y_val: Optional[List[np.ndarray]] = None,
              lr_reduce_factor: float = 0.5, lr_patience: int = 40,
              n_val_batches: int = 4, keep_best: bool = True,
              verbose: bool = True) -> List[float]:
        """Keras ``model.train`` with stardist's default callbacks:
        validation volumes give a per-epoch val loss (fixed patches drawn
        under seed 12345), ``ReduceLROnPlateau(factor, patience)`` on it,
        and the best-val weights are kept; without X_val the plain loop.
        Saves the model folder at the end; returns the mean loss per
        epoch."""
        for x, y in zip(X, Y):
            for s, p in zip(x.shape, self.config.train_patch_size):
                if s < p:
                    raise ValueError(
                        f"volume shape {x.shape} smaller than patch "
                        f"{self.config.train_patch_size}")
        self._fg_cache.clear()
        val_batches = []
        if X_val is not None:
            val_rng_state = self.rng.get_state()
            self.rng.seed(12345)
            for _ in range(n_val_batches):
                val_batches.append(self.sample_batch(X_val, Y_val))
            self.rng.set_state(val_rng_state)
        self.val_losses = []
        best_val, best_params, plateau = np.inf, None, 0
        losses = []
        for epoch in range(1, epochs + 1):
            step_losses = [self.train_step(*self.sample_batch(X, Y,
                                                              self._rows))
                           for _ in range(steps_per_epoch)]
            total = float(torch.sum(torch.stack(step_losses)))
            losses.append(total / steps_per_epoch)
            msg = f"epoch {epoch}: loss {losses[-1]:.4f}"
            if val_batches:
                vl = self._val_loss(val_batches)
                self.val_losses.append(vl)
                msg += f", val_loss {vl:.4f}, lr {self.learning_rate:.2e}"
                if vl < best_val - 1e-9:
                    best_val, plateau = vl, 0
                    if keep_best:
                        best_params = {k: {s: v.detach().clone()
                                           for s, v in d.items()}
                                       for k, d in self.params.items()}
                else:
                    plateau += 1
                    if plateau >= lr_patience:
                        # JAX keeps the rate as float32 in optax's state
                        self.optimizer.learning_rate = float(np.float32(
                            self.learning_rate * lr_reduce_factor))
                        plateau = 0
                        msg += " (lr reduced)"
            if verbose:
                print(msg)
        if keep_best and best_params is not None:
            self._assign(best_params)
        self._fg_cache.clear()
        self.save()
        return losses

    def save(self) -> None:
        """The model folder (the lead rank's write over a mesh)."""
        from ..engine.stardist import StarDist3D
        params = {k: {s: v.detach() for s, v in d.items()}
                  for k, d in self.params.items()}
        lead_write(self._whole, lambda: StarDist3D(
            self.config, params=params, device=self.device).save(
            self.basedir / self.model_name))

    def load(self) -> None:
        self._assign(lead_read(self._whole, lambda: load_pytree(
            self.params, self.basedir / self.model_name / "weights.npz"),
            self.params))
