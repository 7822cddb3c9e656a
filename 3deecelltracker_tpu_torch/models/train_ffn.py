"""FFN matcher training (counterpart of ``3deecelltracker_tpu/models/
train_ffn.py``; reference ``ffn.py:91-222``).

Per generator round the host synthesizes matched, seg-error and mismatched
point clouds (``models/synthesize.py``) from the trainer's
``np.random.RandomState``, in JAX's order; the device builds their kNN
features (``ops/knn.knn_feature_vectors_cross``) and the shuffled batches,
and runs the train step: train-mode forward, BCE, gradient, Adam
(``utils/optim.Adam``, optax's arithmetic).  One set gives 2n samples: n
positive pairs (label 0 where the point was replaced by a seg error) and n
negative pairs with mismatched partners, the sides swapped with p = 0.5.

Over a mesh (``mesh=``, JAX's ``data_axis`` sharding): every rank's
generator makes the whole batch from the same seed and the rank keeps its
rows of ``data_axis``; the batchnorms take the whole batch's statistics and
the BCE its whole mean, the gradients and the loss are summed over the axis
in one ``all_reduce`` and every rank takes the same Adam step.  The lead
rank's parameters are broadcast and it alone writes the weight files.
"""

from __future__ import annotations

from glob import glob
from pathlib import Path
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.knn import knn_feature_vectors_cross
from ..ops.pointset import normalize_points
from ..utils.checkpoint import leaves_with_paths, load_pytree, save_pytree
from ..utils.device import fresh_tensors, select_device
from ..utils.optim import Adam
from ..parallel.comm import all_reduce_grads
from ..parallel.training import (bce_from_probs, broadcast_trees_,
                                 check_trainer_mesh, lead_read, lead_write,
                                 mesh_rows)
from .ffn import ffn_apply, init_ffn
from .synthesize import add_seg_errors, affine_transform, no_match_points

FFN_WEIGHTS_NAME = "weights_training_"
AFFINE_LEVEL = 0.2           # ffn.py:23
RAND_MOVE_LEVEL = 0.001      # ffn.py:24
BATCH_SIZE = 128             # ffn.py:25
RATIO_SEG_ERROR = 0.15       # ffn.py:18
K_PTRS = 20                  # ffn.py:20
NUM_SETS = 20                # ffn.py:127
BCE_EPS = 1e-7


def clip_prob(p: torch.Tensor, eps: float = BCE_EPS) -> torch.Tensor:
    """``jnp.clip(p, eps, 1 - eps)`` as JAX evaluates it, ``min(max(eps,
    p), 1 - eps)`` with ``maximum`` / ``minimum``: at ``p == eps`` (or
    ``1 - eps``) exactly the gradient is halved, as JAX's max and min
    split a tie; ``torch.clamp`` would pass all of it."""
    lo = torch.tensor(eps, dtype=p.dtype, device=p.device)
    hi = torch.tensor(1 - eps, dtype=p.dtype, device=p.device)
    return torch.minimum(hi, torch.maximum(lo, p))


def bce_loss(logistic_out: torch.Tensor, labels: torch.Tensor,
             eps: float = BCE_EPS) -> torch.Tensor:
    p = clip_prob(logistic_out, eps)
    y = labels.to(p.dtype)
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p))


class DataGeneratorFFN:
    """Reference ``DataGeneratorFFN`` (ffn.py:91-145): endless batches
    ``(x (b, 122), y (b, 1))`` as float32 tensors on ``device``.

    ``config``: optional ``TrainFfnConfig``, overriding the batch size,
    the number of sets a round and the synthesis knobs."""

    def __init__(self, points_normalized: np.ndarray, seed: int = 0,
                 batch_size: int = BATCH_SIZE, num_sets: int = NUM_SETS,
                 config=None, device=None):
        self.device = select_device(device)
        self.points = np.asarray(points_normalized, np.float32)
        self.rng = np.random.RandomState(seed)
        if config is not None:
            batch_size = config.batch_size
            num_sets = config.num_sets
            self.affine_level = config.affine_level
            self.random_movement_level = config.random_movement_level
            self.ratio_seg_error = config.ratio_seg_error
            self.kde_bandwidth = config.kde_bandwidth
        else:
            self.affine_level = AFFINE_LEVEL
            self.random_movement_level = RAND_MOVE_LEVEL
            self.ratio_seg_error = RATIO_SEG_ERROR
            self.kde_bandwidth = 0.1
        self.batch_size = batch_size
        self.num_sets = num_sets
        pts = self._upload(self.points)
        # the reference cloud's own features are the same every set
        self._f_ref = knn_feature_vectors_cross(pts, pts, K_PTRS)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def _one_set(self) -> Tuple[torch.Tensor, np.ndarray]:
        n = self.points.shape[0]
        tgt = affine_transform(self.points, self.affine_level,
                               self.random_movement_level,
                               self.rng).astype(np.float32)
        with_err, replaced = add_seg_errors(tgt, self.ratio_seg_error,
                                            bandwidth=self.kde_bandwidth,
                                            rng=self.rng)
        with_err = with_err.astype(np.float32)
        no_match = no_match_points(n, with_err, self.rng)
        we, nm = self._upload(with_err), self._upload(no_match)
        f_match = knn_feature_vectors_cross(we, we, K_PTRS)
        f_nomatch = knn_feature_vectors_cross(we, nm, K_PTRS)
        feats_a = torch.cat([self._f_ref, self._f_ref])
        feats_b = torch.cat([f_match, f_nomatch])
        if self.rng.rand() > 0.5:
            feats_a, feats_b = feats_b, feats_a
        y = np.zeros((2 * n, 1), np.float32)
        y[:n] = 1.0
        y[:n][replaced] = 0.0
        return torch.cat([feats_a, feats_b], dim=1), y

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        while True:
            xs, ys = [], []
            for _ in range(self.num_sets):
                x, y = self._one_set()
                xs.append(x)
                ys.append(y)
            x = torch.cat(xs)
            y = np.concatenate(ys)
            order = self.rng.permutation(x.shape[0])
            x = x[torch.from_numpy(order).to(self.device)]
            y = self._upload(y[order])
            for i in range(x.shape[0] // self.batch_size):
                s = slice(i * self.batch_size, (i + 1) * self.batch_size)
                yield x[s], y[s]


def _leaves(tree) -> List[torch.Tensor]:
    return [v for _, v in leaves_with_paths(tree)]


class TrainFFN:
    """Reference ``TrainFFN`` (ffn.py:148-222).

    The parameters start from ``models.ffn.init_ffn`` with a
    ``torch.Generator`` seeded with ``seed`` (other numbers than JAX's
    init); :meth:`start_from` replaces them, e.g. with JAX's ``FFN().init``
    through ``utils.convert``.  ``seed`` also seeds the synthesis, as in
    JAX.  ``device``: the card unless ``"cpu"`` is passed.  ``mesh``: a
    ``DeviceMesh`` (``parallel.make_mesh``) that every rank of it passes,
    the batch split over its ``data_axis`` (module docstring);
    ``ValueError`` unless the batch size divides by that axis (JAX
    ``train_ffn.py:174-178``)."""

    def __init__(self, model_name: str,
                 points1_path: Optional[str] = None,
                 segmentation1_path: Optional[str] = None,
                 voxel_size=(1, 1, 1),
                 basedir: Union[str, Path] = "./ffn_models",
                 learning_rate: float = 1e-3, seed: int = 0,
                 config=None, mesh=None, data_axis: str = "data", *,
                 device=None):
        self.device = select_device(device)
        self.mesh = mesh
        self._whole = self._data = None
        if mesh is not None:
            self._whole, self._data = check_trainer_mesh(
                mesh, self.device, (data_axis,))
        if config is not None:
            learning_rate = config.learning_rate
        self.config = config
        self.path_model = Path(basedir)
        (self.path_model / "weights").mkdir(exist_ok=True, parents=True)
        self.model_name = model_name
        self.current_epoch = 1
        params, bn_state = init_ffn(torch.Generator().manual_seed(seed),
                                    self.device)
        self.params = fresh_tensors(params, self.device, True)
        self.bn_state = fresh_tensors(bn_state, self.device, False)
        broadcast_trees_(self._whole, self.params, self.bn_state)
        self.optimizer = Adam(_leaves(self.params), learning_rate)

        if points1_path is not None:
            pts = np.loadtxt(points1_path)
        elif segmentation1_path is not None:
            from ..io.imageio import imread_stack
            from ..ops.segment_reduce import center_of_mass
            paths = sorted(glob(segmentation1_path))
            if len(paths) == 0:
                raise FileNotFoundError(
                    f"No image in {segmentation1_path} was found")
            seg = imread_stack(paths).transpose(1, 2, 0).astype(np.int32)
            n = int(seg.max())
            lab = torch.from_numpy(np.ascontiguousarray(seg)).to(
                self.device)
            com = center_of_mass((lab > 0).to(torch.float32), lab, n)
            pts = com.cpu().numpy() * np.asarray(voxel_size)[None, :]
        else:
            raise ValueError(
                "Either segmentation1_path or points1_path is required")
        norm, _ = normalize_points(
            torch.from_numpy(np.asarray(pts, np.float32)))
        self.points_t1 = norm.numpy()
        self.points_generator = DataGeneratorFFN(
            self.points_t1, seed=seed, config=config, device=self.device)
        if mesh is not None:
            mesh_rows(self._data, self.points_generator.batch_size)

    def start_from(self, params) -> None:
        """Train from ``params``, the ``(params, bn_state)`` trees of
        arrays or tensors, with a fresh optimizer state, as setting them on
        JAX's trainer before its first step does.  The seeded init and the
        Adam state that ``__init__`` built are dropped.  Over a mesh, the
        lead rank's values on every rank."""
        self.params = fresh_tensors(params[0], self.device, True)
        self.bn_state = fresh_tensors(params[1], self.device, False)
        broadcast_trees_(self._whole, self.params, self.bn_state)
        self.optimizer = Adam(_leaves(self.params),
                              self.optimizer.learning_rate)

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One step on a batch: train-mode forward (the batchnorms' running
        statistics move), BCE, gradient, Adam.  Returns the loss on the
        device.  Over a mesh, ``x`` and ``y`` are this rank's rows and the
        loss the whole batch's."""
        out, new_bn = ffn_apply(self.params, self.bn_state, x, train=True,
                                group=self._data)
        loss = bce_from_probs(out, y, BCE_EPS, self._data)
        grads = torch.autograd.grad(loss, self.optimizer.params)
        loss = loss.detach()
        if self._data is not None:
            *grads, loss = all_reduce_grads(self._data,
                                            [*grads, loss.reshape(1)])
            loss = loss[0]
        self.optimizer.step(grads)
        self.bn_state = {k: {s: v.detach() for s, v in d.items()}
                         for k, d in new_bn.items()}
        return loss

    def _snapshot(self):
        return ({k: {s: v.detach() for s, v in d.items()}
                 for k, d in self.params.items()}, self.bn_state)

    def train(self, num_epochs: int = 10, iteration: int = None,
              weights_name: str = FFN_WEIGHTS_NAME,
              verbose: bool = True) -> list:
        """``num_epochs`` epochs of ``iteration + 1`` steps (the
        reference's own loop, ffn.py:208), each epoch's weights saved under
        ``weights/``, the last also as ``<model_name>.npz``.  Losses stay
        on the device until an epoch ends."""
        if iteration is None:
            iteration = (self.config.iterations_per_epoch
                         if self.config is not None else 5000)
        losses = []
        gen = iter(self.points_generator)
        end_epoch = self.current_epoch + num_epochs
        rows = slice(None) if self._data is None else \
            mesh_rows(self._data, self.points_generator.batch_size)
        for epoch in range(self.current_epoch, end_epoch):
            step_losses, n = [], 0
            for x, y in gen:
                step_losses.append(self.train_step(x[rows], y[rows]))
                n += 1
                if n > iteration:
                    break
            total = float(torch.sum(torch.stack(step_losses))) \
                if step_losses else 0.0
            losses.append(total / max(n, 1))
            if verbose:
                print(f"Epoch {epoch}: train loss {losses[-1]:.4f}")
            self._save(self.path_model / "weights" /
                       f"{weights_name}_epoch{epoch}.npz")
            self.current_epoch += 1
        self._save(self.path_model / (self.model_name + ".npz"))
        return losses

    def _save(self, path: Path) -> None:
        lead_write(self._whole, lambda: save_pytree(self._snapshot(), path))

    def select_ffn_weights(self, step: int,
                           weights_name: str = FFN_WEIGHTS_NAME) -> None:
        if step <= 0:
            raise ValueError("step should be an integer >= 1")
        snapshot = self._snapshot()
        params, self.bn_state = lead_read(self._whole, lambda: load_pytree(
            snapshot, self.path_model / "weights" /
            f"{weights_name}_epoch{step}.npz"), snapshot)
        with torch.no_grad():
            for dst, src in zip(_leaves(self.params), _leaves(params)):
                dst.copy_(src)
        broadcast_trees_(self._whole, self.params, self.bn_state)
        print(f"Loaded the trained FFN model at step {step}")
