"""3-D U-Net training (counterpart of ``3deecelltracker_tpu/models/
train_unet.py``; the reference's ``unet3d.py:282-601``).

- ``divide_img``: 50%-overlap training patches (:282-307).
- Augmentation: one random 2-D affine per sample (rotation +-90 degrees,
  shift +-0.2, shear +-0.2 degrees, horizontal flip; Keras
  ``ImageDataGenerator``'s settings, :477-478) applied to every z layer of
  the image and of its label, resampled bilinearly with reflect borders as
  ``jax.scipy.ndimage.map_coordinates`` does; the warped labels truncate to
  int after ``+ 1e-4`` as JAX's do.  The affines come from a
  ``torch.Generator`` seeded with ``seed + 1``: other numbers than JAX's
  PRNG stream draws, the same distribution.
- Training: BCE on the sigmoid output, the BatchNorms in train mode, Adam
  (``utils.optim``, optax's arithmetic); every 3x3x3 conv goes through
  ``ops.hopper_conv.Conv3x3x3BiasReLU`` (its input gradient on the
  hand-written kernels), LeakyReLU and BatchNorm after it as in the
  forward.  60 steps an epoch, the weights saved whenever the validation
  loss improves, the user picks the step (:543-588).
- Over a mesh (``mesh=``, JAX's ``parallel/training.py``): the batch is
  split on b over the mesh's ``data`` axis and on x over its ``spatial``
  axis, and each step is ``parallel.training.make_sharded_unet_train_step``'s
  (halo-exchanging convs, BatchNorm statistics and gradients summed over
  the mesh).  Every rank draws the whole batch (its start and affines) and
  augments its own rows; the lead rank's parameters are broadcast, the lead
  alone writes the weight files, and every rank takes the lead's
  validation loss.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np
import torch

from ..ops.lcn import normalize_image, normalize_label
from ..utils.checkpoint import leaves_with_paths, load_pytree, save_pytree
from ..utils.device import fresh_tensors, select_device
from ..utils.optim import Adam
from ..parallel.training import (agreed, bce_from_probs, broadcast_trees_,
                                 check_trainer_mesh, lead_read, lead_write,
                                 make_sharded_unet_train_step,
                                 make_unet_train_step, mesh_rows)
from .unet3d import UNet3D

NOT_PORTED_FIGURES = "figures are not ported yet (ROADMAP.md A.9)"


def divide_img(img: np.ndarray, unet_siz: Tuple[int, int, int]
               ) -> np.ndarray:
    """Reference ``_divide_img`` (unet3d.py:282-307): 50%-overlap patches,
    the last partial window of an axis snapped inside; (n, x, y, z, 1)."""
    x_siz, y_siz, z_siz = img.shape
    x_in, y_in, z_in = unet_siz
    out = []
    for i, j, k in itertools.product(range(x_siz * 2 // x_in),
                                     range(y_siz * 2 // y_in),
                                     range(z_siz * 2 // z_in)):
        ix = i * x_in // 2 if i * x_in // 2 + x_in <= x_siz else x_siz - x_in
        iy = j * y_in // 2 if j * y_in // 2 + y_in <= y_siz else y_siz - y_in
        iz = k * z_in // 2 if k * z_in // 2 + z_in <= z_siz else z_siz - z_in
        out.append(img[ix:ix + x_in, iy:iy + y_in, iz:iz + z_in])
    return np.expand_dims(np.asarray(out), axis=4)


def _affine_matrix(generator: torch.Generator, rotation_range=90.0,
                   shift_range=0.2, shear_range=0.2, horizontal_flip=True,
                   hw: Tuple[int, int] = (0, 0)
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random 2-D affine (Keras ``apply_transform``'s parameters) about
    the image centre: (matrix (2, 2), offset (2,)) float32 on the CPU."""
    h, w = hw
    f32 = torch.float32

    def uniform(r):
        return (torch.rand((), generator=generator, dtype=f32) * 2 - 1) * r
    theta = torch.deg2rad(uniform(rotation_range))
    tx = uniform(shift_range) * h
    ty = uniform(shift_range) * w
    shear = torch.deg2rad(uniform(shear_range))
    flip = bool(torch.rand((), generator=generator) < 0.5) and \
        horizontal_flip
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([cos_t, -sin_t]),
                       torch.stack([sin_t, cos_t])])
    sh = torch.stack([torch.stack([torch.ones((), dtype=f32),
                                   -torch.sin(shear)]),
                      torch.stack([torch.zeros((), dtype=f32),
                                   torch.cos(shear)])])
    m = rot @ sh
    if flip:
        m = m @ torch.tensor([[1.0, 0.0], [0.0, -1.0]])
    return m, torch.stack([tx, ty])


def _reflect_index(index: torch.Tensor, size: int) -> torch.Tensor:
    """``map_coordinates``' 'reflect' (d c b a | a b c d | d c b a), as
    JAX computes it: a triangular wave of period 2 * size."""
    s = 2 * size
    mirrored = torch.abs(torch.remainder(2 * index + 1 + s, 2 * s) - s)
    return torch.div(mirrored - 1, 2, rounding_mode="floor")


def _apply_affine_2d(img2d: torch.Tensor, m: torch.Tensor,
                     offset: torch.Tensor, order: int) -> torch.Tensor:
    """Inverse-warp an (h, w, ...) image (trailing axes carried along, e.g.
    every z layer at once) through the affine ``m``, ``offset`` about its
    centre, with reflect borders: ``jax.scipy.ndimage.map_coordinates`` of
    order 0 (nearest, half away from zero) or 1 (bilinear), its four
    corner terms summed in its order."""
    h, w = img2d.shape[:2]
    dev = img2d.device
    m = m.to(dev, torch.float32)
    offset = offset.to(dev, torch.float32)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    src = [m[0, 0] * yy + m[0, 1] * xx + cy + offset[0],
           m[1, 0] * yy + m[1, 1] * xx + cx + offset[1]]
    if order == 0:
        idx = [(torch.sign(c) * torch.floor(torch.abs(c) + 0.5)).long()
               for c in src]
        return img2d[_reflect_index(idx[0], h), _reflect_index(idx[1], w)]
    if order != 1:
        raise NotImplementedError("order must be 0 or 1")
    nodes = []
    for c, size in zip(src, (h, w)):
        lower = torch.floor(c)
        upper_w = c - lower
        i = lower.long()
        nodes.append([(_reflect_index(i, size), 1 - upper_w),
                      (_reflect_index(i + 1, size), upper_w)])
    trail = (None,) * (img2d.dim() - 2)
    out = None
    for (iy, wy), (ix, wx) in itertools.product(*nodes):
        term = (wy * wx)[(...,) + trail] * img2d[iy, ix]
        out = term if out is None else out + term
    return out.to(img2d.dtype)


def _warp_pair(img: torch.Tensor, lab: torch.Tensor, m: torch.Tensor,
               offset: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sample's image (h, w, z, 1) and label, every z layer through
    the same affine; the label truncated to int after ``+ 1e-4``: JAX's f32
    bilinear weights sum to 0.99999994 and would truncate interior label
    pixels to 0 (the reference interpolates in f64)."""
    img_t = _apply_affine_2d(img[..., 0], m, offset, 1)
    lab_t = _apply_affine_2d(lab[..., 0].to(torch.float32), m, offset, 1)
    return img_t[..., None], (lab_t[..., None] + 1e-4).to(torch.int32)


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  labels: torch.Tensor, rotation_range=90.0, shift_range=0.2,
                  shear_range=0.2, horizontal_flip=True):
    """One random 2-D affine per sample of (b, h, w, z, 1) images and
    labels, applied to every z layer of both."""
    b, h, w = images.shape[:3]
    draws = [_affine_matrix(generator, rotation_range, shift_range,
                            shear_range, horizontal_flip, (h, w))
             for _ in range(b)]
    return augment_with(images, labels, draws)


def augment_with(images: torch.Tensor, labels: torch.Tensor, draws
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`augment_batch` with its affines given, one (matrix, offset)
    per sample."""
    pairs = [_warp_pair(img, lab, m, off)
             for img, lab, (m, off) in zip(images, labels, draws)]
    return (torch.stack([x for x, _ in pairs]),
            torch.stack([y for _, y in pairs]))


class TrainingUNet3D:
    """The reference's ``TrainingUNet3D`` (unet3d.py:346-601) with JAX's
    arguments, folder layout and weight-selection workflow.  The
    parameters start from ``model.init`` with a ``torch.Generator`` seeded
    with ``seed`` (other numbers than JAX's init); :meth:`start_from`
    replaces them, e.g. with a JAX checkpoint.  ``device``: the card
    unless ``"cpu"`` is passed.

    ``mesh``: a ``DeviceMesh`` with ``data`` and ``spatial`` axes
    (``parallel.make_mesh``) that every rank of it passes (module
    docstring); ``ValueError`` unless ``batch_size`` divides by the data
    axis and the tile's x splits over the spatial axis into shards that
    pool without a halo (``UNet3D.check_x_shard``), ``TypeError`` for
    anything but a ``DeviceMesh``."""

    def __init__(self, noise_level: float, folder_path: Union[str, Path],
                 model: UNet3D, learning_rate: float = 1e-3, seed: int = 0,
                 batch_size: int = 8, mesh=None, config=None, *,
                 device=None):
        if config is not None:
            learning_rate = config.learning_rate
            batch_size = config.batch_size
        self.device = select_device(device)
        self.mesh = mesh
        self._whole = self._data = self._spatial = None
        if mesh is not None:
            self._whole, self._data, self._spatial = check_trainer_mesh(
                mesh, self.device, ("data", "spatial"))
            mesh_rows(self._data, batch_size)
            n_x = self._spatial.size
            mesh_rows(self._spatial, model.tile_shape[0], "tile x")
            model.check_x_shard(model.tile_shape[0] // n_x, n_x)
        self.config = config
        self.noise_level = noise_level
        self.folder_path = Path(folder_path)
        self.model = model
        self.batch_size = batch_size
        for sub in ("train_image", "train_label", "valid_image",
                    "valid_label", "models"):
            (self.folder_path / sub).mkdir(parents=True, exist_ok=True)
        self.models_path = self.folder_path / "models"
        self.learning_rate = float(learning_rate)
        self.start_from(*model.init(torch.Generator().manual_seed(seed),
                                    device=self.device))
        self._save("weights_initial.npz")
        self._gen = torch.Generator().manual_seed(seed + 1)
        self.val_losses: List[float] = []
        self.train_image = self.train_label = None
        self.valid_image = self.valid_label = None

    def start_from(self, params, bn_state) -> None:
        """Train from ``params`` and ``bn_state`` (nested dicts of arrays
        or tensors) with a fresh optimizer state, as JAX's ``retrain_unet``
        sets them and re-inits optax's state.  Over a mesh, the lead
        rank's values on every rank."""
        self.params = fresh_tensors(params, self.device, True)
        self.bn_state = fresh_tensors(bn_state, self.device, False)
        broadcast_trees_(self._whole, self.params, self.bn_state)
        self.optimizer = Adam([v for _, v in leaves_with_paths(self.params)],
                              self.learning_rate)
        if self.mesh is None:
            self._step = make_unet_train_step(self.model, self.optimizer)
        else:
            self._step, _ = make_sharded_unet_train_step(
                self.model, self.optimizer, self.mesh)

    def _save(self, name: str) -> None:
        """The parameters and BatchNorm state to ``models/<name>`` (the
        lead rank's write over a mesh)."""
        lead_write(self._whole, lambda: save_pytree(
            (self.params, self.bn_state), self.models_path / name))

    def _load(self, name: str):
        """``models/<name>`` in the trees' structure (read by the lead
        rank over a mesh; the others take its values when they are
        assigned)."""
        template = (self.params, self.bn_state)
        return lead_read(self._whole, lambda: load_pytree(
            template, self.models_path / name), template)

    # ---- data -------------------------------------------------------------
    def load_dataset(self):
        """Read the four folders of 2-D slices under ``folder_path``."""
        from ..io.imageio import load_image
        self.train_image = load_image(str(self.folder_path / "train_image"))
        self.train_label = load_image(str(self.folder_path / "train_label"))
        self.valid_image = load_image(str(self.folder_path / "valid_image"))
        self.valid_label = load_image(str(self.folder_path / "valid_label"))

    def load_dataset_arrays(self, train_image, train_label, valid_image,
                            valid_label):
        self.train_image = np.asarray(train_image)
        self.train_label = np.asarray(train_label)
        self.valid_image = np.asarray(valid_image)
        self.valid_label = np.asarray(valid_label)

    def preprocess(self):
        """Normalize the images (median, LCN) and binarize the labels on
        the device, then cut both into 50%-overlap patches (numpy, kept
        on the device too)."""
        def norm(im):
            x = torch.from_numpy(np.asarray(im, np.float32)).to(self.device)
            return normalize_image(x, self.noise_level).cpu().numpy()

        def label(im):
            return normalize_label(torch.from_numpy(np.asarray(im))).numpy()
        self.train_image_norm = norm(self.train_image)
        self.valid_image_norm = norm(self.valid_image)
        self.train_label_norm = label(self.train_label)
        self.valid_label_norm = label(self.valid_label)
        tile = self.model.tile_shape
        self.train_subimage = divide_img(self.train_image_norm, tile)
        self.valid_subimage = divide_img(self.valid_image_norm, tile)
        self.train_subcells = divide_img(self.train_label_norm, tile)
        self.valid_subcells = divide_img(self.valid_label_norm, tile)

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, dtype)
        self._train_x = dev(self.train_subimage, torch.float32)
        self._train_y = dev(self.train_subcells, torch.int32)
        self._valid_x = dev(self.valid_subimage, torch.float32)
        self._valid_y = dev(self.valid_subcells, torch.float32)

    # ---- training -----------------------------------------------------------
    def _draw_affines(self, b: int, hw: Tuple[int, int]):
        """One (matrix, offset) per sample of a batch."""
        kw = {} if self.config is None else dict(
            rotation_range=self.config.rotation_range,
            shift_range=self.config.shift_range,
            shear_range=self.config.shear_range,
            horizontal_flip=self.config.horizontal_flip)
        return [_affine_matrix(self._gen, hw=hw, **kw) for _ in range(b)]

    def _train_batch(self, rng_np: np.random.RandomState
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """An augmented batch: ``batch_size`` consecutive patches from a
        start drawn from ``rng_np`` (the reference's exclusive upper bound,
        unet3d.py:337), each through its own affine.  Over a mesh, every
        rank draws the whole batch and returns its block: its rows,
        augmented, and its x shard of them."""
        n = self.train_subimage.shape[0]
        start = rng_np.randint(0, max(n - self.batch_size, 1))
        imgs = self._train_x[start:start + self.batch_size]
        labs = self._train_y[start:start + self.batch_size]
        draws = self._draw_affines(imgs.shape[0], tuple(imgs.shape[1:3]))
        if self.mesh is None:
            return augment_with(imgs, labs, draws)
        rows = mesh_rows(self._data, imgs.shape[0])
        x, y = augment_with(imgs[rows], labs[rows], draws[rows])
        cols = mesh_rows(self._spatial, x.shape[1], "tile x")
        return x[:, cols], y[:, cols]

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Loss, gradient, one Adam update in place and the new BatchNorm
        state (``parallel.training``'s step; over a mesh ``x`` and ``y``
        are this rank's block and the loss the whole batch's); the loss
        stays on the device."""
        loss, self.bn_state = self._step(self.params, self.bn_state, x, y)
        return loss

    def validation_loss(self) -> float:
        """BCE of the eval-mode forward over every validation patch (the
        lead rank's over a mesh, where every rank computes it whole)."""
        with torch.no_grad():
            probs = self.model.apply(self.params, self.bn_state,
                                     self._valid_x)
            return agreed(self._whole,
                          float(bce_from_probs(probs, self._valid_y)))

    def _assign(self, params, bn_state) -> None:
        with torch.no_grad():
            for (_, dst), (_, src) in zip(leaves_with_paths(self.params),
                                          leaves_with_paths(params)):
                dst.copy_(src)
        self.bn_state = fresh_tensors(bn_state, self.device, False)
        broadcast_trees_(self._whole, self.params, self.bn_state)

    def train(self, iteration: int = 100, steps_per_epoch: int = None,
              weights_name: str = "weights_training_",
              verbose: bool = True):
        """From the initial weights with a fresh optimizer: ``iteration``
        epochs of ``steps_per_epoch`` steps (patch starts from
        ``np.random.RandomState(0)``), the weights saved at the first epoch
        and whenever the validation loss improves.  Returns the losses."""
        if steps_per_epoch is None:
            steps_per_epoch = (self.config.steps_per_epoch
                               if self.config is not None else 60)
        self.start_from(*self._load("weights_initial.npz"))
        self.val_losses = []
        rng_np = np.random.RandomState(0)
        for step in range(1, iteration + 1):
            for _ in range(steps_per_epoch):
                self.train_step(*self._train_batch(rng_np))
            val = self.validation_loss()
            if step == 1 or val < min(self.val_losses):
                if verbose:
                    prev = min(self.val_losses) if self.val_losses else None
                    print(f"step {step}: val_loss improved to {val:.4f}"
                          + (f" (from {prev:.4f})" if prev else ""))
                self._save(f"{weights_name}step{step}.npz")
            self.val_losses.append(val)
        return self.val_losses

    def select_weights(self, step: int,
                       weights_name: str = "weights_training_"):
        """Restore the weights of epoch ``step`` and save them as
        ``unet3_pretrained.npz``."""
        self._assign(*self._load(f"{weights_name}step{step}.npz"))
        self._save("unet3_pretrained.npz")

    # ---- inspection plots (ROADMAP.md A.9) ------------------------------------
    def draw_dataset(self, path=None):
        raise NotImplementedError(NOT_PORTED_FIGURES)

    def draw_norm_dataset(self, path=None):
        raise NotImplementedError(NOT_PORTED_FIGURES)

    def draw_divided_train_data(self, n: int = 16, path=None, seed=0):
        raise NotImplementedError(NOT_PORTED_FIGURES)

    def draw_prediction(self, path=None):
        raise NotImplementedError(NOT_PORTED_FIGURES)

