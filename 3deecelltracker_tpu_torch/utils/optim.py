"""Adam as optax computes it, written as tensor ops.

The JAX trainers use ``optax.adam`` (the StarDist trainer under
``optax.inject_hyperparams`` with ``b1``, ``b2`` and ``eps`` static, so that
only the learning rate lives in the optimizer state and can change between
epochs).  :class:`Adam` takes optax's steps in optax's order:

    mu    = (1 - b1) * g + b1 * mu
    nu    = (1 - b2) * g**2 + b2 * nu
    count = count + 1
    mu_hat, nu_hat = mu / (1 - b1**count), nu / (1 - b2**count)
    p     = p + (-lr) * (mu_hat / (sqrt(nu_hat) + eps))

with the bias corrections in float32 and divided by as tensors on the
device (PyTorch turns a division by a Python number into a product with its
reciprocal on the card).  ``torch.optim.Adam`` computes ``sqrt(nu) /
sqrt(1 - b2**count) + eps`` with a float64 correction instead, which rounds
differently.

Parameters are updated in place under ``torch.no_grad()``, on the tensors
themselves: that bumps each tensor's version counter, which the conv's
packed-weight cache (``ops/hopper_conv.py::cached_pack``) keys on.  A write
through ``.data`` would not, and the card would run the next forward on the
weights packed before the update.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .checkpoint import leaves_with_paths


class Adam:
    """optax's ``adam(learning_rate, b1, b2, eps)`` over a list of tensors.
    ``learning_rate`` may be changed between steps (optax's
    ``inject_hyperparams``)."""

    def __init__(self, params: Sequence[torch.Tensor],
                 learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        dev = self.params[0].device
        self._decays = [torch.tensor(d, dtype=torch.float32, device=dev)
                        for d in (self.b1, self.b2)]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of every parameter in place from ``grads`` (one per
        parameter, in order)."""
        self.count += 1
        # 1 - b**count in float32 on the device (no upload a step)
        bc1, bc2 = (1 - d ** self.count for d in self._decays)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-self.learning_rate * u)


def update_norms(params, params0) -> np.ndarray:
    """``|theta - theta_0|`` of every parameter leaf (in ``save_pytree``'s
    order), float64: how far training has moved each tensor.  ``params``
    and ``params0`` are trees of tensors or arrays of one structure."""
    def arr(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().double().numpy()
        return np.asarray(v, np.float64)
    return np.array([np.linalg.norm(arr(a) - arr(b)) for (_, a), (_, b) in
                     zip(leaves_with_paths(params),
                         leaves_with_paths(params0))])


def update_norms_start(tree):
    """A detached copy of a tree of tensors (the reference point of
    :func:`update_norms`)."""
    if isinstance(tree, dict):
        return {k: update_norms_start(v) for k, v in tree.items()}
    return tree.detach().clone()


def record_update_norms(trainer) -> List[np.ndarray]:
    """Wrap ``trainer.train_step`` so that each step appends the update
    norms of ``trainer.params`` from where they stood at this call
    (:func:`update_norms`) to the returned list."""
    start = update_norms_start(trainer.params)
    step = trainer.train_step
    norms: List[np.ndarray] = []

    def train_step(*args, **kwargs):
        out = step(*args, **kwargs)
        norms.append(update_norms(trainer.params, start))
        return out
    trainer.train_step = train_step
    return norms
