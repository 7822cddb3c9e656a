"""Carry JAX-package weights across to the port, with numpy alone.

The JAX package stores parameter pytrees as flat ``.npz`` files keyed by
tree path (``"stem/w"``, ``"0/feat/w"``; ``utils/checkpoint.py:31-40``).
These helpers read such files and turn nested dicts of numpy arrays into
the port's dicts of float32 tensors.  Layouts are kept as they are: conv
weights stay DHWIO ``(3, 3, 3, c_in, c_out)``, dense weights
``(d_in, d_out)``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from .device import select_device


def load_npz(path: Union[str, Path]) -> Dict[str, Any]:
    """A ``save_pytree`` file as a nested dict of numpy arrays (tuple
    indices such as the ``(params, state)`` pair become keys "0", "1")."""
    tree: Dict[str, Any] = {}
    with np.load(str(path)) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return tree


def _to_tensors(tree, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def stardist_params_from_numpy(tree: Dict[str, Any], device=None
                               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """StarDist3DNet params ``{layer: {"w", "b"}}`` (numpy or JAX arrays)
    -> float32 tensors on ``device`` (``None``: the card)."""
    device = select_device(device)
    return {name: {k: _to_tensors(v, device) for k, v in layer.items()}
            for name, layer in tree.items()}


def unet_from_numpy(params: Dict[str, Any], state: Dict[str, Any],
                    device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """U-Net ``(params, state)`` pytrees (``models/unet3d.py:50-77``: per
    block ``conv`` {"w", "b"} and ``bn`` {"scale", "bias"}, ``out`` conv;
    state ``mean``/``var`` per block), numpy or JAX arrays -> float32
    tensors on ``device`` (``None``: the card), the same nesting."""
    device = select_device(device)
    return _to_tensors(params, device), _to_tensors(state, device)


def ffn_from_numpy(params: Dict[str, Any], state: Dict[str, Any],
                   device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """FFN ``(params, state)``: dense ``feat``/``comb``/``pred`` weights and
    the two batchnorms' ``scale``/``bias`` params and ``mean``/``var``
    state (``models/ffn.py:44-56``) -> float32 tensors on ``device``
    (``None``: the card)."""
    device = select_device(device)
    return _to_tensors(params, device), _to_tensors(state, device)
