"""Parameter trees to ``.npz`` and back, in the JAX package's layout
(counterpart of ``3deecelltracker_tpu/utils/checkpoint.py``).

A tree is nested dicts, tuples and lists of tensors (or arrays).  Each leaf
is stored under its path, the keys and indices joined by ``/`` as JAX's
``_path_str`` joins a ``tree_flatten_with_path`` path (``"stem/w"``,
``"0/feat/w"``), so JAX's ``load_pytree`` reads the port's files and
:func:`load_pytree` reads JAX's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterator, Tuple, Union

import numpy as np
import torch


def leaves_with_paths(tree: Any, prefix: str = "") -> Iterator[
        Tuple[str, Any]]:
    """``(path, leaf)`` pairs of ``tree``; dict keys in sorted order, as
    JAX flattens a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_pytree(tree: Any, path: Union[str, Path]) -> None:
    """Save to exactly ``path`` (``np.savez`` on a file name would append
    ``.npz`` when it is missing; writing through an open file keeps it)."""
    arrays = {p: _numpy(v) for p, v in leaves_with_paths(tree)}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_pytree(template: Any, path: Union[str, Path]) -> Any:
    """The arrays saved under ``path`` in the structure of ``template``,
    each leaf a float tensor on its template leaf's device (a template leaf
    that is not a tensor gives a tensor on the CPU).  A missing leaf or a
    shape that differs raises."""
    with np.load(str(path)) as data:
        def build(node, prefix):
            if isinstance(node, dict):
                return {k: build(v, f"{prefix}{k}/") for k, v in
                        node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(build(v, f"{prefix}{i}/")
                                  for i, v in enumerate(node))
            key = prefix[:-1]
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key}")
            arr = data[key]
            if arr.shape != tuple(np.shape(_numpy(node))):
                raise ValueError(f"leaf {key}: shape {arr.shape} != "
                                 f"template {tuple(np.shape(_numpy(node)))}")
            dev = node.device if isinstance(node, torch.Tensor) else "cpu"
            return torch.from_numpy(np.array(arr)).to(dev)
        return build(template, "")
