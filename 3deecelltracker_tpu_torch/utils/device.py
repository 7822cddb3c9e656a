"""Device selection with the port's precision contract.

PR-GLS does not converge without true float32 matrix products
(``3deecelltracker_tpu/ops/prgls.py:113-117``), and the NMS radius lookup and
the center of mass are HIGHEST-precision products in the JAX package.  On a
CUDA device PyTorch lets cuDNN convolutions run in TF32 by default, so the
flags are pinned wherever the port chooses its device.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def pin_float32() -> None:
    """Disable TF32 for matmuls and cuDNN convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def select_device(device: Union[str, torch.device, None]) -> torch.device:
    """Resolve ``device`` and pin full float32 precision.  ``None`` means the
    first CUDA card; without one it raises rather than fall back: the CPU
    runs only when the caller asks for it (``device="cpu"``)."""
    pin_float32()
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)


def to_device(tree, device: torch.device):
    """A nested dict of arrays or tensors -> float32 tensors on ``device``
    (weights handed to the engines)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, dtype=torch.float32).to(device)


def upload_raw(vol, device: torch.device) -> torch.Tensor:
    """A raw volume on the device in its own width; uint16 travels as int16
    bits and widens there (uint16 tensors have few kernels)."""
    if isinstance(vol, torch.Tensor):
        return vol.to(device)
    vol = np.ascontiguousarray(vol)
    if vol.dtype == np.uint16:
        bits = torch.from_numpy(vol.view(np.int16)).to(device)
        return bits.to(torch.int32) & 0xFFFF
    return torch.from_numpy(vol).to(device)
