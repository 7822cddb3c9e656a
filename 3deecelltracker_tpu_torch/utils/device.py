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


def prefer_cusolver() -> None:
    """Factor matrices with cuSOLVER (process-wide, on a CUDA build).
    PyTorch's default heuristic sends a batch of LU factorizations below
    512 rows to cuBLAS's batched ``getrf``, which is many times slower on
    the card than cuSOLVER for the ensemble's batched M-step solves (one
    256-row system a member, ``ops/prgls.py``); a single system already
    goes to cuSOLVER, so single mode is unchanged."""
    if torch.version.cuda is not None:
        torch.backends.cuda.preferred_linalg_library("cusolver")


def select_device(device: Union[str, torch.device, None]) -> torch.device:
    """Resolve ``device``, pin full float32 precision and cuSOLVER
    factorizations.  ``None`` means this process's CUDA card: the first,
    unless ``parallel.multihost.initialize`` put the process on card
    ``LOCAL_RANK``; without one it raises rather than fall back: the CPU
    runs only when the caller asks for it (``device="cpu"``)."""
    pin_float32()
    prefer_cusolver()
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device()
                        if torch.cuda.is_initialized() else 0)


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` is ``cuda:0``)."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def to_device(tree, device: torch.device):
    """A nested dict of arrays or tensors -> float32 tensors on ``device``
    (weights handed to the engines)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, dtype=torch.float32).to(device)


def fresh_tensors(tree, device: torch.device, requires_grad: bool):
    """A nested dict of arrays or tensors -> new float32 leaf tensors on
    ``device`` (a trainer's parameters; the caller's tensors are not
    touched)."""
    if isinstance(tree, dict):
        return {k: fresh_tensors(v, device, requires_grad)
                for k, v in tree.items()}
    t = tree.detach() if isinstance(tree, torch.Tensor) else \
        torch.from_numpy(np.array(tree, np.float32))
    return t.to(device, torch.float32).clone().requires_grad_(requires_grad)


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
