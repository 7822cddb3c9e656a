"""Device selection with the port's precision contract.

PR-GLS does not converge without true float32 matrix products
(``3deecelltracker_tpu/ops/prgls.py:113-117``), and the NMS radius lookup and
the center of mass are HIGHEST-precision products in the JAX package.  On a
CUDA device PyTorch lets cuDNN convolutions run in TF32 by default, so the
flags are pinned wherever the port chooses its device.
"""

from __future__ import annotations

from typing import Union

import torch


def pin_float32() -> None:
    """Disable TF32 for matmuls and cuDNN convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def select_device(device: Union[str, torch.device, None]) -> torch.device:
    """Resolve ``device`` (default: CPU) and pin full float32 precision."""
    pin_float32()
    return torch.device("cpu" if device is None else device)
