"""Coordinate frames for cell centres (counterpart of
``3deecelltracker_tpu/coordinates.py``).

- ``raw``: voxel coordinates (x, y, z), stored as float32 (``raw_f32``)
  and rounded on access;
- ``real``: ``raw * voxel_size``, the frame of all matching math;
- ``interp``: z multiplied by ``interpolation_factor``, the frame of the
  interpolated label images.

``from_raw``/``from_real``/``from_interp`` keep a tensor's own device when
``device`` is None; other inputs go to ``utils.device.select_device(device)``,
the card by default.  ``+`` and ``-`` of two sets in different frames
raise.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from .utils.device import select_device

Array = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Coordinates:
    raw_f32: torch.Tensor
    interpolation_factor: int
    voxel_size: Tuple[float, float, float]

    @staticmethod
    def from_raw(coords, interpolation_factor: int, voxel_size, *,
                 device=None) -> "Coordinates":
        return Coordinates(
            torch.as_tensor(coords, dtype=torch.float32,
                            device=_device(coords, device)),
            int(interpolation_factor), _as_tuple3(voxel_size))

    @staticmethod
    def from_real(coords, interpolation_factor: int, voxel_size, *,
                  device=None) -> "Coordinates":
        vs = _as_tuple3(voxel_size)
        real = torch.as_tensor(coords, dtype=torch.float32,
                               device=_device(coords, device))
        return Coordinates(real / torch.tensor(vs, dtype=torch.float32,
                                               device=real.device),
                           int(interpolation_factor), vs)

    @staticmethod
    def from_interp(coords, interpolation_factor: int, voxel_size, *,
                    device=None) -> "Coordinates":
        """From the interp frame: z divided by ``interpolation_factor``."""
        interp = torch.as_tensor(coords, dtype=torch.float32,
                                 device=_device(coords, device))
        scale = torch.tensor((1.0, 1.0, 1.0 / float(interpolation_factor)),
                             dtype=torch.float32, device=interp.device)
        return Coordinates(interp * scale, int(interpolation_factor),
                           _as_tuple3(voxel_size))

    @staticmethod
    def make(coords, interpolation_factor: int, voxel_size,
             dtype: str = "raw", *, device=None) -> "Coordinates":
        """The reference's constructor: ``dtype`` names the frame of
        ``coords``, ``"raw"``, ``"real"`` or ``"interp"``."""
        ctor = {"raw": Coordinates.from_raw,
                "real": Coordinates.from_real,
                "interp": Coordinates.from_interp}[dtype]
        return ctor(coords, interpolation_factor, voxel_size, device=device)

    def _scale(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32,
                            device=self.raw_f32.device)

    @property
    def real(self) -> torch.Tensor:
        return self.raw_f32 * self._scale(self.voxel_size)

    @property
    def interp(self) -> torch.Tensor:
        f = float(self.interpolation_factor)
        return torch.round(self.raw_f32 * self._scale((1.0, 1.0, f))
                           ).to(torch.int32)

    @property
    def interp_f32(self) -> torch.Tensor:
        """Unrounded interp-frame coordinates."""
        f = float(self.interpolation_factor)
        return self.raw_f32 * self._scale((1.0, 1.0, f))

    @property
    def raw(self) -> torch.Tensor:
        return torch.round(self.raw_f32).to(torch.int32)

    @property
    def cell_num(self) -> int:
        return int(self.raw_f32.shape[0])

    def _check_frame(self, other: "Coordinates") -> None:
        if (self.interpolation_factor != other.interpolation_factor
                or self.voxel_size != other.voxel_size):
            raise ValueError(
                "Coordinates frame mismatch: "
                f"interpolation_factor {self.interpolation_factor} vs "
                f"{other.interpolation_factor}, voxel_size "
                f"{self.voxel_size} vs {other.voxel_size}")

    def __add__(self, other: "Coordinates") -> "Coordinates":
        self._check_frame(other)
        return Coordinates(self.raw_f32 + other.raw_f32,
                           self.interpolation_factor, self.voxel_size)

    def __sub__(self, other: "Coordinates") -> "Coordinates":
        self._check_frame(other)
        return Coordinates(self.raw_f32 - other.raw_f32,
                           self.interpolation_factor, self.voxel_size)

    def with_raw(self, raw_f32) -> "Coordinates":
        """The same frame with other raw coordinates."""
        return Coordinates(torch.as_tensor(raw_f32, dtype=torch.float32,
                                           device=self.raw_f32.device),
                           self.interpolation_factor, self.voxel_size)


def _device(coords, device) -> torch.device:
    if device is None and isinstance(coords, torch.Tensor):
        return coords.device
    return select_device(device)


def _as_tuple3(v) -> Tuple[float, float, float]:
    vals = [float(x) for x in torch.as_tensor(v, dtype=torch.float64)
            .reshape(-1)]
    if len(vals) != 3:
        raise ValueError(f"voxel_size must have 3 entries, got {len(vals)}")
    return tuple(vals)
