"""Coordinate frames for cell centres (counterpart of
``3deecelltracker_tpu/coordinates.py``).

- ``raw``: voxel coordinates (x, y, z), stored as float32 (``raw_f32``)
  and rounded on access;
- ``real``: ``raw * voxel_size``, the frame of all matching math;
- ``interp``: z multiplied by ``interpolation_factor``, the frame of the
  interpolated label images.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Coordinates:
    raw_f32: torch.Tensor
    interpolation_factor: int
    voxel_size: Tuple[float, float, float]

    @staticmethod
    def from_raw(coords, interpolation_factor: int, voxel_size,
                 device=None) -> "Coordinates":
        return Coordinates(
            torch.as_tensor(coords, dtype=torch.float32, device=device),
            int(interpolation_factor), _as_tuple3(voxel_size))

    @staticmethod
    def from_real(coords, interpolation_factor: int, voxel_size,
                  device=None) -> "Coordinates":
        vs = _as_tuple3(voxel_size)
        real = torch.as_tensor(coords, dtype=torch.float32, device=device)
        return Coordinates(real / torch.tensor(vs, dtype=torch.float32,
                                               device=real.device),
                           int(interpolation_factor), vs)

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
    def raw(self) -> torch.Tensor:
        return torch.round(self.raw_f32).to(torch.int32)

    @property
    def cell_num(self) -> int:
        return int(self.raw_f32.shape[0])


def _as_tuple3(v) -> Tuple[float, float, float]:
    vals = [float(x) for x in torch.as_tensor(v, dtype=torch.float64)
            .reshape(-1)]
    if len(vals) != 3:
        raise ValueError(f"voxel_size must have 3 entries, got {len(vals)}")
    return tuple(vals)
