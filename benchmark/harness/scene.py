"""The one traffic generator: a recording of gaussian cells on uniform noise,
made on the device from a seed, looping over a pool of volumes.

It is the recipe of the port's bench scene (``utils/synthetic.py::
make_recording``, itself ``bench.py::make_recording``): centres drawn by
rejection so that no two cells sit closer than ``min_sep``, each cell a
gaussian blob of ``sigma`` voxels added to uniform noise of ``noise``
amplitude, every volume scaled to ``peak`` and cut to uint16, and vol 1's
truth labels painted where a cell's scaled distance is under
``label_radius``.  Two changes, so that a recording can run for as long as
a window lasts: the drift is periodic, phase ``2 pi (t - 1) / period``
(the bench's 0.35 a volume is nearly ``2 pi / 18``), and the recording is a
pool of ``pool`` volumes, each with its own noise, that volume ``t`` reads
at ``(t - 1) % pool``.  With ``pool`` a multiple of ``period`` the loop has
no jump.

Every parameter comes from a traffic file (``benchmark/traffic/*.json``);
the same seed gives the same recording.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    shape: Tuple[int, int, int]                 # (z, y, x)
    cells: int
    pool: int
    period: int
    sigma: Tuple[float, float, float] = (1.1, 3.0, 3.0)
    noise: float = 0.06
    peak: float = 50000.0
    margin: Tuple[float, float, float] = (4.0, 12.0, 12.0)
    min_sep_z: float = 2.5
    min_sep_yx: float = 9.0
    drift_yx: float = 2.5
    drift_z: float = 0.3
    drift_scale: Tuple[float, float, float] = (50.0, 30.0, 35.0)
    half_box: Tuple[int, int, int] = (4, 10, 10)
    label_radius: float = 1.2

    @staticmethod
    def from_dict(d: dict) -> "SceneSpec":
        fields = {f.name for f in dataclasses.fields(SceneSpec)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown scene keys {sorted(unknown)}")
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        spec = SceneSpec(**kw)
        if spec.pool % spec.period:
            raise ValueError(f"pool {spec.pool} is not a multiple of the "
                             f"drift period {spec.period}")
        return spec


def draw_centres(spec: SceneSpec, gen: torch.Generator) -> np.ndarray:
    """(cells, 3) zyx float64 centres at t = 1's drift origin, by rejection
    sampling: a candidate is kept when it is more than ``min_sep_z`` away
    in z or more than ``min_sep_yx`` away in yx from every kept one."""
    lo = np.asarray(spec.margin, np.float64)
    hi = np.asarray(spec.shape, np.float64) - lo
    kept = np.empty((spec.cells, 3), np.float64)
    n = 0
    tries = 0
    while n < spec.cells:
        batch = torch.rand((4096, 3), generator=gen,
                           dtype=torch.float64).numpy()
        for c in lo + batch * (hi - lo):
            tries += 1
            if n:
                d = kept[:n] - c
                if not np.all((np.abs(d[:, 0]) > spec.min_sep_z)
                              | (np.hypot(d[:, 1], d[:, 2])
                                 > spec.min_sep_yx)):
                    continue
            kept[n] = c
            n += 1
            if n == spec.cells:
                break
        if tries > 200 * spec.cells:
            raise ValueError(f"cannot place {spec.cells} cells in "
                             f"{spec.shape} at the given separation")
    return kept


def centres_at(spec: SceneSpec, c0: np.ndarray, t: int) -> np.ndarray:
    """The true zyx centres of volume ``t`` (1-based) of the loop."""
    ph = 2.0 * math.pi * ((t - 1) % spec.period) / spec.period
    sz, sy, sx = spec.drift_scale
    c = c0.copy()
    c[:, 1] += spec.drift_yx * np.sin(c0[:, 2] / sy + ph)
    c[:, 2] += spec.drift_yx * np.cos(c0[:, 1] / sx + ph)
    c[:, 0] += spec.drift_z * np.sin(c0[:, 1] / sz + ph)
    return c


class Scene:
    """The recording of one seed: ``volume(t)`` the raw uint16 (z, y, x)
    numpy volume t (1-based, looping over the pool), ``centres(t)`` its
    true centres, ``labels1`` vol 1's truth labels (z, y, x) int32 and
    ``labels`` those of every pool volume where ``all_labels`` asks."""

    def __init__(self, spec: SceneSpec, seed: int, device: torch.device,
                 all_labels: bool = False):
        self.spec = spec
        cpu_gen = torch.Generator().manual_seed(int(seed))
        self.c0 = draw_centres(spec, cpu_gen)
        dev_gen = torch.Generator(device=device).manual_seed(int(seed))
        self.pool, self.labels = render_pool(spec, self.c0, dev_gen, device,
                                             all_labels=all_labels)
        self.labels1 = self.labels[0]

    def index(self, t: int) -> int:
        return (t - 1) % self.spec.pool

    def volume(self, t: int) -> np.ndarray:
        return self.pool[self.index(t)]

    def centres(self, t: int) -> np.ndarray:
        return centres_at(self.spec, self.c0, t)


def _box_offsets(half: Sequence[int], device) -> torch.Tensor:
    """(V, 3) integer offsets of a cell's box: -h .. h per axis."""
    axes = [torch.arange(-h, h + 1, device=device) for h in half]
    g = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([a.reshape(-1) for a in g], dim=1)


def _accumulate(img: torch.Tensor, idx: torch.Tensor,
                vals: torch.Tensor) -> None:
    """``img[idx] += vals`` in a fixed order: where boxes overlap, atomic
    adds in whatever order the threads run would change the last bits, and
    so a voxel's uint16 value, from run to run of one seed."""
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        img.index_put_((idx,), vals, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(old)


def render_pool(spec: SceneSpec, c0: np.ndarray, gen: torch.Generator,
                device: torch.device, all_labels: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The pool as a (pool, z, y, x) uint16 host array and the truth
    labels (int32, vol 1's, or with ``all_labels`` every pool volume's);
    each volume is made on ``device`` with noise from ``gen``.
    A cell adds to the voxels of its box (``int(c) - h`` .. ``int(c) + h``,
    clipped to the volume), as the bench's recipe does."""
    z_, y_, x_ = spec.shape
    shape_t = torch.tensor(spec.shape, device=device)
    off = _box_offsets(spec.half_box, device)
    sig = torch.tensor(spec.sigma, dtype=torch.float32, device=device)
    out = np.empty((spec.pool,) + tuple(spec.shape), np.uint16)
    labels = np.zeros((spec.pool if all_labels else 1,) + tuple(spec.shape),
                      np.int32)
    for t in range(1, spec.pool + 1):
        c = torch.from_numpy(centres_at(spec, c0, t).astype(np.float32)
                             ).to(device)
        base = torch.floor(c).to(torch.int64)
        vox = base[:, None, :] + off[None, :, :]            # (n, V, 3)
        inside = ((vox >= 0) & (vox < shape_t)).all(dim=-1)
        d = (vox.to(torch.float32) - c[:, None, :]) / sig
        d2 = (d * d).sum(-1)
        flat = (vox[..., 0] * y_ + vox[..., 1]) * x_ + vox[..., 2]
        img = torch.rand(z_ * y_ * x_, generator=gen, device=device,
                         dtype=torch.float32) * spec.noise
        _accumulate(img, flat[inside], torch.exp(-0.5 * d2)[inside])
        vol = (img / img.max() * spec.peak).to(torch.int32)
        out[t - 1] = vol.reshape(spec.shape).cpu().numpy().astype(np.uint16)
        if t == 1 or all_labels:
            ids = torch.arange(1, spec.cells + 1, device=device,
                               dtype=torch.int32)[:, None].expand_as(d2)
            hit = inside & (d2 < spec.label_radius ** 2)
            lab = torch.zeros(z_ * y_ * x_, dtype=torch.int32, device=device)
            # the bench paints cells in order, so the higher id wins
            lab.scatter_reduce_(0, flat[hit], ids[hit], "amax")
            labels[t - 1] = lab.reshape(spec.shape).cpu().numpy()
    return out, labels
