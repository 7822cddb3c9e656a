"""Star-convex polyhedron rays (counterpart of
``3deecelltracker_tpu/ops/rays.py``): golden-spiral unit directions in
(z, y, x) order, the nearest-ray radius lookup NMS and the render use,
polyhedron volumes and their per-ray weights, interior sampling, and the quantized-direction ray LUT
(the JAX package keeps it as a measured-slower alternative to the argmax;
so does the port)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def rays_golden_spiral(n: int = 96,
                       anisotropy: Optional[Tuple[float, float, float]]
                       = None) -> np.ndarray:
    """(n, 3) unit vectors in (z, y, x) order (stardist Rays_GoldenSpiral).
    Host numpy, the same arithmetic as the JAX package."""
    s = 3.6 / np.sqrt(n)
    delta = 2.0 / n
    z = 1.0 - delta / 2.0
    longitude = 0.0
    verts = []
    for _ in range(n):
        r = np.sqrt(max(1.0 - z * z, 0.0))
        verts.append((z, r * np.sin(longitude), r * np.cos(longitude)))
        z -= delta
        longitude += s / max(r, 1e-12)
    v = np.asarray(verts, np.float64)
    if anisotropy is not None:
        v = v / np.asarray(anisotropy, np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def rays_volume_weights(rays: np.ndarray) -> np.ndarray:
    """Per-ray solid-angle weights for volume estimation: each ray owns
    ~4 pi / n of the sphere, so vol ~ sum_k w_k r_k^3 with w = 4 pi / (3 n)
    (float32, host numpy as JAX's)."""
    n = rays.shape[0]
    return np.full((n,), 4.0 * np.pi / (3.0 * n), np.float32)


def sample_directions_fibonacci(s: int) -> np.ndarray:
    """Deterministic quasi-uniform unit directions for MC overlap."""
    return rays_golden_spiral(s)


def polyhedron_volumes(dists: torch.Tensor, rays: torch.Tensor
                       ) -> torch.Tensor:
    """Approximate volumes of (k, n_rays) polyhedra: each ray owns
    4 pi / n of the sphere."""
    w = 4.0 * math.pi / (3.0 * rays.shape[0])
    return w * torch.sum(dists.to(torch.float32) ** 3, dim=-1)


def nearest_ray_lut(rays: np.ndarray, n_theta: int = 90,
                    n_phi: int = 180) -> np.ndarray:
    """LUT[i_theta, i_phi] = index of the nearest ray for directions in
    that spherical bin (host numpy, the JAX package's arithmetic)."""
    rays = np.asarray(rays, np.float64)
    theta = (np.arange(n_theta) + 0.5) / n_theta * np.pi
    phi = (np.arange(n_phi) + 0.5) / n_phi * 2 * np.pi - np.pi
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack([np.cos(tt), np.sin(tt) * np.sin(pp),
                     np.sin(tt) * np.cos(pp)], axis=-1)
    return np.argmax(dirs @ rays.T, axis=-1).astype(np.int32)


def lut_ray_index(lut: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Nearest-ray indices for unit (z, y, x) directions via the LUT."""
    n_theta, n_phi = lut.shape
    theta = torch.arccos(torch.clamp(dirs[..., 0], -1.0, 1.0))
    phi = torch.atan2(dirs[..., 1], dirs[..., 2])
    it = torch.clamp((theta / math.pi * n_theta).to(torch.int64), 0,
                     n_theta - 1)
    ip = torch.clamp(((phi + math.pi) / (2 * math.pi) * n_phi)
                     .to(torch.int64), 0, n_phi - 1)
    return lut[it, ip]


def sample_points_in_polyhedron(center: torch.Tensor, dists: torch.Tensor,
                                rays: torch.Tensor, dirs: torch.Tensor,
                                radii_fracs: np.ndarray) -> torch.Tensor:
    """Quasi-MC interior points of one star polyhedron: center (3,),
    dists (n_rays,), dirs (s, 3), radii_fracs (f,) -> (s * f, 3)."""
    r = radius_toward(dists, rays, dirs)                        # (s,)
    fr = torch.as_tensor(radii_fracs, dtype=torch.float32,
                         device=dirs.device)
    pts = center[None, None, :] + (r[:, None, None] * fr[None, :, None]) \
        * dirs[:, None, :]
    return pts.reshape(-1, 3)


def nearest_ray(directions: torch.Tensor, rays: torch.Tensor,
                chunk: int = 1 << 18) -> torch.Tensor:
    """Index of the nearest ray (largest dot product; the first on ties)
    per direction, in chunks that bound the (directions, n_rays)
    similarity buffer."""
    flat = directions.reshape(-1, 3)
    idx = torch.cat([torch.argmax(c @ rays.T, dim=-1)
                     for c in torch.split(flat, chunk)])
    return idx.reshape(directions.shape[:-1])


def radius_toward(dists: torch.Tensor, rays: torch.Tensor,
                  directions: torch.Tensor) -> torch.Tensor:
    """Radius of each polyhedron toward unit ``directions`` (m, 3):
    dists (..., n_rays) -> (..., m), the nearest ray's length."""
    return dists[..., nearest_ray(directions, rays)]


def radius_gather(dirs: torch.Tensor, cand_dists: torch.Tensor,
                  rays: torch.Tensor) -> torch.Tensor:
    """Per-element nearest-ray radius: dirs (..., 3), cand_dists
    (..., n_rays) broadcast against dirs[..., 0].  The JAX package writes
    this gather as a HIGHEST-precision one-hot product, which is exact;
    a gather is the same numbers."""
    idx = nearest_ray(dirs, rays)
    d = cand_dists.expand(*idx.shape, cand_dists.shape[-1])
    return torch.gather(d, -1, idx.unsqueeze(-1)).squeeze(-1)
