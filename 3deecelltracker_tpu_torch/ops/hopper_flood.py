"""Per-slice 2-D minimax watershed flood: the CUDA kernel wrapper and its
plain version.

``flood_slices`` replaces ``3deecelltracker_tpu/ops/pallas_kernels.py::
flood_slices`` (body ``_flood_kernel``): every masked voxel of each z-slice
of an (x, y, z) stack takes the label of the marker reachable with the
smallest (max elevation along the path, path length), 4-neighbourhood,
synchronous rounds to a fixed point or ``max_iters``.  On CUDA tensors one
persistent launch of ``csrc/flood.cu`` runs every round and finds
convergence on the device (design and bound: see the note at the top of
that file); on CPU tensors :func:`flood_slices_plain` runs the same rounds
in PyTorch.  The plain version looks at its per-round change flags only
every ``CHECK_EVERY`` rounds: a converged state is a fixed point, so the
extra rounds change nothing but the round count.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..utils import cuda_build
from .neighborhood import neighbor_offsets, shift

INF = 3e38
# rounds between the plain version's host reads of the change flags (any
# value gives the same labels: a converged state is a fixed point)
CHECK_EVERY = 16
TILE = 1024       # voxels per tile of csrc/flood.cu


def _init_state(elevation: torch.Tensor, markers: torch.Tensor,
                mask: torch.Tensor):
    m = mask != 0
    is_marker = (markers > 0) & m
    lab = torch.where(is_marker, markers, 0).to(torch.int32)
    cost = torch.where(is_marker, elevation, INF).to(torch.float32)
    hops = torch.where(is_marker, 0.0, INF).to(torch.float32)
    return m, is_marker, lab, cost, hops


def flood_plain(elevation: torch.Tensor, markers: torch.Tensor,
                mask: torch.Tensor, offsets: Sequence[Tuple[int, ...]],
                max_iters: int = 512) -> Tuple[torch.Tensor, int]:
    """Minimax flood in plain PyTorch over the neighbour ``offsets`` (in
    visiting order): synchronous rounds, a voxel moving only on a strictly
    better (cost, hops), to a fixed point or ``max_iters``.  Returns
    (int32 labels, rounds run)."""
    elev = elevation.to(torch.float32)
    m, is_marker, lab, cost, hops = _init_state(elev, markers, mask)
    upd = m & ~is_marker
    rounds = 0
    while rounds < max_iters:
        flags = []
        for _ in range(min(CHECK_EVERY, max_iters - rounds)):
            best_lab, best_cost, best_hops = lab, cost, hops
            for off in offsets:
                n_lab = shift(lab, off, 0)
                n_cost = shift(cost, off, INF)
                n_hops = shift(hops, off, INF)
                cand_cost = torch.maximum(n_cost, elev)
                cand_hops = n_hops + 1.0
                better = (n_lab > 0) & (
                    (cand_cost < best_cost)
                    | ((cand_cost == best_cost) & (cand_hops < best_hops)))
                best_lab = torch.where(better, n_lab, best_lab)
                best_hops = torch.where(better, cand_hops, best_hops)
                best_cost = torch.where(better, cand_cost, best_cost)
            new_lab = torch.where(upd, best_lab, lab)
            new_cost = torch.where(upd, best_cost, cost)
            new_hops = torch.where(upd, best_hops, hops)
            flags.append(((new_lab != lab) | (new_cost != cost)
                          | (new_hops != hops)).any())
            lab, cost, hops = new_lab, new_cost, new_hops
            rounds += 1
        if not bool(torch.stack(flags).all()):
            break
    return torch.where(m, lab, 0), rounds


def flood_slices_plain(elevation: torch.Tensor, markers: torch.Tensor,
                       mask: torch.Tensor, max_iters: int = 512
                       ) -> Tuple[torch.Tensor, int]:
    """PyTorch twin of the kernel; same inputs and outputs as
    :func:`flood_slices`.  Neighbour order x-1, y-1, y+1, x+1 is
    ``neighbor_offsets(2, 1)``, with the slice axis leading."""
    offsets = [(0,) + o for o in neighbor_offsets(2, 1)]
    lab, rounds = flood_plain(elevation.permute(2, 0, 1),
                              markers.permute(2, 0, 1),
                              mask.permute(2, 0, 1), offsets, max_iters)
    return lab.permute(1, 2, 0), rounds


def _check(elevation, markers, mask) -> None:
    if elevation.dim() != 3:
        raise ValueError(f"expected an (x, y, z) stack, got "
                         f"{tuple(elevation.shape)}")
    for name, t, dt in (("elevation", elevation, torch.float32),
                        ("markers", markers, torch.int32),
                        ("mask", mask, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.shape != elevation.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(elevation.shape)}")
        if t.device != elevation.device:
            raise ValueError(f"{name} is on {t.device}, elevation on "
                             f"{elevation.device}")


def active_tiles(markers: torch.Tensor, mask: torch.Tensor,
                 tile: int = TILE) -> int:
    """How many tiles the kernel lists: runs of ``tile`` consecutive voxels
    of the flat (x, y, z) index that hold at least one updatable voxel
    (masked, not a marker).  Only those are visited by the rounds."""
    upd = ((mask != 0) & ~(markers > 0)).reshape(-1)
    pad = -upd.numel() % tile
    upd = torch.cat((upd, upd.new_zeros(pad)))
    return int(upd.view(-1, tile).any(dim=1).sum())


def _flood_cuda(elevation, markers, mask, max_iters: int
                ) -> Tuple[torch.Tensor, int]:
    lib = cuda_build.load("flood")
    fn = lib.flood_slices_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.flood_scratch_bytes
    size.argtypes = [ctypes.c_int] * 3
    size.restype = ctypes.c_longlong
    # the kernel works in the caller's (x, y, z) layout
    elev, mk, m = (t.contiguous() for t in (elevation, markers, mask))
    nx, ny, s = elev.shape
    dev = elev.device
    out = torch.empty(elev.shape, dtype=torch.int32, device=dev)
    scratch = torch.empty((size(nx, ny, s),), dtype=torch.uint8, device=dev)
    info = torch.empty((2,), dtype=torch.int32, device=dev)
    err = fn(elev.data_ptr(), mk.data_ptr(), m.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), info.data_ptr(), nx, ny, s, max_iters,
             torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "flood_slices")
    flood_slices.launches += 1
    rounds, tiles = info.tolist()       # the one host sync of a call
    flood_slices.rounds += rounds
    flood_slices.tiles = tiles
    return out, rounds


def flood_slices(elevation: torch.Tensor, markers: torch.Tensor,
                 mask: torch.Tensor, max_iters: int = 512
                 ) -> Tuple[torch.Tensor, int]:
    """Flood ``markers`` over ``elevation`` within ``mask``, independently
    in every z-slice of an (x, y, z) stack.  Returns (int32 labels (x, y, z),
    rounds run).  CUDA tensors launch the kernel once per call (counted in
    ``flood_slices.launches``; the rounds it ran add to
    ``flood_slices.rounds``, and ``flood_slices.tiles`` keeps the last
    call's tile count, :func:`active_tiles`); CPU tensors take
    :func:`flood_slices_plain`.
    """
    _check(elevation, markers, mask)
    if elevation.device.type == "cpu":
        return flood_slices_plain(elevation, markers, mask, max_iters)
    if elevation.device.type != "cuda":
        raise ValueError(f"unsupported device {elevation.device}")
    return _flood_cuda(elevation, markers, mask, max_iters)


flood_slices.launches = 0
flood_slices.rounds = 0
flood_slices.tiles = 0
