"""Segment a volume too large for one backbone pass, tile by tile, on the
card (the port's counterpart of ``examples/segment_large_volume.py``).

    python -m 3deecelltracker_tpu_torch.scripts.segment_large_volume
    python -m 3deecelltracker_tpu_torch.scripts.segment_large_volume \\
        --shape 32 256 256 --device cpu
    torchrun --nproc-per-node 4 -m \\
        3deecelltracker_tpu_torch.scripts.segment_large_volume --sharded
    python -m 3deecelltracker_tpu_torch.scripts.segment_large_volume \\
        --sharded --cpu-mesh 4 --shape 32 256 256

The example's zebrafish-class (64, 512, 512) volume of uniform noise
(``np.random.default_rng(0)``), its StarDist3D config with a seeded
random init, and its tiled settings: tiles of (None, 192, 192) with a
shrink of (0, 48, 48) (below the receptive field, for speed; drop
``shrink`` for centres equal to the whole-volume pass) and 128 candidates
a tile, through ``StarDist3D.predict_instances_tiled``.  ``--repeat``
runs it again and prints each call's seconds (the first includes the
kernels' build).  ``--device cpu`` runs on the CPU.

``--sharded`` fans the tiles out over the ranks of a process group
(``StarDist3D.predict_instances_sharded``): one rank a card under
``torchrun``, or, with ``--cpu-mesh N`` (JAX's virtual CPU mesh), N
``gloo`` ranks on the CPU that this process spawns.  Without either it
raises: it does not fall back to one process.
"""

from __future__ import annotations

import argparse
import pickle
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import StarDistConfig
from ..engine.stardist import StarDist3D
from ..parallel import multihost
from ..utils.cache import enable_compilation_cache

# examples/segment_large_volume.py:58-64, 72-73
CONFIG = dict(n_rays=32, grid=(2, 4, 4), anisotropy=(2.0, 1.0, 1.0),
              unet_n_depth=1, unet_n_filter_base=8, net_conv_after_unet=16,
              train_patch_size=(16, 32, 32), prob_thresh=0.8,
              nms_thresh=0.3)
TILED = dict(shrink=(0, 48, 48), tile_candidates=128)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the example; returns ``{"shape", "labels_shape", "instances",
    "prob_map_shape", "seconds"}`` (``seconds``: one entry per call)."""
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=(64, 512, 512),
                    help="(z, y, x) volume shape")
    ap.add_argument("--tile", type=int, nargs=2, default=(192, 192),
                    help="(y, x) tile size (z untiled)")
    ap.add_argument("--sharded", action="store_true",
                    help="fan tiles out over the ranks (torchrun)")
    ap.add_argument("--cpu-mesh", type=int, default=0, metavar="N",
                    help="with --sharded: spawn N gloo ranks on the CPU")
    ap.add_argument("--repeat", type=int, default=1,
                    help="calls to time (the first builds the kernels)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    if args.sharded and args.cpu_mesh:
        return _spawn_cpu_mesh(args)
    if args.sharded:
        multihost.initialize(device=args.device)
    return _run(args)


def _run(args) -> dict:
    """The example on this process (one rank of the group with
    ``--sharded``)."""
    device = args.device
    if args.sharded and device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    model = StarDist3D(StarDistConfig(**CONFIG), max_candidates=512,
                       render_box=(9, 17, 17), device=device)
    x = np.random.default_rng(0).random(tuple(args.shape), np.float32)
    tile_shape = (None, args.tile[0], args.tile[1])
    fn = (model.predict_instances_sharded if args.sharded
          else model.predict_instances_tiled)
    seconds = []
    for _ in range(max(1, args.repeat)):
        t0 = time.perf_counter()
        (labels, details), prob_map = fn(x, tile_shape=tile_shape, **TILED)
        seconds.append(time.perf_counter() - t0)
    where = (f"sharded over {multihost.process_count()} ranks"
             if args.sharded else f"sequential tiles on {model.device}")
    if multihost.process_index() == 0:
        print(f"volume {x.shape} -> labels {labels.shape}, "
              f"{len(details['prob'])} instances, prob_map "
              f"{prob_map.shape}")
        print(f"{where}: " + ", ".join(f"{s:.3f} s" for s in seconds)
              + " (the first call builds the kernels)")
    return dict(shape=x.shape, labels_shape=labels.shape,
                instances=len(details["prob"]),
                prob_map_shape=prob_map.shape, seconds=seconds,
                labels=labels, points=details["points"], prob_map=prob_map)


def _cpu_rank(rank: int, args, store: str, out: str) -> None:
    """One spawned ``gloo`` rank of ``--cpu-mesh``; rank 0 pickles its
    result to ``out``."""
    torch.set_num_threads(1)
    multihost.initialize(num_processes=args.cpu_mesh, process_id=rank,
                         device="cpu", store=store)
    try:
        args.device = "cpu"
        result = _run(args)
        if rank == 0:
            Path(out).write_bytes(pickle.dumps(result))
    finally:
        torch.distributed.destroy_process_group()


def _spawn_cpu_mesh(args) -> dict:
    """``--cpu-mesh N``: N ``gloo`` ranks on the CPU over a ``FileStore``,
    spawned and joined here; rank 0's result."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "result.pkl")
        mp.spawn(_cpu_rank, args=(args, str(Path(tmp) / "store"), out),
                 nprocs=int(args.cpu_mesh), join=True)
        return pickle.loads(Path(out).read_bytes())


if __name__ == "__main__":
    main()
