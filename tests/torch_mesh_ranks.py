"""The ranks of the port's mesh tests (``tests/test_torch_mesh_*.py``):
``gloo`` worlds spawned on the CPU over a ``FileStore``, each rank running
one file's cases through the port's mesh entry points and its own runs
without a mesh.  Imports torch and the port only (never JAX), so the
ranks are what a user's ``torchrun`` job would run.

:class:`World` starts ``world`` ranks of ``cases`` and returns every
rank's result (each rank pickles its own).  A case function takes ``(rank,
world, mesh_kwargs...)`` and runs on every rank; the runs without a mesh
go on rank 0 while the others wait, with the same threads (one a rank:
the CPU conv sums in another order on other thread counts).
"""

from __future__ import annotations

import pickle
import shutil
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import t3dct_torch  # noqa: E402,F401
from t3dct_torch.config import (SegmentationConfig,  # noqa: E402
                                StarDistConfig, TrackingConfig)
from t3dct_torch.engine.pipeline import (segment_and_track,  # noqa: E402
                                         track_timelapse)
from t3dct_torch.engine.segmentation import UNetSegmenter  # noqa: E402
from t3dct_torch.engine.stardist import (StarDist3D,  # noqa: E402
                                         predict_and_save)
from t3dct_torch.models.ffn import feature_distance_ffn  # noqa: E402
from t3dct_torch.models.stardist3d import (  # noqa: E402
    StarDist3DNet, with_intensity_path)
from t3dct_torch.models.unet3d import UNet3D  # noqa: E402
from t3dct_torch.parallel import make_mesh, multihost  # noqa: E402
from t3dct_torch.parallel.comm import barrier  # noqa: E402
from t3dct_torch.parallel.mesh import mesh_axis  # noqa: E402
from t3dct_torch.parallel.spatial import (  # noqa: E402
    make_spatially_sharded_apply)

DEADLINE = 600.0        # seconds a spawned world may take


class World:
    """``world`` spawned ``gloo`` ranks running ``cases(rank, world, root,
    **kwargs)``; :meth:`results` waits for them and returns every rank's
    result, in rank order (the caller works meanwhile)."""

    def __init__(self, world: int, cases: str, root: Path, **kwargs):
        self.world, self.cases, self.root = world, cases, Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.ctx = mp.start_processes(
            _rank, args=(world, cases, str(self.root), kwargs),
            nprocs=world, join=False, start_method="spawn")

    def results(self) -> list:
        end = time.monotonic() + DEADLINE
        while not self.ctx.join(timeout=5):
            if time.monotonic() > end:
                for p in self.ctx.processes:
                    p.terminate()
                raise TimeoutError(f"{self.cases}: the world of "
                                   f"{self.world} did not end in "
                                   f"{DEADLINE} s")
        return [pickle.loads((self.root / f"rank{r}.pkl").read_bytes())
                for r in range(self.world)]


def _rank(rank: int, world: int, cases: str, root: str, kwargs) -> None:
    torch.set_num_threads(1)
    multihost.initialize(num_processes=world, process_id=rank,
                         device="cpu", store=str(Path(root) / "store"))
    try:
        out = globals()[cases](rank, world, Path(root), **kwargs)
        assert "jax" not in sys.modules, "a rank imported jax"
        (Path(root) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def _on_rank0(rank: int, mesh, fn):
    """``fn()`` on rank 0 while the others wait; its result there."""
    out = fn() if rank == 0 else None
    barrier(mesh_axis(mesh))
    return out


# ---- the StarDist workflow (test_torch_mesh_stardist.py) ----------------

def stardist_model(sd_cfg: dict, max_candidates: int, render_box,
                   seed: int = 0) -> StarDist3D:
    """``tests/test_torch_scene.py::stardist_pair``'s port model."""
    cfg = StarDistConfig(**sd_cfg)
    params = with_intensity_path(StarDist3DNet(cfg).init(
        torch.Generator().manual_seed(seed), "cpu"), cfg)
    return StarDist3D(cfg, params=params, max_candidates=max_candidates,
                      render_box=tuple(render_box), device="cpu")


def ffn_weights():
    """``tests/test_torch_scene.py::ffn_pair``'s port weights."""
    return feature_distance_ffn(torch.Generator().manual_seed(1), "cpu")


def stardist_cases(rank: int, world: int, root: Path, pattern: str,
                   manual: str, seg: str, sd_cfg: dict, max_candidates: int,
                   render_box, voxel_size, interp: int, n_vols: int,
                   ensemble: dict) -> dict:
    """``predict_and_save``, ``segment_and_track`` in both handoffs (single
    mode) and ensemble ``track_timelapse`` over the ``seg/`` tree ``seg``,
    each over the mesh (trees ``mesh_*``) and on rank 0 without it
    (``plain_*``); the coordinates every rank returns."""
    model = stardist_model(sd_cfg, max_candidates, render_box)
    ffn = ffn_weights()
    mesh = make_mesh(world, device_type="cpu")
    t_range = (1, n_vols)
    names = [f"{m}_{k}" for k in ("device", "disk", "ens")
             for m in ("mesh", "plain")]
    if rank == 0:               # the trees' proofed vol-1 labels
        for name in names:
            shutil.copytree(manual, root / name / "manual_vol1")
    barrier(mesh_axis(mesh))

    def glob(name):
        return str(root / name / "manual_vol1" / "*.tif")

    out = {}
    predict_and_save(pattern, model, root / "mesh_pas", mesh=mesh)
    _on_rank0(rank, mesh, lambda: predict_and_save(pattern, model,
                                                   root / "plain_pas"))
    for handoff in ("device", "disk"):
        def run(name, **kw):
            return segment_and_track(
                pattern, model, root / name, glob(name), ffn, voxel_size,
                interp, t_range, TrackingConfig(), verbose=False,
                handoff=handoff, **kw)
        out[f"mesh_{handoff}"] = run(f"mesh_{handoff}", mesh=mesh)
        out[f"plain_{handoff}"] = _on_rank0(
            rank, mesh, lambda: run(f"plain_{handoff}", device="cpu"))
    # the ensemble over the given seg/ tree
    if rank == 0:
        for name in ("mesh_ens", "plain_ens"):
            shutil.copytree(seg, root / name / "seg")
    barrier(mesh_axis(mesh))

    def ens(name, **kw):
        return track_timelapse(
            root / name, glob(name), ffn, voxel_size, interp, t_range,
            grid=model.config.grid, config=TrackingConfig(**ensemble),
            verbose=False, **kw)
    out["mesh_ens"] = ens("mesh_ens", mesh=mesh)
    out["plain_ens"] = _on_rank0(rank, mesh,
                                 lambda: ens("plain_ens", device="cpu"))
    return out


# ---- tiles over the ranks (test_torch_mesh_tiles.py) --------------------

def load_unet(path):
    """(spec, params, state) that the test saved with ``torch.save``."""
    spec, params, state = torch.load(path, weights_only=False)
    return UNet3D(**spec), params, state


def tiles_cases(rank: int, world: int, root: Path, sd_cfg: dict,
                sd_model: dict, sd_params: str, x: str, tile, unet: str,
                raw: str, seg_cfg: dict, halo_raw: str) -> dict:
    """``predict_instances_sharded`` over the mesh and over the world
    (``mesh=None``), the ``UNetSegmenter``'s tile mode in f32 and bf16
    (probabilities and ``segment``), and its halo mode over a spatial
    axis of the world in f32; rank 0's runs without a mesh beside
    them."""
    x = torch.load(x, weights_only=False)
    model = StarDist3D(StarDistConfig(**sd_cfg),
                       params=torch.load(sd_params, weights_only=False),
                       device="cpu", **sd_model)
    mesh = make_mesh(world, device_type="cpu")
    out = {"sharded": model.predict_instances_sharded(
        x, mesh=mesh, tile_shape=tile),
        "sharded_world": model.predict_instances_sharded(x, tile_shape=tile),
        "tiled": _on_rank0(rank, mesh, lambda: model.predict_instances_tiled(
            x, tile_shape=tile))}
    spec, params, state = load_unet(unet)
    raw = torch.load(raw, weights_only=False)
    cfg = SegmentationConfig(**seg_cfg)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]

        def segment(**kw):
            seg = UNetSegmenter(spec, params, state, cfg, raw.shape,
                                max_cells=64, compute_dtype=dtype, **kw)
            probs = seg.predict_cellregions(raw)
            return probs, seg.segment(raw).segmentation_auto
        out[f"tiles_{tag}"] = segment(mesh=mesh)
        out[f"plain_{tag}"] = _on_rank0(rank, mesh,
                                        lambda: segment(device="cpu"))
    out["halo_f32"] = halo_probs(world, unet, halo_raw, seg_cfg)
    return out


def halo_probs(world: int, unet: str, raw: str, seg_cfg: dict
               ) -> torch.Tensor:
    """The f32 segmenter's halo mode over a (1, ``world``) mesh."""
    spec, params, state = load_unet(unet)
    raw = torch.load(raw, weights_only=False)
    mesh = make_mesh(1, world, device_type="cpu")
    seg = UNetSegmenter(spec, params, state, SegmentationConfig(**seg_cfg),
                        raw.shape, compute_dtype=torch.float32, mesh=mesh,
                        mesh_mode="halo")
    return seg.predict_cellregions(raw)


# ---- halo mode over four ranks (test_torch_mesh_unet.py) ----------------

def halo_cases(rank: int, world: int, root: Path, unet: str, raw: str,
               batch: str, seg_cfg: dict, halo: int) -> dict:
    """The f32 segmenter's halo mode over a (1, ``world``) mesh, and the
    bf16 U-Net through ``make_spatially_sharded_apply`` on ``batch``,
    recording this rank's extended shard (the model's input after the
    exchange)."""
    spec, params, state = load_unet(unet)
    mesh = make_mesh(1, world, device_type="cpu")
    seen = []

    def apply(p, s, xb):
        seen.append(xb.clone())
        return spec.apply(p, s, xb, compute_dtype=torch.bfloat16)
    fn = make_spatially_sharded_apply(apply, mesh, halo, axis="spatial")
    return {"halo_f32": halo_probs(world, unet, raw, seg_cfg),
            "bf16": fn(params, state, torch.load(batch, weights_only=False)),
            "ext": seen[0]}
