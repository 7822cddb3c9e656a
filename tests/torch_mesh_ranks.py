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
from t3dct_torch.parallel.training import (  # noqa: E402
    make_sharded_unet_train_step, make_unet_train_step)

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
        torch.Generator().manual_seed(seed), device="cpu"), cfg)
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
    and ``predict_and_save`` and the device handoff with the 8-bit upload
    (``*_u8``), and the device handoff and the ensemble with the EM's
    compensated M-step (``*_refine``, ``m_step_refine=8``), each over the
    mesh (trees ``mesh_*``) and on rank 0 without it (``plain_*``); the
    coordinates every rank returns."""
    model = stardist_model(sd_cfg, max_candidates, render_box)
    ffn = ffn_weights()
    mesh = make_mesh(world, device_type="cpu")
    t_range = (1, n_vols)
    names = [f"{m}_{k}" for k in ("device", "disk", "ens", "device_u8",
                                  "device_refine", "ens_refine")
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
    predict_and_save(pattern, model, root / "mesh_pas_u8", mesh=mesh,
                     transport="u8")
    _on_rank0(rank, mesh, lambda: predict_and_save(
        pattern, model, root / "plain_pas_u8", transport="u8"))
    for handoff, transport, refine in (("device", "u16", 0),
                                       ("disk", "u16", 0),
                                       ("device", "u8", 0),
                                       ("device", "u16", 8)):
        key = handoff + ("_u8" if transport == "u8" else "") + (
            "_refine" if refine else "")

        def run(name, **kw):
            return segment_and_track(
                pattern, model, root / name, glob(name), ffn, voxel_size,
                interp, t_range, TrackingConfig(m_step_refine=refine),
                verbose=False, handoff=handoff, transport=transport, **kw)
        out[f"mesh_{key}"] = run(f"mesh_{key}", mesh=mesh)
        out[f"plain_{key}"] = _on_rank0(
            rank, mesh, lambda: run(f"plain_{key}", device="cpu"))
    # the ensemble over the given seg/ tree
    if rank == 0:
        for name in ("mesh_ens", "plain_ens", "mesh_ens_refine",
                     "plain_ens_refine"):
            shutil.copytree(seg, root / name / "seg")
    barrier(mesh_axis(mesh))

    for key, refine in (("ens", 0), ("ens_refine", 8)):
        def ens(name, **kw):
            return track_timelapse(
                root / name, glob(name), ffn, voxel_size, interp, t_range,
                grid=model.config.grid,
                config=TrackingConfig(**ensemble, m_step_refine=refine),
                verbose=False, **kw)
        out[f"mesh_{key}"] = ens(f"mesh_{key}", mesh=mesh)
        out[f"plain_{key}"] = _on_rank0(
            rank, mesh, lambda: ens(f"plain_{key}", device="cpu"))
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


# ---- data-parallel training (test_torch_mesh_train.py) ------------------

def _tree(tree):
    """A tree of tensors detached onto the CPU (a rank's result)."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def unet_step_case(spec, params, state, x, y, mesh, lr, dtensor=False):
    """One Adam step of ``spec`` on the batch ``(x, y)``: over ``mesh``
    through ``make_sharded_unet_train_step`` (this rank's block from
    ``shard``, as a ``DTensor`` of every rank's block with ``dtensor``),
    or without a mesh through ``make_unet_train_step``."""
    from t3dct_torch.parallel.multihost import global_batch_from_local
    from t3dct_torch.utils.checkpoint import leaves_with_paths
    from t3dct_torch.utils.device import fresh_tensors
    from t3dct_torch.utils.optim import Adam
    p = fresh_tensors(params, torch.device("cpu"), True)
    s = fresh_tensors(state, torch.device("cpu"), False)
    opt = Adam([v for _, v in leaves_with_paths(p)], lr)
    if mesh is None:
        loss, new_s = make_unet_train_step(spec, opt)(p, s, x, y)
    else:
        step, shard = make_sharded_unet_train_step(spec, opt, mesh)
        x, y = shard(x), shard(y)
        if dtensor:
            x, y = (global_batch_from_local(mesh, t, ("data", "spatial"))
                    for t in (x, y))
        loss, new_s = step(p, s, x, y)
    return {"loss": float(loss), "params": _tree(p), "state": _tree(new_s)}


def halo_grads_case(mesh, x, w1, b1, w2, b2, r):
    """Two 3x3x3 convs (ReLU after the first) and ``sum(out * r)`` over
    this rank's x shard of the spatial axis, halos exchanged; dx of the
    shard gathered over the axis, dw and db summed over it.  Without a
    mesh, the same on the whole tensor."""
    from t3dct_torch.models import layers as L
    from t3dct_torch.parallel.comm import all_gather_tensors, \
        all_reduce_grads
    ax = None if mesh is None else mesh_axis(mesh, "spatial")
    if ax is not None:
        per = x.shape[1] // ax.size
        x, r = (t[:, ax.index * per:(ax.index + 1) * per] for t in (x, r))
    x = x.clone().requires_grad_(True)
    ws = [t.clone().requires_grad_(True) for t in (w1, b1, w2, b2)]
    h = L.conv3d({"w": ws[0], "b": ws[1]}, x, relu=True, spatial=ax)
    out = L.conv3d({"w": ws[2], "b": ws[3]}, h, spatial=ax)
    dx, *dws = torch.autograd.grad(torch.sum(out * r), [x, *ws])
    if ax is not None:
        dx = torch.cat([g[0] for g in all_gather_tensors(ax, [dx])], dim=1)
        dws = all_reduce_grads(ax, dws)
    return {"dx": dx, "dw1": dws[0], "db1": dws[1], "dw2": dws[2],
            "db2": dws[3]}


def _files(folder: Path) -> list:
    return sorted(str(p.relative_to(folder)) for p in folder.rglob("*")
                  if p.is_file())


def train_cases(rank: int, world: int, root: Path, unet: str, halo: str,
                sd: str, ffn: str, trainer: str) -> dict:
    """The file's cases on every rank (``tests/test_torch_mesh_train.py``
    holds them): the sharded U-Net step over (2, 2) and (1, 4) meshes, the
    halo conv's gradients over 4 x shards, ``global_batch_from_local``,
    the misaligned shapes' ``ValueError``s, and the three trainers over
    meshes with each rank's own folder; rank 0's runs without a mesh
    beside them."""
    from t3dct_torch.config import TrainFfnConfig
    from t3dct_torch.models.train_ffn import TrainFFN
    from t3dct_torch.models.train_stardist import TrainStarDist3D
    from t3dct_torch.models.train_unet import TrainingUNet3D
    from t3dct_torch.parallel.multihost import global_batch_from_local
    cpu = dict(device_type="cpu")
    meshes = {"2x2": make_mesh(2, 2, **cpu), "1x4": make_mesh(1, 4, **cpu),
              "4x1": make_mesh(4, 1, **cpu)}
    lead = meshes["2x2"]
    out = {}
    # (a) the U-Net step
    u = torch.load(unet, weights_only=False)
    spec = UNet3D(**u["spec"])
    for name in ("2x2", "1x4"):
        out[f"step_{name}"] = unet_step_case(
            spec, u["params"], u["state"], u["x"], u["y"], meshes[name],
            u["lr"])
    out["step_plain"] = _on_rank0(rank, lead, lambda: unet_step_case(
        spec, u["params"], u["state"], u["x"], u["y"], None, u["lr"]))
    # (e) the halo's adjoint over 4 x shards
    h = torch.load(halo, weights_only=False)
    out["halo"] = halo_grads_case(meshes["1x4"], **h)
    # (f) a DTensor of every rank's block
    step, shard = make_sharded_unet_train_step(
        spec, None, meshes["2x2"])
    block = shard(u["x"])
    dt = global_batch_from_local(meshes["2x2"], block, ("data", "spatial"))
    out["dtensor"] = {"full": dt.full_tensor(), "local": dt.to_local(),
                      "block": block,
                      "placements": [str(p) for p in dt.placements]}
    out["step_dtensor"] = unet_step_case(
        spec, u["params"], u["state"], u["x"], u["y"], meshes["2x2"],
        u["lr"], dtensor=True)
    # (g) misaligned shapes
    errors = {}
    for tag, fn in (
            ("x_shard", lambda: make_sharded_unet_train_step(
                spec, None, meshes["1x4"])[1](u["x"][:, :12])),
            ("x_split", lambda: make_sharded_unet_train_step(
                spec, None, meshes["1x4"])[1](u["x"][:, :14])),
            ("batch", lambda: shard(u["x"][:3])),
            ("trainer_tile", lambda: TrainingUNet3D(
                1.0, root / f"bad{rank}", UNet3D(**dict(
                    u["spec"], tile_shape=(12, 16, 4))),
                batch_size=4, mesh=meshes["1x4"], device="cpu")),
            ("ffn_batch", lambda: TrainFFN(
                "bad", points1_path=ffn_points(ffn),
                basedir=root / f"bad_ffn{rank}", mesh=meshes["4x1"],
                config=TrainFfnConfig(batch_size=30), device="cpu"))):
        try:
            fn()
            errors[tag] = None
        except ValueError as e:
            errors[tag] = str(e)
    out["errors"] = errors
    # (b) the StarDist trainer, (c) the FFN trainer, and the U-Net trainer
    out.update(stardist_train_case(rank, root, sd, meshes, lead))
    out.update(ffn_train_case(rank, root, ffn, meshes["4x1"], lead))
    out.update(unet_train_case(rank, root, trainer, meshes["2x2"]))
    return out


def ffn_points(ffn: str) -> str:
    return torch.load(ffn, weights_only=False)["points"]


def stardist_train_case(rank, root, sd, meshes, lead):
    """``TrainStarDist3D.train`` (epochs of one step) from JAX's init over
    (4, 1) and (2, 2) (the spatial ranks replicas), each rank in its own
    folder, and on rank 0 without a mesh."""
    from t3dct_torch.models.train_stardist import TrainStarDist3D
    d = torch.load(sd, weights_only=False)
    cfg = StarDistConfig(**d["cfg"])

    def run(name, mesh):
        tr = TrainStarDist3D(cfg, basedir=root / f"sd_{name}_{rank}",
                             device="cpu", mesh=mesh, **d["trainer"])
        tr.start_from(d["params"])
        losses = tr.train([d["img"]], [d["lab"]], epochs=d["steps"],
                          steps_per_epoch=1, verbose=False)
        return {"losses": losses, "params": _tree(tr.params),
                "files": _files(root / f"sd_{name}_{rank}")}
    return {"sd_4x1": run("4x1", meshes["4x1"]),
            "sd_2x2": run("2x2", meshes["2x2"]),
            "sd_plain": _on_rank0(rank, lead, lambda: run("plain", None))}


def ffn_train_case(rank, root, ffn, mesh, lead):
    """``TrainFFN.train`` (epochs of one step) from JAX's init over
    (4, 1), each rank in its own folder, and on rank 0 without a mesh."""
    from t3dct_torch.models.train_ffn import TrainFFN
    d = torch.load(ffn, weights_only=False)

    def run(name, mesh):
        folder = root / f"ffn_{name}_{rank}"
        tf = TrainFFN("m", points1_path=d["points"], basedir=folder,
                      seed=0, device="cpu", mesh=mesh)
        tf.start_from((d["params"], d["state"]))
        losses = tf.train(num_epochs=d["epochs"], iteration=0,
                          verbose=False)
        return {"losses": losses, "params": _tree(tf.params),
                "state": _tree(tf.bn_state), "files": _files(folder)}
    return {"ffn_4x1": run("4x1", mesh),
            "ffn_plain": _on_rank0(rank, lead, lambda: run("plain", None))}


def unet_train_case(rank, root, trainer, mesh):
    """``TrainingUNet3D.train`` (2 epochs of 2 steps) and
    ``select_weights`` over a (2, 2) mesh, each rank in its own folder, and
    on rank 0 without a mesh: both draw their batches from the same
    seeds."""
    from t3dct_torch.models.train_unet import TrainingUNet3D
    d = torch.load(trainer, weights_only=False)
    spec = UNet3D(**d["spec"])

    def run(name, mesh):
        folder = root / f"unet_{name}_{rank}"
        tr = TrainingUNet3D(d["noise"], folder, spec, batch_size=4,
                            mesh=mesh, device="cpu")
        tr.start_from(d["params"], d["state"])
        tr.load_dataset_arrays(d["img"], d["lab"], d["img"], d["lab"])
        tr.preprocess()
        val = tr.train(iteration=2, steps_per_epoch=2, verbose=False)
        tr.select_weights(1)
        return {"val": val, "params": _tree(tr.params),
                "state": _tree(tr.bn_state), "files": _files(folder)}
    return {"unet_2x2": run("2x2", mesh),
            "unet_plain": _on_rank0(rank, mesh, lambda: run("plain", None))}
