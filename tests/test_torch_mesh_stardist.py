"""The v1.0 workflow over a mesh of two ``gloo`` ranks on the CPU
(``tests/torch_mesh_ranks.py::stardist_cases``, one spawned world for the
file), on the small TIFF recording of ``tests/test_torch_workflow.py``:
``predict_and_save(mesh=)``, ``segment_and_track(mesh=)`` in both
handoffs and ensemble ``track_timelapse(mesh=)``; ``predict_and_save``
and the device handoff also with the 8-bit upload (``transport="u8"``,
held to the run without a mesh; ``tests/test_torch_driver.py`` and
``test_torch_workflow.py`` hold u8 to JAX); the device handoff and the
ensemble also with the EM's compensated M-step (``m_step_refine=8``, held
to the run without a mesh; the same files hold it to JAX).

Each mesh run equals the port's own run without a mesh bit for bit: the
coordinates every rank returns and every file of the tree.  Each is held
against JAX's run over a mesh of two of conftest's CPU devices within the
bounds of the single-device parity tests of the same functions
(``tests/test_torch_workflow.py``: seg coordinates exact, ``PROB_ATOL``,
``LABELS_EQUAL``, and ``COORD_ATOL`` for every cell but at most one a
volume, under 1.5 real units; ``tests/test_torch_driver.py``'s
``COORD_ATOL`` for the device handoff).  The ensemble runs from JAX's
``seg/`` tree on both sides, so it holds the tracking alone, as the
workflow test does.  Then the mesh layer's own edges: ``make_mesh`` past
the world, a mesh whose group is gone, ``multihost`` without a group."""

import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import t3dct_torch  # noqa: F401
import torch_mesh_ranks as ranks
from t3dct.config import TrackingConfig as JTrackingConfig
from t3dct.engine.pipeline import segment_and_track as j_segment_and_track
from t3dct.engine.pipeline import track_timelapse as j_track_timelapse
from t3dct.engine.stardist import predict_and_save as j_predict_and_save
from t3dct.parallel import mesh as jmesh_mod
from t3dct.parallel import multihost as jmultihost
from t3dct_torch.engine.stardist import predict_and_save
from t3dct_torch.io import imageio
from t3dct_torch.io.artifacts import ResultsTree
from t3dct_torch.parallel import auto_mesh_shape, make_mesh, multihost
from test_torch_driver import files, manual_vol1, write_recording
from test_torch_scene import (INTERP, MAX_CANDIDATES, RENDER_BOX, SD_CFG,
                              VOXEL_SIZE, ffn_pair, recording,
                              stardist_pair)
from test_torch_workflow import (COORD_ATOL, ENSEMBLE, LABELS_EQUAL,
                                 PROB_ATOL)

N_VOLS = 5
WORLD = 2
RUNS = ["device", "disk", "ens"]
# the runs held to the run without a mesh (JAX's mesh runs are u16 only,
# without the compensated M-step)
ONE_CARD_RUNS = RUNS + ["device_u8", "device_refine", "ens_refine"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawned world's results and JAX's runs over two devices:
    ``(root, per-rank results, {run: JAX coordinates})``."""
    root = tmp_path_factory.mktemp("mesh_stardist")
    vols, _, lab = recording(N_VOLS, seed=1)
    pattern = write_recording(root, vols, lab)
    manual_vol1(root / "src", lab)
    jm, _ = stardist_pair()
    jffn, _ = ffn_pair()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    j_predict_and_save(pattern, jm, root / "jax_pas", mesh=mesh)
    ranks_run = ranks.World(
        WORLD, "stardist_cases", root / "w", pattern=pattern,
        manual=str(root / "src" / "manual_vol1"),
        seg=str(root / "jax_pas" / "seg"), sd_cfg=SD_CFG,
        max_candidates=MAX_CANDIDATES, render_box=RENDER_BOX,
        voxel_size=VOXEL_SIZE, interp=INTERP, n_vols=N_VOLS,
        ensemble=ENSEMBLE)
    want = {}
    for handoff in ("device", "disk"):
        d = root / f"jax_{handoff}"
        want[handoff] = j_segment_and_track(
            pattern, jm, d, manual_vol1(d, lab), jffn, VOXEL_SIZE, INTERP,
            (1, N_VOLS), JTrackingConfig(), verbose=False, handoff=handoff,
            mesh=mesh)
    d = root / "jax_ens"
    shutil.copytree(root / "jax_pas" / "seg", d / "seg")
    want["ens"] = j_track_timelapse(
        d, manual_vol1(d, lab), jffn, VOXEL_SIZE, INTERP, (1, N_VOLS),
        grid=tuple(SD_CFG["grid"]), config=JTrackingConfig(**ENSEMBLE),
        verbose=False, mesh=mesh)
    want = {k: {t: np.asarray(c) for t, c in v.items()}
            for k, v in want.items()}
    return root, ranks_run.results(), want


def tree_bytes(root):
    return {n: (root / n).read_bytes() for n in files(root)}


def labels(root, t):
    pat = "track_results/labels/track_results_t%06i_z*.tif" % t
    return np.stack([imageio.imread(p) for p in sorted(root.glob(pat))])


def test_mesh_predict_and_save_equals_one_card(world):
    """Rank 0 wrote the tree of the run without a mesh, byte for byte."""
    root, _, _ = world
    want = tree_bytes(root / "w" / "plain_pas")
    assert sum(n.startswith("seg/") for n in want) == 2 * N_VOLS
    assert tree_bytes(root / "w" / "mesh_pas") == want


def test_mesh_predict_and_save_u8_equals_one_card(world):
    """With the 8-bit upload too (each rank loads and encodes its own
    volumes); its seg/ is not the lossless run's."""
    root, _, _ = world
    want = tree_bytes(root / "w" / "plain_pas_u8")
    assert sum(n.startswith("seg/") for n in want) == 2 * N_VOLS
    assert tree_bytes(root / "w" / "mesh_pas_u8") == want
    assert want != tree_bytes(root / "w" / "plain_pas")


def test_mesh_predict_and_save_matches_jax_mesh(world):
    """Against JAX's ``predict_and_save`` over two devices: the same files,
    seg coordinates exact, prob maps within ``PROB_ATOL``, ``auto_vol1``
    labels equal."""
    root, _, _ = world
    got_root, want_root = root / "w" / "mesh_pas", root / "jax_pas"
    assert files(got_root) == files(want_root)
    got, want = ResultsTree(got_root), ResultsTree(want_root)
    for t in range(1, N_VOLS + 1):
        np.testing.assert_array_equal(got.load_seg_coords(t),
                                      want.load_seg_coords(t))
        np.testing.assert_allclose(got.load_seg_prob(t),
                                   want.load_seg_prob(t), atol=PROB_ATOL)
    for p in sorted((want_root / "auto_vol1").iterdir()):
        np.testing.assert_array_equal(
            imageio.imread(got_root / "auto_vol1" / p.name),
            imageio.imread(p))


@pytest.mark.parametrize("run", ONE_CARD_RUNS)
def test_mesh_run_equals_one_card(world, run):
    """Every rank returns the coordinates of the run without a mesh, bit
    for bit, and rank 0 wrote its tree byte for byte."""
    root, results, _ = world
    want = results[0][f"plain_{run}"]
    assert sorted(want) == list(range(1, N_VOLS + 1))
    for rank in range(WORLD):
        got = results[rank][f"mesh_{run}"]
        assert sorted(got) == sorted(want)
        for t in want:
            assert got[t].dtype == want[t].dtype
            np.testing.assert_array_equal(got[t], want[t])
    assert tree_bytes(root / "w" / f"mesh_{run}") == \
        tree_bytes(root / "w" / f"plain_{run}")


@pytest.mark.parametrize("run", RUNS)
def test_mesh_run_matches_jax_mesh(world, run):
    """Against JAX's run over two devices: the same files, the coordinates
    within the single-device parity bounds, labels ``LABELS_EQUAL``."""
    root, results, want = world
    got = results[0][f"mesh_{run}"]
    assert sorted(got) == sorted(want[run])
    for t in want[run]:
        assert got[t].shape == want[run][t].shape
        if run == "device":     # tests/test_torch_driver.py's bound
            np.testing.assert_allclose(got[t], want[run][t],
                                       atol=COORD_ATOL)
            continue
        off = np.abs(got[t] - want[run][t]).max(axis=1)
        assert (off > COORD_ATOL).sum() <= 1 and off.max() < 1.5, (t, off)
    got_root, want_root = root / "w" / f"mesh_{run}", root / f"jax_{run}"
    assert files(got_root) == files(want_root)
    for t in range(2, N_VOLS + 1):
        assert (labels(got_root, t) == labels(want_root, t)).mean() >= \
            LABELS_EQUAL


# ---- the mesh layer's edges, in this process -----------------------------


@pytest.fixture
def world_of_one(tmp_path):
    multihost.initialize(device="cpu", store=str(tmp_path / "store"))
    try:
        yield
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


@pytest.mark.parametrize("n_data,n_spatial", [(2, 1), (1, 2)])
def test_make_mesh_raises_past_the_world(world_of_one, n_data, n_spatial):
    """JAX's ``ValueError`` where the world holds too few ranks."""
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(n_data, n_spatial, device_type="cpu")
    mesh = make_mesh(1, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "spatial")
    assert tuple(mesh.shape) == (1, 1)


def test_mesh_whose_group_is_gone_raises(tmp_path, world_of_one):
    """A mesh whose process group was destroyed raises at the entry point;
    so does ``make_mesh`` without a group.  Nothing runs on one process
    instead."""
    mesh = make_mesh(1, device_type="cpu")
    torch.distributed.destroy_process_group()
    with pytest.raises(RuntimeError, match="not initialized"):
        predict_and_save(str(tmp_path / "r_t%03i_z*.tif"), None,
                         tmp_path / "res", mesh=mesh)
    with pytest.raises(RuntimeError, match="not initialized"):
        make_mesh(1, device_type="cpu")
    assert not (tmp_path / "res").exists()


@pytest.mark.parametrize("n", [1, 2, 3, 8, 12])
def test_mesh_helpers_match_jax(n):
    """``auto_mesh_shape`` and ``local_shard`` as JAX's; without a group a
    process is rank 0 of 1 and ``initialize`` of one process does
    nothing."""
    assert auto_mesh_shape(n) == jmesh_mod.auto_mesh_shape(n)
    assert auto_mesh_shape(n, 2) == jmesh_mod.auto_mesh_shape(n, 2)
    items = list(range(7 * n + 3))
    for pid in range(n):
        assert multihost.local_shard(items, pid, n) == \
            jmultihost.local_shard(items, pid, n)
    multihost.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)


def test_sharded_ensemble_builders_on_one_rank(world_of_one):
    """``make_sharded_ensemble_members`` / ``_step`` over a world of one
    equal the one-card fan-out and its trimmed mean bit for bit (the
    world of two runs them through ``track_timelapse(mesh=)`` above)."""
    from t3dct_torch.parallel.ensemble import (
        ensemble_member_predictions, ensemble_track_step,
        make_sharded_ensemble_members, make_sharded_ensemble_step)
    mesh = make_mesh(1, device_type="cpu")
    rng = np.random.RandomState(0)
    pts = rng.rand(32, 3) * 50
    conf = torch.from_numpy(np.stack(
        [pts + rng.randn(32, 3) for _ in range(3)]).astype(np.float32))
    seg2 = torch.from_numpy((pts + 1.0).astype(np.float32))
    params, state = ffn_pair()[1]
    args = (params, state, conf, conf.clone(), torch.ones(3, 32, dtype=bool),
            seg2, torch.ones(32, dtype=bool))
    kw = dict(max_iteration=50)
    assert torch.equal(make_sharded_ensemble_members(mesh, **kw)(*args),
                       ensemble_member_predictions(*args, **kw))
    assert torch.equal(make_sharded_ensemble_step(mesh, **kw)(*args),
                       ensemble_track_step(*args, **kw))
