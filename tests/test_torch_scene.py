"""Shared scene and weights for the PyTorch port's parity tests, plus the
port's package-level checks (import hygiene, CPU dispatch).

The scene is the bench recipe at a small size: 12 drifting cells in
(8, 64, 48) uint16 volumes.  The StarDist weights are the port's seeded
init with an intensity pass-through path added (``with_intensity_path``),
the FFN weights ``feature_distance_ffn``: random weights made from a seed,
built once in torch and handed to both packages as the same numbers, so
the detections and the matching follow the cells.  The x and y spacings differ (1.0 vs 1.13): on the voxel
lattice with equal spacings many cells are exactly equidistant, and the
kNN order of such ties is decided by each framework's rounding noise.
"""

import contextlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t3dct_torch
from t3dct.config import StarDistConfig as JStarDistConfig
from t3dct.engine.stardist import StarDist3D as JStarDist3D
from t3dct_torch.config import StarDistConfig
from t3dct_torch.engine.stardist import StarDist3D
from t3dct_torch.models.ffn import feature_distance_ffn
from t3dct_torch.models.stardist3d import StarDist3DNet, with_intensity_path
from t3dct_torch.utils.synthetic import make_recording

REPO = Path(__file__).resolve().parents[1]
SHAPE = (8, 64, 48)                 # (z, y, x), divisible by div_by
N_CELLS = 12
VOXEL_SIZE = (1.0, 1.13, 4.7)
INTERP = 10
SD_CFG = dict(n_rays=32, grid=(1, 2, 2), anisotropy=(4.0, 1.0, 1.0),
              unet_n_filter_base=8, net_conv_after_unet=16, prob_thresh=0.3)
MAX_CANDIDATES = 64
RENDER_BOX = (5, 17, 17)


@contextlib.contextmanager
def jax_script(path, name, cache_dir):
    """A JAX-side script of the repo (``bench.py``) imported as a module.
    Importing it turns on JAX's persistent compilation cache, so the cache
    points at ``cache_dir`` while it loads, and the process's settings come
    back when the block ends."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("T3DCT_CACHE_DIR", str(cache_dir))
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        yield mod
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


@contextlib.contextmanager
def torch_threads(n):
    """Torch's CPU ops on ``n`` threads inside the block.  The refined EM
    is thousands of ops on tensors of a few thousand elements: on a host
    that other test workers share, intra-op threads spin at every op's
    barrier (an ensemble test took 73 s on 8 threads and 1.8 s on one),
    and the thread count sets the float32 summation order, so the
    iteration at which the EM's stall rule stops."""
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def recording(n_vols=3, seed=0):
    """(volumes, {t: centres zyx}, proofed vol-1 labels (x, y, z))."""
    vols, centers, lab1 = make_recording(n_vols, N_CELLS, SHAPE, seed)
    return vols, centers, lab1.transpose(1, 2, 0)


def to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.cpu().numpy()),
                                  tree)


def stardist_params(seed=0, intensity_path=True):
    cfg = StarDistConfig(**SD_CFG)
    params = StarDist3DNet(cfg).init(torch.Generator().manual_seed(seed),
                                     device="cpu")
    return with_intensity_path(params, cfg) if intensity_path else params


def stardist_pair():
    """(JAX StarDist3D, port StarDist3D) holding the same weights."""
    params = stardist_params()
    jm = JStarDist3D(JStarDistConfig(**SD_CFG), params=to_jax(params),
                     max_candidates=MAX_CANDIDATES, render_box=RENDER_BOX)
    tm = StarDist3D(StarDistConfig(**SD_CFG), params=params,
                    max_candidates=MAX_CANDIDATES, render_box=RENDER_BOX,
                    device="cpu")
    return jm, tm


def ffn_pair():
    """((JAX params, state), (torch params, state)), the same numbers."""
    p, s = feature_distance_ffn(torch.Generator().manual_seed(1), "cpu")
    return (to_jax(p), to_jax(s)), (p, s)


def test_import_hygiene_no_jax():
    """A fresh ``import t3dct_torch`` and of every module of the package
    (scripts included) leaves jax out."""
    code = ("import sys, importlib, pkgutil; sys.path.insert(0, %r); "
            "import t3dct_torch; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(t3dct_torch.__path__, "
            "'3deecelltracker_tpu_torch.')]; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', '3deecelltracker_tpu.', 't3dct.')) "
            "or m in ('t3dct', '3deecelltracker_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)" % str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("name", ["ops.hopper_conv", "models.train_unet"])
def test_alias_shares_modules(name):
    """``t3dct_torch.X`` and ``3deecelltracker_tpu_torch.X`` are one module,
    so there is one set of launch counters and a patch of a class reaches
    the package's own users.  A fresh process imports the alias's dotted
    name first, which makes a second module of any submodule the package
    does not import itself."""
    code = ("import importlib, sys; sys.path.insert(0, %r); "
            "a = importlib.import_module('t3dct_torch.%s'); "
            "b = importlib.import_module('3deecelltracker_tpu_torch.%s'); "
            "sys.exit(0 if a is b else 1)" % (str(REPO), name, name))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_recording_matches_bench_recipe():
    vols, centers, lab = recording(2)
    assert len(vols) == 2 and vols[0].shape == SHAPE
    assert vols[0].dtype == np.uint16
    assert lab.shape == (SHAPE[1], SHAPE[2], SHAPE[0])
    assert set(np.unique(lab)) == set(range(N_CELLS + 1))
    again, _, _ = recording(2)
    np.testing.assert_array_equal(vols[1], again[1])


def test_cpu_dispatch_takes_plain_path():
    """On CPU tensors the kernel wrappers run their plain versions and the
    launch counters stay 0, through the whole slice."""
    from t3dct_torch.config import TrackingConfig
    from t3dct_torch.engine.pipeline import segment_and_track_arrays
    from t3dct_torch.ops import hopper_conv, hopper_flood
    conv0 = [k.launches for k in hopper_conv.KERNELS]
    flood0 = hopper_flood.flood_slices.launches
    _, tm = stardist_pair()
    _, ffn = ffn_pair()
    vols, _, lab = recording(2)
    res = segment_and_track_arrays(vols, tm, lab, ffn, VOXEL_SIZE, INTERP,
                                   TrackingConfig(), device="cpu")
    assert res.coords[2].shape == res.coords[1].shape
    assert [k.launches for k in hopper_conv.KERNELS] == conv0 == [0] * 4
    assert hopper_flood.flood_slices.launches == flood0 == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig"])
def test_conv_wrapper_rejects_bad_input(bad):
    from t3dct_torch.ops.hopper_conv import conv3x3x3_bias_relu
    x = torch.zeros((4, 6, 5, 3))
    w = torch.zeros((3, 3, 3, 3, 8))
    b = torch.zeros((8,))
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        w = torch.zeros((3, 3, 3, 2, 8))
    else:
        x = torch.zeros((4, 5, 6, 3)).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        conv3x3x3_bias_relu(x, w, b)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_flood_wrapper_rejects_bad_input(bad):
    from t3dct_torch.ops.hopper_flood import flood_slices
    elev = torch.zeros((6, 5, 2))
    markers = torch.zeros((6, 5, 2), dtype=torch.int32)
    mask = torch.ones((6, 5, 2), dtype=torch.bool)
    if bad == "dtype":
        markers = markers.long()
    else:
        mask = torch.ones((6, 5, 3), dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        flood_slices(elev, markers, mask)
