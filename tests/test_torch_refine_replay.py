"""The card's own t = 21 tracking step of the refined EM (ROADMAP C.11),
replayed on the CPU by JAX and by the port.

``3deecelltracker_tpu_torch/assets/bench/card_refine_t21.npz`` holds what
``chip_smoke.py``'s phase 29 kept of its run on an NVIDIA H100 80GB HBM3
(700 W) with the port of the commit named in its ``meta``: every argument
of the card's ``pipeline.track_from_seg`` call for t = 21 as the card
passed it (``chip_smoke.step_state``), the card's outputs (``card_*``) and
the card's coordinates of the whole run (``coords_<t>``).  On the card that
step switched one identity (row 11, from true centre 14 to 138).

Replayed from exactly those inputs with ``m_step_refine=8``, JAX's
``fused_track_from_seg`` and the port's ``track_from_seg`` on 1 and on 4
torch threads agree with each other and switch no identity: the card
departed in that single step.  Op by op against float64 on the card's own
intermediates, the first op that departed beyond its float32 rounding was
the card's ``exp`` in the EM's gaussian kernels (``ops/prgls.py::
gaussian_gram``): CUDA's ``expf`` misses the correctly rounded value by up
to 1.7 ulp, with a bias.  The port now takes that exponential correctly
rounded on the card (``ops/numerics.py::exp``), whose route is held here
against float64 on the step's own E-step arguments."""

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bench_record import ASSETS, VOXEL_SIZE, jax_ffn_weights
from test_torch_scene import REPO, torch_threads

import t3dct_torch  # noqa: F401
from t3dct.engine import pipeline as jpipeline
from t3dct.ops.subregions import SubregionAtlas as JSubregionAtlas
from t3dct_torch.engine import pipeline, tracker
from t3dct_torch.engine.metrics import tracking_id_metrics
from t3dct_torch.ops import numerics
from t3dct_torch.ops.knn import pairwise_sq_dists
from t3dct_torch.ops.prgls import gaussian_gram
from t3dct_torch.utils.synthetic import BENCH_CELLS, BENCH_SHAPE, \
    drifting_centers

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CARD_STATE = ASSETS / "card_refine_t21.npz"
T = 21
# the row the card switched at t = 21: (row, nearest true centre at t - 1
# and at t)
CARD_SWITCH = (11, 14, 138)
THREADS = (1, 4)
# JAX and the port from equal inputs: the median cell within phase 11's
# bound (chip_smoke.COORD_MEDIAN); the correction's integer rounding
# turns the refined EM's float32 noise into whole voxel steps for a few
# cells (ROADMAP C.3; 1.05-1.20 real units here), so every cell within
# twice a voxel step's diagonal in x/y
COORD_MEDIAN = 1e-2
COORD_MAX = 2 * np.sqrt(2.0)
LABELS_EQUAL = 0.995


@pytest.fixture(scope="module")
def replay():
    """The card's state, the true centres, and each replay's corrected
    coordinates (real units) and labels, with the port's EM arguments."""
    with np.load(CARD_STATE) as data:
        state = {k: data[k] for k in data.files}
    centers = drifting_centers(np.random.RandomState(0), T, BENCH_CELLS,
                               BENCH_SHAPE)
    card = {t: state[f"coords_{t}"] for t in range(1, T + 1)}
    vs = np.asarray(VOXEL_SIZE, np.float32)
    args, kwargs = chip_smoke.step_arguments(state, "cpu")

    def jax_step():
        jp, js = jax_ffn_weights()
        atlas = JSubregionAtlas(
            *(jnp.asarray(state[f"atlas_{k}"])
              for k in ("boxes", "origins", "valid")),
            int(state["atlas_interpolation_factor"]),
            tuple(int(v) for v in state["atlas_image_shape"]))
        coords, labels = jpipeline.fused_track_from_seg(
            jp, js, *(jnp.asarray(state[k])
                      for k in chip_smoke.STEP_TENSORS),
            atlas, kwargs["voxel_size"], kwargs["image_shape"],
            kwargs["beta"], kwargs["lambda_"], kwargs["ensemble"],
            kwargs["max_repetition"], kwargs["k_points"],
            kwargs["max_iteration"], kwargs["prob_grid"], False,
            kwargs["m_step_refine"], kwargs["pad_n"])
        return np.asarray(coords) * vs, np.asarray(labels)

    em_args = []
    em = tracker.prgls_with_two_ref

    def kept_em(*a, **k):
        em_args.append((a, k))
        return em(*a, **k)

    runs = {}
    # JAX's step runs on its own thread pool while the port's run
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(jax_step)
        for n in THREADS:
            with torch_threads(n), pytest.MonkeyPatch.context() as mp:
                mp.setattr(tracker, "prgls_with_two_ref", kept_em)
                out = pipeline.track_from_seg(*args, **kwargs)
            runs[f"port_{n}"] = (out.corrected_raw.numpy() * vs,
                                 out.labels.numpy())
        runs["jax"] = jax_run.result()
    return state, centers, card, runs, em_args[0]


def test_card_state_is_the_card_step(replay):
    """The asset: the card's t = 21 call of phase 29's refined run, and
    its switch of row 11 by ``tracking_id_metrics``."""
    state, centers, card, _, _ = replay
    meta = json.loads(str(state["meta"]))
    assert meta["card"].startswith("NVIDIA H100")
    assert int(state["m_step_refine"]) == 8
    np.testing.assert_array_equal(
        state["card_corrected_raw"] * np.asarray(VOXEL_SIZE, np.float32),
        card[T])
    assert tracking_id_metrics(card, centers, VOXEL_SIZE, T)[
        "id_switches"] == 1
    assert chip_smoke.switches_at(card, centers, T) == [CARD_SWITCH]


@pytest.mark.parametrize("threads", THREADS)
def test_port_replay_matches_jax(replay, threads):
    """The port's step on the CPU against JAX's from the card's inputs."""
    _, _, _, runs, _ = replay
    (want_c, want_l), (got_c, got_l) = runs["jax"], runs[f"port_{threads}"]
    d = np.linalg.norm(got_c - want_c, axis=1)
    print(f"{threads} threads: median {np.median(d):.3e}, max "
          f"{d.max():.3e} real units, labels "
          f"{(got_l == want_l).mean():.6f} equal")
    assert np.median(d) <= COORD_MEDIAN and d.max() <= COORD_MAX
    assert (got_l == want_l).mean() >= LABELS_EQUAL


@pytest.mark.parametrize("run", ["jax"] + [f"port_{n}" for n in THREADS])
def test_replay_switches_no_identity(replay, run):
    """C.11's decision: from the card's own inputs neither package
    switches row 11, or any other row, where the card did."""
    _, centers, card, runs, _ = replay
    coords = dict(card)
    coords[T] = runs[run][0]
    assert tracking_id_metrics(coords, centers, VOXEL_SIZE, T)[
        "id_switches"] == 0
    assert chip_smoke.switches_at(coords, centers, T) == []


def test_repaired_exp_against_float64(replay):
    """The repaired op: the EM's gaussian kernels of this step (the first
    E-step's and the reference Gram matrix) through the card's route of
    ``numerics.exp`` (``correctly_rounded_exp``, which it takes for CUDA
    tensors) equal the correctly rounded float64 exponential of their
    float32 arguments bit for bit, as on a sweep of the float32 range the
    EM reaches.  On CPU tensors ``gaussian_gram`` keeps torch's float32
    exp, within 0.55 ulp of the float64 value there."""
    _, _, _, _, (args, kwargs) = replay
    _, ptrs_tgt, ptrs_ref, _ = args
    valid = kwargs["tgt_mask"][:, None] & kwargs["ref_mask"][None, :]
    d2 = pairwise_sq_dists(ptrs_tgt, ptrs_ref)
    sigma_sq = torch.sum(torch.where(valid, d2, 0.0)) / (
        3.0 * torch.sum(valid.to(torch.float32)))
    sweep = -np.random.RandomState(21).exponential(20.0, 100000).astype(
        np.float32)
    for a, b, beta_sq in ((ptrs_tgt, ptrs_ref, sigma_sq),
                          (ptrs_ref, ptrs_ref, kwargs["beta"] ** 2),
                          (None, None, None)):
        arg = sweep if a is None else \
            (-pairwise_sq_dists(a, b) / (2.0 * beta_sq)).numpy()
        want = np.exp(arg.astype(np.float64))
        np.testing.assert_array_equal(
            numerics.correctly_rounded_exp(torch.from_numpy(arg)).numpy(),
            want.astype(np.float32))
        if a is not None:
            got = gaussian_gram(a, b, beta_sq).numpy()
            np.testing.assert_array_equal(
                got, torch.exp(torch.from_numpy(arg)).numpy())
            ulp = np.spacing(want.astype(np.float32)).astype(np.float64)
            live = want > 1e-30
            assert (np.abs(got - want)[live] / ulp[live]).max() <= 0.55
