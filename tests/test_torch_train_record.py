"""The committed training records (``3deecelltracker_tpu_torch/assets/
train/``): JAX's initial parameters and JAX's first 30 training steps of
the bench recipe, which ``chip_smoke.py`` phase 14 holds the card's
trainers to.

The recipe is ``bench.py``'s (``:63-73``, ``get_trained_model`` :214-231,
``train_ffn`` :240-262): StarDist3D with 96 rays, grid (1, 2, 2),
anisotropy (9.2, 1, 1), patch (24, 96, 96), batch 2, learning rate 3e-3,
``max_dist`` 12, ``prob_fg_weight`` 64 and seed 0 on vol 1 of the bench
scene (``utils/synthetic.make_recording``) and its ground truth; the FFN
with seed 0 on the vol-1 cloud of JAX's bench run
(``assets/bench/jax_record.npz``'s ``seg_coords_1`` times the voxel size).
That cloud sits on the voxel lattice, so many of its neighbours are
exactly equidistant, and which of them comes first in a kNN feature row
is decided by the last bit of the normalized points: the port's
normalization (float64 sums) parts from JAX's (float32) by an ulp in most
coordinates, which turns the first FFN loss 2e-3 away.  So the record
keeps JAX's normalized cloud (``ffn_points_t1``), and the FFN steps are
held with it fed to the port's generator; the port's own normalization is
held to it within 1e-6.

The StarDist recipe is chaotic: its second step's loss spikes to 6.9, and
JAX's own runs from its init nudged by one ulp (``sd_losses_ulp``, every
weight up, and ``sd_losses_nudged``, one run per seed of ``NUDGE_SEEDS``
with a random sign each, also recorded) part from the record by more than
1e-4 at step 2 and by up to tens of percent past step 16.  So
``chip_smoke.py`` holds each StarDist step through step ``PER_STEP`` (1e-4
for the first five, 1e-2 after, or ``SPREAD_FACTOR`` times the nudged
runs' largest departure where that is larger) and the rest by their mean
within ``SPREAD_FACTOR`` times the nudged runs' largest.  Each record step
is one step of JAX's own loop: 30 one-step epochs of ``train``, so the
losses are the steps' and the random stream is the recipe's.  Regenerate
them (JAX, on the CPU, about 20 minutes) with

    python tests/test_torch_train_record.py --write

or add only the random-sign runs to the record with ``--write-nudges``.

Past step ``PER_STEP`` the loss trace cannot tell a broken trainer from a
working one (with every 3x3x3 dW zeroed the port's trainer still lands
inside JAX's loss spread), so the record also keeps, per step and per
parameter leaf, the update norm ``|theta_t - theta_0|`` of JAX's run
(``sd_update_norms``) and of each nudged run (``sd_update_norms_ulp``,
``sd_update_norms_nudged``), leaves in ``save_pytree``'s order
(``sd_update_leaves``).  Steps ``PER_STEP + 1``-30 are held by the mean
update norm of each leaf over them, relative to JAX's: the root mean
square over the 28 leaves must stay within ``SPREAD_FACTOR`` times the
largest of JAX's nudged runs (at least ``LATER_TOL``).  A leaf that does
not train is 100% off, which alone moves the statistic by 0.19; JAX's own
runs depart by 0.016-0.024.

The tier-1 tests check the records, hold the initial parameters to JAX's
inits, run the port's first StarDist step and first FFN steps on the CPU
against the record, hold each of JAX's nudged runs to the others' update
norm bound, and show the planted dW-zeroed fault rejected by it; the
``slow`` tests run five StarDist steps, and all 30 against the late-step
statistic."""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_scene import REPO  # noqa: E402

import t3dct_torch  # noqa: E402,F401
from t3dct.config import StarDistConfig as JStarDistConfig  # noqa: E402
from t3dct.models.train_ffn import TrainFFN as JTrainFFN  # noqa: E402
from t3dct.models.train_stardist import (  # noqa: E402
    TrainStarDist3D as JTrainStarDist3D)
from t3dct.utils.checkpoint import save_pytree as jsave  # noqa: E402
from t3dct_torch.config import StarDistConfig  # noqa: E402
from t3dct_torch.io.imageio import percentile_normalize  # noqa: E402
from t3dct_torch.models.train_ffn import (  # noqa: E402
    DataGeneratorFFN, TrainFFN)
from t3dct_torch.models.train_stardist import TrainStarDist3D  # noqa: E402
from t3dct_torch.utils.checkpoint import leaves_with_paths  # noqa: E402
from t3dct_torch.utils.convert import load_npz  # noqa: E402
from t3dct_torch.utils.optim import (record_update_norms,  # noqa: E402
                                     update_norms)
from t3dct_torch.utils.synthetic import make_recording  # noqa: E402

ASSETS = REPO / "3deecelltracker_tpu_torch" / "assets" / "train"
BENCH = REPO / "3deecelltracker_tpu_torch" / "assets" / "bench"
RECORD = ASSETS / "jax_train_record.npz"
SD_INIT = ASSETS / "sd_init.npz"
FFN_INIT = ASSETS / "ffn_init.npz"
STEPS = 30
# bench.py's recipe (:55-73, :214-231, :240-262)
SHAPE, N_CELLS = (24, 401, 168), 150
VOXEL_SIZE = (1.0, 1.0, 9.2)
SD_CONFIG = dict(n_rays=96, grid=(1, 2, 2), anisotropy=(9.2, 1.0, 1.0),
                 train_patch_size=(24, 96, 96), prob_thresh=0.3)
SD_TRAINER = dict(max_dist=12, learning_rate=3e-3, prob_fg_weight=64.0,
                  seed=0)
FFN_SEED = 0
# the seeds of the random-sign one-ulp nudges of JAX's StarDist init
NUDGE_SEEDS = tuple(range(1, 9))
# chip_smoke.py phase 14's bounds on the losses, relative: each of the
# first steps, each step through PER_STEP (or SPREAD_FACTOR times JAX's
# own one-ulp spread where that is larger), then the mean of the rest (see
# the note on the recipe's chaos above)
FIRST_STEPS, FIRST_TOL, LATER_TOL = 5, 1e-4, 1e-2
PER_STEP, SPREAD_FACTOR = 16, 2.0


def vol1():
    """The bench scene's vol 1, normalized as ``get_trained_model`` does,
    and its ground-truth labels, (z, y, x)."""
    vols, _, lab1 = make_recording(1, N_CELLS, SHAPE)
    return percentile_normalize(vols[0].astype(np.float32)), lab1


def ffn_points(path: Path) -> Path:
    """The vol-1 cloud of JAX's bench run times the voxel size, as
    ``train_ffn`` writes it for the trainer."""
    with np.load(BENCH / "jax_record.npz") as rec:
        coords1 = rec["seg_coords_1"].astype(np.float32)
    np.savetxt(path, coords1 * np.asarray(VOXEL_SIZE, np.float32))
    return path


def jax_update_norms(trainer) -> list:
    """Wrap a JAX trainer's jitted step so that each step appends the
    update norm of every parameter leaf from where it stood at this call
    to the returned list (``utils.optim.update_norms``)."""
    start = jax.tree_util.tree_map(np.asarray, trainer.params)
    step = trainer._step
    norms = []

    def recorded(params, *args):
        out = step(params, *args)
        norms.append(update_norms(jax.device_get(out[0]), start))
        return out
    trainer._step = recorded
    return norms


def write_records(work: Path) -> dict:
    """JAX's initial parameters and its first ``STEPS`` steps of each
    trainer, into ``ASSETS``."""
    ASSETS.mkdir(parents=True, exist_ok=True)
    img, lab = vol1()
    jt = JTrainStarDist3D(JStarDistConfig(**SD_CONFIG),
                          basedir=work / "sd", **SD_TRAINER)
    jsave(jt.params, SD_INIT)
    leaves = [k for k, _ in leaves_with_paths(jt.params)]
    norms = jax_update_norms(jt)
    sd_losses = jt.train([img], [lab], epochs=STEPS, steps_per_epoch=1,
                         verbose=False)
    # JAX's own sensitivity: the same run from its init nudged by one ulp
    sd_losses_ulp, norms_ulp = nudged_run(img, lab, work / "sd_ulp", None)
    sd_losses_nudged, norms_nudged = nudged_runs(img, lab, work)
    jf = JTrainFFN("ffn", points1_path=str(ffn_points(work / "pts.txt")),
                   basedir=work / "ffn", seed=FFN_SEED)
    jsave((jf.params, jf.bn_state), FFN_INIT)
    points_t1 = np.array(jf.points_t1)
    ffn_losses = jf.train(num_epochs=STEPS, iteration=0, verbose=False)
    recipe = dict(sd_config=SD_CONFIG, sd_trainer=SD_TRAINER,
                  ffn_seed=FFN_SEED, steps=STEPS, voxel_size=VOXEL_SIZE)
    np.savez(RECORD, sd_losses=np.asarray(sd_losses, np.float64),
             sd_losses_ulp=np.asarray(sd_losses_ulp, np.float64),
             sd_losses_nudged=sd_losses_nudged,
             sd_update_norms=np.asarray(norms),
             sd_update_norms_ulp=norms_ulp,
             sd_update_norms_nudged=norms_nudged,
             sd_update_leaves=json.dumps(leaves),
             ffn_losses=np.asarray(ffn_losses, np.float64),
             ffn_points_t1=points_t1.astype(np.float32),
             recipe=json.dumps(recipe))
    return dict(sd_losses=sd_losses, sd_losses_ulp=sd_losses_ulp,
                sd_losses_nudged=sd_losses_nudged.tolist(),
                ffn_losses=ffn_losses)


def nudged_run(img, lab, work: Path, seed):
    """JAX's ``STEPS`` StarDist steps of the recipe from its init with
    every parameter moved by one ulp: up with ``seed=None``, else up or
    down by a sign drawn from ``np.random.RandomState(seed)``.  Returns the
    losses and the update norms (steps, leaves)."""
    jn = JTrainStarDist3D(JStarDistConfig(**SD_CONFIG), basedir=work,
                          **SD_TRAINER)
    rng = None if seed is None else np.random.RandomState(seed)

    def nudge(a):
        a = np.asarray(a)
        to = np.float32(np.inf) if rng is None else np.where(
            rng.rand(*a.shape) < 0.5, np.float32(-np.inf),
            np.float32(np.inf))
        return jax.numpy.asarray(np.nextafter(a, to).astype(np.float32))
    jn.params = jax.tree_util.tree_map(nudge, jn.params)
    norms = jax_update_norms(jn)
    losses = jn.train([img], [lab], epochs=STEPS, steps_per_epoch=1,
                      verbose=False)
    return losses, np.asarray(norms)


def nudged_runs(img, lab, work: Path):
    """JAX's losses (len(NUDGE_SEEDS), STEPS) and update norms (runs,
    STEPS, leaves) under one-ulp nudges of random sign, one run per
    seed."""
    runs = [nudged_run(img, lab, work / f"sd_nudge{s}", s)
            for s in NUDGE_SEEDS]
    return (np.asarray([r[0] for r in runs], np.float64),
            np.stack([r[1] for r in runs]))


def write_nudges(work: Path) -> dict:
    """Redo the random-sign runs of the committed record, the rest of it
    unchanged."""
    img, lab = vol1()
    with np.load(RECORD) as data:
        rec = {k: data[k] for k in data.files}
    rec["sd_losses_nudged"], rec["sd_update_norms_nudged"] = nudged_runs(
        img, lab, work)
    np.savez(RECORD, **rec)
    return dict(sd_losses_nudged=rec["sd_losses_nudged"].tolist())


def late_norm_departures(got, want, spread):
    """The late-step statistic (``chip_smoke.py``'s): per parameter leaf,
    the mean update norm over steps ``PER_STEP + 1``-30 of ``got`` (steps,
    leaves) against ``want``'s, relative; their root mean square over the
    leaves is the run's departure, bounded by ``SPREAD_FACTOR`` times the
    largest departure of the runs in ``spread`` (runs, steps, leaves), at
    least ``LATER_TOL``.  Returns (per-leaf departures, the departure, its
    bound)."""
    late = slice(PER_STEP, None)
    w = np.asarray(want)[late].mean(0)

    def rel(run):
        return np.abs(np.asarray(run)[late].mean(0) - w) / w

    def rms(run):
        return float(np.sqrt(np.mean(rel(run) ** 2)))
    bound = max(LATER_TOL, SPREAD_FACTOR * max(rms(r) for r in spread))
    return rel(got), rms(got), bound


def sd_norm_spread(record):
    """JAX's nudged runs' update norms: (runs, steps, leaves)."""
    return np.concatenate([record["sd_update_norms_ulp"][None],
                           record["sd_update_norms_nudged"]])


@pytest.fixture(scope="module")
def record():
    with np.load(RECORD) as data:
        return {k: data[k] for k in data.files}


def test_records_are_the_recipe(record):
    for path in (RECORD, SD_INIT, FFN_INIT):
        assert path.is_file(), path
    recipe = json.loads(str(record["recipe"]))
    assert recipe["sd_config"] == json.loads(json.dumps(SD_CONFIG))
    assert recipe["sd_trainer"] == SD_TRAINER
    assert recipe["steps"] == STEPS
    with np.load(BENCH / "jax_record.npz") as rec:
        n1 = rec["seg_coords_1"].shape[0]
    assert record["ffn_points_t1"].shape == (n1, 3)
    for key in ("sd_losses", "sd_losses_ulp", "ffn_losses"):
        assert record[key].shape == (STEPS,)
        assert np.isfinite(record[key]).all()
    assert record["sd_losses_nudged"].shape == (len(NUDGE_SEEDS), STEPS)
    assert np.isfinite(record["sd_losses_nudged"]).all()
    leaves = json.loads(str(record["sd_update_leaves"]))
    with np.load(SD_INIT) as init:
        assert leaves == sorted(init.files)
    assert record["sd_update_norms"].shape == (STEPS, len(leaves))
    assert sd_norm_spread(record).shape == (len(NUDGE_SEEDS) + 1, STEPS,
                                            len(leaves))
    # every leaf trains, and moves further as the steps go
    assert (record["sd_update_norms"][PER_STEP:] > 0).all()
    assert (record["sd_update_norms"][-1] > record["sd_update_norms"][0]
            ).mean() > 0.9
    # a nudge does not move the first step's loss beyond its bound
    np.testing.assert_allclose(record["sd_losses_nudged"][:, 0],
                               record["sd_losses"][0], rtol=FIRST_TOL)
    # the recipe trains: the last steps' losses are below the first's
    assert record["sd_losses"][-5:].mean() < record["sd_losses"][:5].mean()
    assert record["ffn_losses"][-5:].mean() < record["ffn_losses"][:5].mean()
    total = sum(p.stat().st_size for p in ASSETS.iterdir())
    assert total < 12 * 1024 * 1024


def test_initial_parameters_are_jax_inits(tmp_path):
    """``sd_init.npz`` and ``ffn_init.npz`` are JAX's seeded inits of the
    recipe's trainers, exactly."""
    jt = JTrainStarDist3D(JStarDistConfig(**SD_CONFIG),
                          basedir=tmp_path / "sd", **SD_TRAINER)
    tree = load_npz(SD_INIT)
    for name, layer in jt.params.items():
        for k, v in layer.items():
            np.testing.assert_array_equal(tree[name][k], np.asarray(v))
    jf = JTrainFFN("ffn", points1_path=str(ffn_points(tmp_path / "p.txt")),
                   basedir=tmp_path / "ffn", seed=FFN_SEED)
    tree = load_npz(FFN_INIT)
    for got, want in zip(jax.tree_util.tree_leaves((tree["0"], tree["1"])),
                         jax.tree_util.tree_leaves((jf.params,
                                                    jf.bn_state))):
        np.testing.assert_array_equal(got, np.asarray(want))


def port_stardist(tmp_path):
    tree = load_npz(SD_INIT)
    trainer = TrainStarDist3D(StarDistConfig(**SD_CONFIG),
                              basedir=tmp_path / "sd", device="cpu",
                              **SD_TRAINER)
    trainer.start_from(tree)
    return trainer


def loss_bound(step, record=None):
    """Phase 14's bound on step ``step`` (0-based) of a record's losses;
    with the StarDist ``record``, at least ``SPREAD_FACTOR`` times the
    largest departure of JAX's own runs nudged by one ulp."""
    tol = FIRST_TOL if step < FIRST_STEPS else LATER_TOL
    if record is None:
        return tol
    want = record["sd_losses"][step]
    runs = np.append(record["sd_losses_nudged"][:, step],
                     record["sd_losses_ulp"][step])
    return max(tol, SPREAD_FACTOR * np.abs(runs - want).max() / abs(want))


def test_port_stardist_first_step_matches_record(record, tmp_path):
    """The port's first step of the recipe on the CPU, from JAX's init:
    the same patches and GT (the same seed), the record's loss."""
    img, lab = vol1()
    got = port_stardist(tmp_path).train([img], [lab], epochs=1,
                                        steps_per_epoch=1, verbose=False)
    want = record["sd_losses"][0]
    assert abs(got[0] - want) <= loss_bound(0, record) * abs(want)


def test_port_ffn_steps_match_record(record, tmp_path):
    """The port's FFN trainer from JAX's init, on JAX's normalized cloud
    (see the module's note on lattice ties), all 30 steps of the record on
    the CPU within phase 14's bounds; its own normalization of the cloud
    within 1e-6 of JAX's."""
    tree = load_npz(FFN_INIT)
    tf = TrainFFN("ffn", points1_path=str(ffn_points(tmp_path / "p.txt")),
                  basedir=tmp_path / "ffn", seed=FFN_SEED, device="cpu")
    tf.start_from((tree["0"], tree["1"]))
    np.testing.assert_allclose(tf.points_t1, record["ffn_points_t1"],
                               rtol=0, atol=1e-6)
    tf.points_generator = DataGeneratorFFN(record["ffn_points_t1"],
                                           seed=FFN_SEED, device="cpu")
    got = tf.train(num_epochs=STEPS, iteration=0, verbose=False)
    for i, (a, b) in enumerate(zip(got, record["ffn_losses"])):
        assert abs(a - b) <= loss_bound(i) * abs(b), i


@pytest.mark.parametrize("run", range(len(NUDGE_SEEDS) + 1))
def test_each_jax_run_holds_to_the_others_spread(record, run):
    """The late-step statistic admits a run of JAX's own: each nudged run
    against the record, bounded by the spread of the other runs."""
    spread = sd_norm_spread(record)
    others = np.delete(spread, run, axis=0)
    _, dep, bound = late_norm_departures(spread[run],
                                         record["sd_update_norms"], others)
    assert dep <= bound


def test_planted_dw_zeroed_fails_late_update_norms(record, tmp_path):
    """The fault the loss cannot see past step 16: every 3x3x3 dW zeroed.
    One port step with it planted leaves every 3x3x3 weight where it was
    (Adam moves a weight only by its gradient's moments) and moves every
    other leaf; a run whose 3x3x3 weights never move, its other leaves
    moving exactly as JAX's record (the fault's best case), is rejected by
    the late-step statistic, which JAX's own runs pass."""
    from t3dct_torch.models import layers
    from t3dct_torch.ops.hopper_conv import Conv3x3x3BiasReLU

    class NoWeightGrad(Conv3x3x3BiasReLU):
        @staticmethod
        def backward(ctx, g):
            dx, dw, db, *rest = Conv3x3x3BiasReLU.backward(ctx, g)
            return (dx, torch.zeros_like(dw), db, *rest)

    img, lab = vol1()
    trainer = port_stardist(tmp_path)
    norms = record_update_norms(trainer)
    layers.Conv3x3x3BiasReLU = NoWeightGrad
    try:
        trainer.train([img], [lab], epochs=1, steps_per_epoch=1,
                      verbose=False)
    finally:
        layers.Conv3x3x3BiasReLU = Conv3x3x3BiasReLU
    leaves = json.loads(str(record["sd_update_leaves"]))
    tree = load_npz(SD_INIT)

    def conv3_weight(key):
        layer, leaf = key.split("/")
        return leaf == "w" and tree[layer]["w"].shape[:3] == (3, 3, 3)
    conv_w = np.array([conv3_weight(k) for k in leaves])
    assert conv_w.sum() > 10
    assert (norms[0][conv_w] == 0).all() and (norms[0][~conv_w] > 0).all()
    faulty = record["sd_update_norms"].copy()
    faulty[:, conv_w] = 0.0
    rel, dep, bound = late_norm_departures(faulty, record["sd_update_norms"],
                                           sd_norm_spread(record))
    assert (rel[conv_w] == 1.0).all() and dep > bound
    # one untrained 3x3x3 weight alone is rejected too
    one = record["sd_update_norms"].copy()
    one[:, np.flatnonzero(conv_w)[0]] = 0.0
    assert late_norm_departures(one, record["sd_update_norms"],
                                sd_norm_spread(record))[1] > bound


@pytest.mark.slow
def test_port_stardist_steps_hold_late_update_norms(record, tmp_path):
    """All 30 steps of the port's trainer on the CPU: steps 17-30 within
    the late-step statistic's bound."""
    img, lab = vol1()
    trainer = port_stardist(tmp_path)
    norms = record_update_norms(trainer)
    trainer.train([img], [lab], epochs=STEPS, steps_per_epoch=1,
                  verbose=False)
    _, dep, bound = late_norm_departures(norms, record["sd_update_norms"],
                                         sd_norm_spread(record))
    assert dep <= bound, (dep, bound)


@pytest.mark.slow
def test_port_stardist_first_steps_match_record(record, tmp_path):
    img, lab = vol1()
    got = port_stardist(tmp_path).train(
        [img], [lab], epochs=FIRST_STEPS, steps_per_epoch=1, verbose=False)
    for i, (a, b) in enumerate(zip(got, record["sd_losses"])):
        assert abs(a - b) <= loss_bound(i, record) * abs(b), i


if __name__ == "__main__":
    import argparse
    import os
    import tempfile
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="run JAX's trainers and write assets/train/")
    ap.add_argument("--write-nudges", action="store_true",
                    help="only add JAX's nudged StarDist runs to the "
                    "record")
    args = ap.parse_args()
    if not (args.write or args.write_nudges):
        ap.error("nothing to do without --write or --write-nudges")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        out = (write_records if args.write else write_nudges)(Path(tmp))
    print(json.dumps(out))
    for p in sorted(ASSETS.iterdir()):
        print(f"{p}: {p.stat().st_size} bytes")
