"""Tiny runs of every cell's driver on the CPU (the harness's look for a
card skipped, the rest of a run driven: set-up, window, the program's
state freed, the comparison with the reference), sound and with each
fault planted under the timed path: each fault comes out not correct,
through the number that it breaks.  The limits are the cells' own, with
counts of cells scaled to the tiny scenes."""

import json

import pytest
import torch

from benchmark.harness.driver import BENCH_DIR
from benchmark.tests.readings import read_with

CPU = torch.device("cpu")
CFG = json.loads((BENCH_DIR / "configs" / "stardist3d_worm.json"
                  ).read_text())


def _cell(name, **kw):
    cell = json.loads((BENCH_DIR / "workloads" / f"{name}.json"
                       ).read_text())
    cell.update(kw)
    return cell


def _scaled(name, cells):
    """The cell's limits, its counts of cells scaled to a scene of
    ``cells`` cells (the limits are set for the cell's own scene)."""
    cell = _cell(name)
    full = json.loads((BENCH_DIR / "traffic" / f"{_TRAFFIC[name]}.json"
                       ).read_text())["scene"]["cells"]
    return {k: (max(1.0, v * cells / full) if k in COUNTS else v)
            for k, v in cell["limits"].items()}


COUNTS = ("cells_missed", "extra_instances", "track_lost")
_TRAFFIC = {"sd_worm_track": "worm_loop", "sd_large_seg": "worm_large"}
V1 = dict(cfg=CFG, traffic={"scene": {
    "shape": [24, 96, 64], "cells": 12, "pool": 18, "period": 18,
    "drift_yx": 6.0}},
    cell=_cell("sd_worm_track", samples=1, sample_span=2, warmup_items=2,
               limits=_scaled("sd_worm_track", 12)))
TILED = dict(cfg=CFG, traffic={"scene": {
    "shape": [24, 96, 96], "cells": 24, "pool": 18, "period": 18}},
    cell=_cell("sd_large_seg", samples=2, sample_span=2, warmup_items=1,
               tile_shape=[None, 64, 64], shrink=[0, 16, 16],
               max_candidates=256, limits=_scaled("sd_large_seg", 24)))
TRAIN = dict(cfg=dict(CFG, model=dict(CFG["model"],
                                      train_patch_size=[8, 32, 32])),
             traffic={"scene": {"shape": [12, 64, 48], "cells": 12,
                                "pool": 18, "period": 18,
                                "margin": [3, 8, 8]}},
             cell=_cell("sd_train"))

CASES = {
    # (setting, seconds, fault, the number it breaks)
    "v1_state_unchanged": (V1, 3.0, "state_unchanged", "track_move_err"),
    "v1_coords_altered": (V1, 3.0, "coords_altered", "track_lost"),
    "v1_prob_altered": (V1, 3.0, "prob_altered", "prob_gap"),
    "v1_points_altered": (V1, 3.0, "points_altered", "cells_missed"),
    "tiled_half_batch": (TILED, 1.0, "half_batch", "prob_gap"),
    "tiled_prob_altered": (TILED, 1.0, "prob_altered", "prob_gap"),
    "tiled_points_altered": (TILED, 1.0, "points_altered", "cells_missed"),
    "tiled_labels_altered": (TILED, 1.0, "labels_altered",
                             "label_mismatch"),
    "train_state_unchanged": (TRAIN, 1.0, "state_unchanged", "change_gap"),
    "train_half_batch": (TRAIN, 1.0, "half_batch", "loss_gap"),
    "train_loss_altered": (TRAIN, 1.0, "loss_altered", "loss_gap"),
}
_sound = {}


def _checks(setting, seconds, fault=None):
    return read_with(setting["cfg"], setting["traffic"], setting["cell"],
                     2 ** 31 + 17, seconds, fault=fault, device=CPU)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fault_is_not_correct(case):
    setting, seconds, fault, number = CASES[case]
    key = id(setting)
    if key not in _sound:
        _sound[key] = _checks(setting, seconds)
    value, limit = _sound[key][number]
    assert value <= limit, f"sound run: {number} {value} over {limit}"
    checks = _checks(setting, seconds, fault)
    value, limit = checks[number]
    assert value > limit, f"{fault}: {number} {value} within {limit}"
    assert not all(v <= lim for v, lim in checks.values())
