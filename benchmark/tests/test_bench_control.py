"""The control on the card: the plain reference with TF32 products put in
the program's place must come out not correct in every cell, through the
numbers where a lower precision shows (the network's maps; the training
losses and gradients).  Small scenes, so that a test run holds them; the
readings at the cells' own sizes come from ``readings.py``."""

import pytest

from benchmark.tests.readings import read_with
from benchmark.tests.test_bench_faults import TILED, TRAIN, V1

CASES = {
    "v1_track": (V1, 3.0, ("prob_gap", "dist_gap")),
    "tiled_seg": (TILED, 1.0, ("prob_gap", "dist_gap")),
    "train_stardist": (TRAIN, 1.0, ("loss_gap", "grad_gap", "change_gap")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("driver", sorted(CASES))
def test_control_is_not_correct(driver, cuda_device):
    setting, seconds, numbers = CASES[driver]
    sound = read_with(setting["cfg"], setting["traffic"], setting["cell"],
                      2 ** 31 + 23, seconds, device=cuda_device)
    assert all(sound[n][0] <= sound[n][1] for n in numbers), sound
    ctl = read_with(setting["cfg"], setting["traffic"], setting["cell"],
                    2 ** 31 + 23, seconds, use_control=True,
                    device=cuda_device)
    assert any(ctl[n][0] > ctl[n][1] for n in numbers), ctl
