"""The yardstick's arithmetic against hand counts."""

import json
import types

import pytest

from benchmark.harness import readings, work
from benchmark.harness.driver import BENCH_DIR
from benchmark.reference import stardist_net

CFG = json.loads((BENCH_DIR / "configs" / "stardist3d_worm.json"
                  ).read_text())["model"]


def test_peaks():
    assert work.peak_flop_s("float32") == pytest.approx(165e12)
    assert work.peak_flop_s("bfloat16") == pytest.approx(989e12)
    with pytest.raises(ValueError):
        work.peak_flop_s("float64")


def test_stem_by_hand():
    w = work.layer_work(stardist_net.conv_plan(CFG), CFG, (24, 401, 168),
                        "float32")["stem"]
    vox = 24 * 401 * 168 / (1 * 2 * 2)
    flop = 2 * 27 * 1 * 32 * vox
    nbytes = 4 * (vox * (1 + 32) + 27 * 32 + 32)
    assert w["flop"] == pytest.approx(flop)
    assert w["bytes"] == pytest.approx(nbytes)
    assert w["bound_s"] == pytest.approx(max(flop / 165e12,
                                             nbytes / 3.35e12))


def test_deep_layer_and_head_by_hand():
    ws = work.layer_work(stardist_net.conv_plan(CFG), CFG, (24, 400, 168),
                         "float32")
    vox = 24 * 400 * 168 / 4 / 8 ** 2         # two U-Net pools below grid
    assert ws["bottom_1"]["flop"] == pytest.approx(2 * 27 * 128 * 128 * vox)
    head = ws["dist_head"]
    assert head["flop"] == pytest.approx(2 * 128 * 96 * 24 * 400 * 168 / 4)


def test_network_flop_of_the_bench_volume():
    ws = work.layer_work(stardist_net.conv_plan(CFG), CFG, (24, 401, 168),
                         "float32")
    assert work.network_flop(ws) == pytest.approx(3.041e11, rel=1e-3)
    assert work.network_bound_s(ws) == pytest.approx(
        sum(w["bound_s"] for w in ws.values()))


def _run(items, secs, net_ms=None):
    ws = work.layer_work(stardist_net.conv_plan(CFG), CFG, (24, 401, 168),
                         "float32")
    window = types.SimpleNamespace(completed=items, elapsed_s=secs)
    net = None
    if net_ms is not None:
        net = types.SimpleNamespace(events=[1], total_ms=lambda: net_ms)
    return types.SimpleNamespace(work=ws, window=window, span=None,
                                 cfg={"precision": "float32"},
                                 timed_net=net)


def test_mfu_by_hand():
    run = _run(100, 10.0)
    flop = work.network_flop(run.work)
    assert readings.flop_share(run) == pytest.approx(
        100 * 100 * flop / (10.0 * 165e12))
    assert readings.flop_share(run, passes=3) == pytest.approx(
        3 * readings.flop_share(run))


def test_roofline_share_by_hand_and_bounded():
    run = _run(10, 1.0, net_ms=100.0)
    bound_ms = 1e3 * work.network_bound_s(run.work)
    assert readings.roofline_share(run) == pytest.approx(
        100 * 10 * bound_ms / 100.0)
    # a network that takes exactly its bound reads 100%
    run = _run(10, 1.0, net_ms=10 * bound_ms)
    assert readings.roofline_share(run) == pytest.approx(100.0)


def test_no_work_reads_nothing():
    assert readings.flop_share(_run(0, 1.0)) is None
    assert readings.roofline_share(_run(5, 1.0)) is None
