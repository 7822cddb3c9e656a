"""Cells, configurations, traffic mixes and per-layer metrics are found by
the names in BENCHMARK.json, each in a file of its own: a later change
adds one by adding files and manifest entries, with no edit to a file that
is there."""

import importlib.util
import json
import shutil

import pytest

from benchmark.harness.driver import BENCH_DIR, REPO


def _copy(tmp_path):
    """The benchmark and its manifest in a fresh checkout-like folder;
    returns its ``run.py`` loaded as a module of that folder."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    spec = importlib.util.spec_from_file_location(
        "bench_run_copy", tmp_path / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_named_file_exists():
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        assert (REPO / c["file"]).is_file()
    for w in manifest["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        cell = json.loads((BENCH_DIR / "workloads" /
                           f"{w['name']}.json").read_text())
        assert (BENCH_DIR / "drivers" / f"{cell['driver']}.py").is_file()
    for m in manifest["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_new_files_are_found_by_name(tmp_path):
    run = _copy(tmp_path)
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "stardist3d_worm.json").read_text())
    (b / "configs" / "other_model.json").write_text(json.dumps(cfg))
    (b / "traffic" / "other_mix.json").write_text(json.dumps(
        {"scene": {"shape": [8, 64, 48], "cells": 4, "pool": 18,
                   "period": 18}}))
    cell = json.loads((b / "workloads" / "sd_worm_track.json").read_text())
    (b / "workloads" / "other_cell.json").write_text(json.dumps(cell))
    (b / "metrics" / "other_metric.py").write_text(
        "def read(run):\n    return run.answer\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(manifest["configs"][0],
                                    name="other_model",
                                    file="benchmark/configs/"
                                         "other_model.json"))
    manifest["workloads"].append(dict(manifest["workloads"][0],
                                      name="other_cell",
                                      config="other_model",
                                      traffic="other_mix"))
    manifest["per_layer"].append(dict(manifest["per_layer"][0],
                                      name="other_metric",
                                      workloads=["other_cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    entry, config, man = run.load_cell("other_cell")
    assert entry["traffic"] == "other_mix"
    assert config["file"].endswith("other_model.json")
    names = [m["name"] for m in run.metrics_of(man, "per_layer",
                                               "other_cell")]
    assert names == ["other_metric"]

    class Run:
        answer = 42.0
    assert run.reader("other_metric")(Run()) == 42.0


def test_an_unknown_cell_is_refused(tmp_path):
    run = _copy(tmp_path)
    with pytest.raises(SystemExit) as e:
        run.load_cell("no_such_cell")
    assert e.value.code != 0
