"""The last line's schema and the manifest's contract."""

import json
import re

from benchmark.harness.driver import BENCH_DIR, REPO
import importlib.util

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run_module():
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  BENCH_DIR / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_result_line_schema():
    run = _run_module()
    checks = {"prob_gap": (1e-6, 1e-4), "track_lost": (0.0, 3.0)}
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "memory_peak_bytes": 123}
    r = run.result_line(10, 0, {"volumes_per_s": {"value": 8.5,
                                                  "unit": "volumes/s"}},
                        device, None, checks)
    line = json.dumps(r)
    back = json.loads(line)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(back)[-1] == "checks"
    assert back["correct"] is True
    assert back["checks"]["prob_gap"] == {"value": 1e-6, "limit": 1e-4}
    bad = run.result_line(10, 0, {}, device, {"device_ops": [],
                                              "idle_gaps": []},
                          {"prob_gap": (1e-3, 1e-4)})
    assert bad["correct"] is False and "breakdown" in bad


def test_manifest_keeps_to_the_contract():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names)) == len(names)
    cells = {w["name"] for w in b["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] == 1 for w in b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        mover = e2e[m["moves"]]
        for c in m["workloads"]:
            assert "workloads" not in mover or c in mover["workloads"]
    for c in cells:
        reported = [m for m in b["end_to_end"]
                    if "workloads" not in m or c in m["workloads"]]
        assert len(reported) >= 2
        assert any(c in m["workloads"] for m in b["per_layer"])
    for w in b["workloads"]:
        assert len(w["why"]) <= 200
    assert len(json.dumps(b)) < 64 * 1024
