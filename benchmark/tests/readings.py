"""Read the numbers that decide a cell's ``correct`` on the card: under
sound runs, under each planted fault and under the control, on several
seeds at the cell's own size.  The limits in ``benchmark/workloads/`` are
set from these readings (``PERF.md`` gives them).

    python benchmark/tests/readings.py --workload sd_worm_track \\
        --seeds 1 2 3 --seconds 30 [--fault NAME | --control]

One line a seed: ``readings <workload> <mode> seed=<n> {number: value}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def read_one(workload: str, seed: int, seconds: float, fault=None,
             use_control: bool = False, device=None) -> dict:
    import torch
    import t3dct_torch  # noqa: F401
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in manifest["workloads"]}[workload]
    config = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    cell = json.loads((REPO / "benchmark" / "workloads" /
                       f"{workload}.json").read_text())
    cfg = json.loads((REPO / config["file"]).read_text())
    traffic = json.loads((REPO / "benchmark" / "traffic" /
                          f"{entry['traffic']}.json").read_text())
    return read_with(cfg, traffic, cell, seed, seconds, fault, use_control,
                     device or torch.device("cuda", 0))


def read_with(cfg, traffic, cell, seed, seconds, fault=None,
              use_control=False, device=None) -> dict:
    """One run of a cell's driver from explicit files, with ``fault``
    (a name in ``planted.FAULTS``) planted or the control put in the
    program's place; returns each checked number with its limit."""
    import importlib
    from benchmark.tests import planted
    mod = importlib.import_module(f"benchmark.drivers.{cell['driver']}")
    drv = mod.Driver(cfg, traffic, cell, seed, False, device)
    plant = planted.FAULTS[cell["driver"]][fault] if fault else None
    undo = None
    if cell["driver"] == "train_stardist":
        drv.build()
        if plant:
            undo = plant(drv)
        drv.warm()
    else:
        drv.setup()
        if plant:
            undo = plant(drv)
    drv.run_window(seconds)
    if undo:
        undo()
    drv.free()
    if use_control:
        planted.control(drv)
    return drv.check()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    mode = args.fault or ("control" if args.control else "sound")
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = read_one(args.workload, seed, args.seconds, args.fault,
                          args.control)
        vals = {k: v for k, (v, _) in checks.items()}
        print(f"readings {args.workload} {mode} seed={seed} "
              f"{json.dumps(vals)} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
