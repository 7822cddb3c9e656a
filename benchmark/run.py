"""Run one cell of the port's benchmark once and print its result line.

    python benchmark/run.py --workload sd_worm_track --seed 7 \\
        --seconds 30 --trace 0

The cell's configuration, traffic mix and workload file are found by the
names in ``BENCHMARK.json``: ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` and ``benchmark/workloads/<name>.json``,
whose ``driver`` names a module of ``benchmark/drivers/``.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics, each read by ``benchmark/metrics/<metric>.py``.  The last line of
standard output is one JSON object; the numbers that decide ``correct``
are printed beside their limits as the last lines of standard error and
under the result's last key, ``checks``.

It needs the CUDA cards the cell asks for and exits with 2 without them.
Build and kernel caches stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
CACHE = REPO / "_bench_cache"
# fixed directories inside the checkout for every cache a library may keep
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(REPO))

FORBIDDEN = ("jax", "jaxlib", "flax", "3deecelltracker_tpu", "t3dct")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's ``3deecelltracker_tpu_torch`` and
    ``t3dct_torch`` are not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_cell(name: str):
    """(workload entry, configuration entry, BENCHMARK.json) of a cell."""
    with open(REPO / "BENCHMARK.json") as fh:
        manifest = json.load(fh)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]], manifest


def metrics_of(manifest: dict, kind: str, cell: str):
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"): every
    one that lists the cell, or lists no cells."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str):
    """``read`` of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def result_line(attempted: int, failed: int, metrics: dict, device: dict,
                breakdown, checks: dict) -> dict:
    """The result object: ``correct`` when every checked number is within
    its limit; ``checks``, each number beside its limit, comes last."""
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, config_entry, manifest = load_cell(args.workload)
    cell_file = json.loads((BENCH / "workloads" /
                            f"{args.workload}.json").read_text())
    cfg = json.loads((REPO / config_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" /
                          f"{cell['traffic']}.json").read_text())

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
             f"{cell['chips']}")
    import t3dct_torch  # noqa: F401  (the system under test)
    mod = importlib.import_module(f"benchmark.drivers.{cell_file['driver']}")
    device = torch.device("cuda", 0)
    drv = mod.Driver(cfg, traffic, cell_file, args.seed, bool(args.trace),
                     device)
    drv.setup()
    drv.run_window(args.seconds)
    setup_s = drv.window.opened - T_START
    torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated(device))

    if args.trace:
        metrics = {}
        for m in metrics_of(manifest, "per_layer", args.workload):
            value = reader(m["name"])(drv)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = dict(drv.end_to_end(), setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in metrics_of(manifest, "end_to_end",
                                       args.workload)}
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": peak}
    breakdown = None
    if args.trace:
        span = drv.span
        reading = span.reading if span is not None else None
        if reading is None:
            fail("the traced span never ran: no device trace")
        device_info["busy_s"] = reading["busy_s"]
        device_info["window_s"] = reading["window_s"]
        print(f"trace: hand-kernel launches in the trace "
              f"{reading['hand_launches']}, by the program's counters "
              f"{span.counted}", file=sys.stderr)
        if span.complete():
            breakdown = {"device_ops": reading["device_ops"],
                         "idle_gaps": reading["idle_gaps"]}
        else:
            print("trace: incomplete, the idle share and the breakdown are "
                  "left out", file=sys.stderr)

    print(f"host: {os.cpu_count()} cores, load average "
          f"{' '.join(Path('/proc/loadavg').read_text().split()[:3])}",
          file=sys.stderr)
    attempted, failed_items = drv.attempted_failed()
    drv.free()
    checks = drv.check()
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}", 3)
    result = result_line(attempted, failed_items, metrics, device_info,
                         breakdown, checks)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
