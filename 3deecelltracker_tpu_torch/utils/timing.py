"""Stage timing on the host clock, the caller's stream synchronized around
each stage (the counterpart of
``3deecelltracker_tpu/utils/profiling.py::StageTimer`` for a device that
runs ahead of the host).  ``utils.profiling.StageTimer`` is JAX's twin,
which does not synchronize."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class CudaStageTimer:
    """``times[name]``: the ms of every run of stage ``name``.  The
    caller's current stream is synchronized before and after a stage, so
    its time holds the device work it enqueued there, not only the
    enqueue, and not the work of another thread's stream (the disk
    handoff's segmenter)."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.times.setdefault(name, []).append(
                1e3 * (time.perf_counter() - t0))

    def summary(self) -> str:
        lines = ["stage                          total_ms   calls    per_call"]
        for name, ms in sorted(self.times.items(), key=lambda kv:
                               -sum(kv[1])):
            lines.append(f"{name:<30} {sum(ms):9.1f} {len(ms):7d} "
                         f"{sum(ms) / len(ms):11.2f}")
        return "\n".join(lines)
