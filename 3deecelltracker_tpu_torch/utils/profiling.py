"""Wall time per call and per stage, and profiler traces (counterpart of
``3deecelltracker_tpu/utils/profiling.py``).

``timer`` and ``StageTimer`` read the host clock only, as JAX's do: a
stage that enqueues CUDA work without waiting for it times the enqueue.
``utils.timing.CudaStageTimer`` is the variant that synchronizes the
caller's stream around each stage, which the drivers' ``timer=`` take.
``device_trace`` is a ``torch.profiler`` scope.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, Optional


def timer(fn):
    """Decorator printing the wall time of each call (the reference's
    ``tracker.py:51-62``)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"[{fn.__name__}] {time.perf_counter() - t0:.3f}s")
        return out
    return wrapped


class StageTimer:
    """Accumulate wall time per named stage; :meth:`summary` is a table
    by total time, in seconds (JAX's)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["stage                          total_s   calls   per_call"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot, n = self.totals[name], self.counts[name]
            lines.append(f"{name:<30} {tot:8.3f} {n:7d} {tot / n:10.4f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the CPU and, where there is one, the
    card, written to ``log_dir`` for TensorBoard; a no-op when
    ``log_dir`` is None.  Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) \
            as prof:
        yield prof
