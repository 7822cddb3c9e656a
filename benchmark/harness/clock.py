"""Clocks of the harness: the synchronized stage timer of traced runs and the
window of a closed loop.

:class:`StageTimer` is a copy of the port's ``utils/timing.py::
CudaStageTimer``: the caller's stream is synchronized before and after a
stage, so a stage's time holds the device work it enqueued.  The
synchronizations cost time, so only traced runs pass it to the program.

:class:`Window` hands out a closed loop's items: item ``i`` is asked for
once item ``i - 1`` has completed, the window opens when the first timed
item is asked for, and it closes at the first request after ``seconds``
have passed.  Every completed item and all of the time between the open
and the close count.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch


def sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class StageTimer:
    """``times[name]``: the ms of every run of stage ``name``."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Also a span of the profiler's trace, so that the breakdown can
        name the stage the host was in during an idle gap."""
        sync()
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            sync()
            self.times.setdefault(name, []).append(
                1e3 * (time.perf_counter() - t0))


class Window:
    """``request()`` before each item: returns False once the window has
    closed.  ``item_ms``: the time of each completed item, from the
    request that handed it out to the next."""

    def __init__(self, seconds: float, clock: Callable[[], float] =
                 time.perf_counter):
        self.seconds = float(seconds)
        self.clock = clock
        self.opened: Optional[float] = None
        self.closed: Optional[float] = None
        self.last: Optional[float] = None
        self.item_ms: List[float] = []
        self.completed = 0

    def request(self) -> bool:
        now = self.clock()
        if self.opened is None:
            self.opened = self.last = now
            return True
        self.item_ms.append(1e3 * (now - self.last))
        self.completed += 1
        self.last = now
        if now - self.opened >= self.seconds:
            self.closed = now
            return False
        return True

    @property
    def elapsed_s(self) -> float:
        return self.closed - self.opened

    @property
    def rate(self) -> float:
        return self.completed / self.elapsed_s
