"""What every cell's driver shares: the cell's files, the device, the
window, the traced span and the network's clock.

A driver (``benchmark/drivers/<name>.py``, named by the cell's workload
file) subclasses :class:`Driver` and fills in ``setup`` (build the system
under test from the seed and warm up every shape the window uses),
``run_window`` (drive the entry point for ``seconds`` through
:meth:`Driver.request`), ``free`` (drop the program's state) and
``check`` (the comparison with the plain reference, returning each number
with its limit).
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from . import trace as trace_mod
from .clock import StageTimer, Window, sync as sync_device

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent


def sample_items(seed: int, n: int, first: int, span: int) -> List[int]:
    """``n`` item numbers in ``first`` .. ``first + span - 1`` drawn from the
    seed: the items whose outputs the check compares."""
    g = torch.Generator().manual_seed(int(seed) + 7919)
    return sorted(int(first + i) for i in
                  torch.randperm(span, generator=g)[:n].tolist())


class TimedNet:
    """The network object of a model with CUDA events recorded around each
    ``apply``; everything else is the network's own."""

    def __init__(self, net):
        self._net = net
        self.events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.on = False

    def apply(self, *args, **kwargs):
        if not self.on:
            return self._net.apply(*args, **kwargs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._net.apply(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out

    def __getattr__(self, name):
        return getattr(self._net, name)

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


class Driver:
    """One run of one cell.  ``cfg``: the configuration file, ``traffic``:
    the traffic file, ``cell``: the workload file, all as dicts."""

    def __init__(self, cfg: dict, traffic: dict, cell: dict, seed: int,
                 traced: bool, device: torch.device):
        self.cfg, self.traffic, self.cell = cfg, traffic, cell
        self.seed = int(seed)
        self.traced = bool(traced)
        self.device = device
        self.timer: Optional[StageTimer] = StageTimer() if traced else None
        self.window: Optional[Window] = None
        self.span: Optional[trace_mod.TracedSpan] = None
        self.timed_net: Optional[TimedNet] = None
        self.stats: Dict[str, List[float]] = {}
        self.work: Dict[str, float] = {}

    # ---- the loop's clock -------------------------------------------------
    def open_window(self, seconds: float) -> None:
        self.window = Window(seconds)
        if self.traced and self.device.type == "cuda":
            self.span = trace_mod.TracedSpan(
                int(self.cell["trace_from"]), int(self.cell["trace_items"]),
                trace_mod.hand_kernels())

    def request(self, sync: bool = False) -> bool:
        """Before each timed item: False once the window has closed.
        ``sync``: wait for the device before the closing request, for a
        loop whose items leave work queued there."""
        w = self.window
        if sync and w.opened is not None and \
                w.clock() - w.opened >= w.seconds:
            sync_device()
        i = 0 if self.window.opened is None else self.window.completed + 1
        if self.span is not None:
            self.span.at_item(i)
        if self.window.opened is None and self.timed_net is not None:
            self.timed_net.on = self.traced
        more = self.window.request()
        if not more and self.span is not None and \
                self.span.prof is not None:
            self.span.stop(i)
        if not more and self.timed_net is not None:
            self.timed_net.on = False
        return more

    def stage(self, name: str):
        """The synchronized stage timer of traced runs (else nothing)."""
        return self.timer.stage(name) if self.timer is not None else \
            contextlib.nullcontext()

    # ---- to fill in ---------------------------------------------------------
    def setup(self) -> None:
        raise NotImplementedError

    def run_window(self, seconds: float) -> None:
        raise NotImplementedError

    def free(self) -> None:
        raise NotImplementedError

    def check(self) -> Dict[str, Tuple[float, float]]:
        raise NotImplementedError

    # ---- what the readers see ------------------------------------------------
    @property
    def spans(self) -> Dict[str, List[float]]:
        return self.timer.times if self.timer is not None else {}
