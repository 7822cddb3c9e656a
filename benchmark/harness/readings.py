"""Readings that several per-layer metrics share; each metric's reader
(``benchmark/metrics/<metric>.py``) calls one of these on the driver of
the run."""

from __future__ import annotations

import statistics
from typing import Optional

from . import work


def mean_span(run, name: str) -> Optional[float]:
    """The mean ms of a synchronized stage over the window's items."""
    ms = run.spans.get(name)
    return statistics.fmean(ms) if ms else None


def mean_stat(run, name: str) -> Optional[float]:
    vals = run.stats.get(name)
    return statistics.fmean(vals) if vals else None


def idle_share(run) -> Optional[float]:
    """% of the traced span in which no operation ran on the device; only
    from a trace that holds every hand-kernel launch the counters saw."""
    span = run.span
    if span is None or not span.complete() or \
            span.reading["window_s"] <= 0:
        return None
    r = span.reading
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])


def flop_share(run, passes: float = 1.0) -> Optional[float]:
    """% of the precision's peak that the network's work (``passes`` times
    its forward FLOP, counted once per item) reaches over the window.  The
    items run under the profiler, and the profiler's own start and
    reading, are left out of both the work and the time."""
    items, secs = run.window.completed, run.window.elapsed_s
    if run.span is not None and run.span.reading is not None:
        items -= run.span.items
        secs -= run.span.wall_s
    if not run.work or items <= 0:
        return None
    flop = passes * work.network_flop(run.work) * items
    return 100.0 * flop / (secs * work.peak_flop_s(run.cfg["precision"]))


def roofline_share(run) -> Optional[float]:
    """% of the time in the network's calls that the network's least time
    for the window's items would take (layer bounds summed, each item's
    work counted once)."""
    net = run.timed_net
    if net is None or not net.events or run.window.completed == 0:
        return None
    bound_ms = 1e3 * work.network_bound_s(run.work) * run.window.completed
    return 100.0 * bound_ms / net.total_ms()
