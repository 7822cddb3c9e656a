"""The traced part of a window: a ``torch.profiler`` trace of the device
over a run of items, reduced to busy time, the span, the operations that
took most time and the longest idle gaps, and the completeness check of
the trace against the port's launch counters.

The port counts each launch of its hand-written kernels in an attribute of
the kernel's wrapper (``utils/cuda_build.py::count_launch``).  A trace that
holds fewer launches of those kernels than the counters saw over the same
items has lost events, so the idle share and the breakdown are reported
only where the two counts agree.  The kernels are listed one file each
under ``benchmark/kernels/``: a pattern of the name the trace shows (a
regular expression matched as a whole word) and the wrapper whose counter
counts it.
"""

from __future__ import annotations

import importlib
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

KERNELS_DIR = Path(__file__).resolve().parents[1] / "kernels"
# markers that kineto may place on the device's timeline without any
# operation running there
SYNC_MARKERS = ("Stream Wait Event", "Event Sync", "Context Sync",
                "Stream Sync", "Device Sync")


def hand_kernels() -> List[dict]:
    return [dict(json.loads(p.read_text()), name=p.stem)
            for p in sorted(KERNELS_DIR.glob("*.json"))]


def _wrapper(spec: dict):
    mod = importlib.import_module(f"t3dct_torch.{spec['module']}")
    return getattr(mod, spec["wrapper"])


def read_counters(specs: List[dict]) -> Dict[str, int]:
    """The launch counter of every hand kernel (``rounds`` and other
    counters named ``<wrapper>.<attr>`` too)."""
    out = {}
    for spec in specs:
        w = _wrapper(spec)
        out[spec["name"]] = int(getattr(w, "launches"))
        for attr in spec.get("extra_counters", ()):
            out[f"{spec['name']}.{attr}"] = int(getattr(w, attr))
    return out


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int,
                                                                     int]]]:
    """(total covered ns, merged intervals) of (start, end) pairs."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def _user_span(e) -> bool:
    """Whether a kineto event is a ``record_function`` span."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def reduce_events(events, specs: List[dict]) -> dict:
    """The reading of a trace from its kineto events: ``busy_s`` (the union
    of device activity), ``window_s`` (first to last event of any kind),
    ``device_ops`` (the 10 device operations with most time), ``idle_gaps``
    (the 10 longest gaps between device activity, named by the innermost
    host operation running at the gap's middle) and ``hand_launches`` (the
    trace's launches of each hand kernel)."""
    events = list(events)
    # the spans of ``record_function`` show on the device's timeline too,
    # covering whole stages: they are no device operation.  Without the
    # event's flag, they are the names on both timelines (a kernel's or a
    # copy's name is never a host op's)
    on = {kind: {e.name() for e in events if e.device_type() == kind}
          for kind in (torch.autograd.DeviceType.CPU,
                       torch.autograd.DeviceType.CUDA)}
    spans = {e.name() for e in events if _user_span(e)} | (
        on[torch.autograd.DeviceType.CPU]
        & on[torch.autograd.DeviceType.CUDA])
    dev, host = [], []
    lo, hi = None, None
    for e in events:
        s, en = int(e.start_ns()), int(e.end_ns())
        if en < s:
            continue
        lo = s if lo is None else min(lo, s)
        hi = en if hi is None else max(hi, en)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not (e.name().startswith(SYNC_MARKERS) or e.name() in spans
                    or _user_span(e)):
                dev.append((s, en, e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((s, en, e.name()))
    busy, merged = _union([(s, e) for s, e, _ in dev])
    by_name: Dict[str, int] = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in
                   zip(merged, merged[1:])), reverse=True)[:10]
    host.sort()
    idle = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        inner = None
        for hs, he, name in host:
            if hs > mid:
                break
            if he >= mid:
                inner = name          # the latest start covering mid
        idle.append([inner or "(no host op)", length / 1e9])
    launches = {spec["name"]: 0 for spec in specs}
    pats = [(spec["name"], re.compile(
        r"(?<![A-Za-z0-9_])(" + spec["trace_name"] + r")(?![A-Za-z0-9_])"))
        for spec in specs]
    for _, _, name in dev:
        for key, pat in pats:
            if pat.search(name):
                launches[key] += 1
    return dict(busy_s=busy / 1e9,
                window_s=(hi - lo) / 1e9 if dev else 0.0,
                device_ops=[[n, t / 1e9] for n, t in ops],
                idle_gaps=idle, hand_launches=launches)


class TracedSpan:
    """Start the profiler before item ``start`` and stop it after
    ``count`` items; the launch counters are read at both ends, with the
    device synchronized, so both counts cover the same work."""

    def __init__(self, start: int, count: int, specs: List[dict]):
        self.start, self.count, self.specs = start, count, specs
        self.prof = None
        self.before: Optional[Dict[str, int]] = None
        self.reading: Optional[dict] = None
        self.counted: Optional[Dict[str, int]] = None
        self.items = 0            # items run under the profiler
        self.wall_s = 0.0         # host time from its start to its reading
        self._t0 = 0.0

    def at_item(self, i: int) -> None:
        """Call before handing out item ``i`` (0-based)."""
        if i == self.start and self.prof is None:
            self._t0 = time.perf_counter()
            torch.cuda.synchronize()
            self.before = read_counters(self.specs)
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif i == self.start + self.count and self.reading is None \
                and self.prof is not None:
            self.stop(i)

    def stop(self, i: int) -> None:
        """Stop before item ``i`` (or at the window's close, after item
        ``i - 1``)."""
        self.items = i - self.start
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        after = read_counters(self.specs)
        self.counted = {k: after[k] - self.before[k] for k in after}
        self.reading = reduce_events(
            self.prof.profiler.kineto_results.events(), self.specs)
        self.prof = None
        self.wall_s = time.perf_counter() - self._t0

    def complete(self) -> bool:
        """Whether the trace holds every hand-kernel launch the counters
        saw (and at least one device operation)."""
        if self.reading is None:
            return False
        got = self.reading["hand_launches"]
        return self.reading["busy_s"] > 0 and all(
            got[k] == self.counted[k] for k in got)


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up, so that its own first
    start (CUPTI's load) does not fall inside a window."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
