"""Volumes loaded ahead of the device (counterpart of
``3deecelltracker_tpu/io/prefetch.py``, ``VolumePrefetcher`` :15), their
upload to the card off the main stream, and results copied back the same
way (:func:`to_host`).

The tracking recurrence is serial over t; the prefetcher decodes volume
t + k on background threads while the card works on volume t, so the
card never waits on TIFF decode or percentiles.  :func:`upload_async`
copies a loaded volume from pinned host memory with ``non_blocking=True``
on a side stream and records an event; :meth:`Upload.wait` makes the
consumer's stream wait on that event, so the copy overlaps the previous
volume's work and is ordered before the seg call that reads it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Iterable, Iterator, List, NamedTuple,
                    Optional)

import numpy as np
import torch


class VolumePrefetcher:
    """Iterate ``(t, load_fn(t))`` for each t with ``depth`` volumes in
    flight.  ``workers`` > 1 runs that many loads at once, delivered in
    order; the first error, in order, is raised to the consumer.

    One-shot: a consumed prefetcher yields nothing on re-iteration.  A
    consumer that stops early calls :meth:`close`, so the workers stop
    loading and release the volumes in flight."""

    def __init__(self, load_fn: Callable[[int], object],
                 t_values: Iterable[int], depth: int = 2,
                 workers: int = 1):
        self._load = load_fn
        self._ts = list(t_values)
        self._depth = max(1, depth)
        self._workers = max(1, workers)
        self._q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False
        self._done = False
        self._stop = threading.Event()

    def _put(self, item) -> bool:
        """Bounded put that gives up once :meth:`close` was called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        if self._workers == 1:
            for t in self._ts:
                if self._stop.is_set():
                    return
                try:
                    item = (t, self._load(t), None)
                except Exception as e:      # delivered to the consumer
                    self._put((t, None, e))
                    return
                if not self._put(item):
                    return
            self._put(None)
            return
        # parallel loads, ordered delivery: submit up to `workers` ahead;
        # the bounded output queue supplies the `depth` backpressure
        with ThreadPoolExecutor(self._workers) as ex:
            pending = []
            idx = 0
            while pending or idx < len(self._ts):
                if self._stop.is_set():
                    for _, f in pending:
                        f.cancel()
                    return
                while (idx < len(self._ts)
                       and len(pending) < self._workers + self._depth):
                    t = self._ts[idx]
                    pending.append((t, ex.submit(self._load, t)))
                    idx += 1
                t, fut = pending.pop(0)
                try:
                    item = (t, fut.result(), None)
                except Exception as e:
                    for _, f in pending:
                        f.cancel()
                    self._put((t, None, e))
                    return
                if not self._put(item):
                    for _, f in pending:
                        f.cancel()
                    return
            self._put(None)

    def close(self) -> None:
        """Stop the workers and release volumes in flight (idempotent)."""
        self._stop.set()

        def drain():
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break

        drain()                 # a worker blocked on a put sees the flag
        if self._started:
            self._thread.join(timeout=5.0)
        drain()                 # a put that slipped in before the join

    def __iter__(self) -> Iterator:
        if self._done or self._stop.is_set():
            return
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            item = self._q.get()
            if item is None:
                self._done = True
                return
            t, vol, err = item
            if err is not None:
                self._done = True
                raise err
            yield t, vol


class Upload(NamedTuple):
    """A volume on its way to the device: ``data`` holds its bits there
    (uint16 as int16), ``event`` marks the end of the copy on the side
    stream (None off the card), ``host`` keeps the pinned source alive
    until the copy is done."""
    data: torch.Tensor
    event: Optional[torch.cuda.Event]
    host: torch.Tensor
    widen_u16: bool

    def wait(self) -> torch.Tensor:
        """The volume for the current stream: it waits for the copy, and
        uint16 bits widen to int32 on the device."""
        x = self.data
        if self.event is not None:
            cur = torch.cuda.current_stream(x.device)
            cur.wait_event(self.event)
            x.record_stream(cur)
        return (x.to(torch.int32) & 0xFFFF) if self.widen_u16 else x


def upload_async(vol: np.ndarray, device: torch.device,
                 stream: Optional["torch.cuda.Stream"]) -> Upload:
    """Start the copy of a raw volume to ``device``: on the card, from
    pinned memory with ``non_blocking=True`` on ``stream``; on the CPU, a
    plain copy.  uint16 travels as its int16 bits (uint16 tensors have
    few kernels)."""
    vol = np.ascontiguousarray(vol)
    widen = vol.dtype == np.uint16
    host = torch.from_numpy(vol.view(np.int16) if widen else vol)
    if device.type != "cuda":
        return Upload(host.to(device), None, host, widen)
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    with torch.cuda.stream(stream):
        data = pinned.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return Upload(data, event, pinned, widen)


def ready_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event at the end of the work enqueued so far on ``device``'s
    current stream (None off the card)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def to_host(tensors, ready: Optional[torch.cuda.Event],
            stream: Optional["torch.cuda.Stream"]) -> List:
    """Host numpy copies of ``tensors`` (None passes through).  On the
    card: pinned buffers filled by ``non_blocking`` copies on ``stream``
    once ``ready`` (:func:`ready_event`) has passed, then waited for.  The
    caller holds the tensors until this returns, so their memory is not
    reused while the side stream reads it."""
    if ready is None:
        return [None if a is None else a.detach().cpu().numpy()
                for a in tensors]
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        host = [None if a is None else
                torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                .copy_(a, non_blocking=True) for a in tensors]
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return [None if h is None else h.numpy() for h in host]
