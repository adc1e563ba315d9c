"""Bounded background batch prefetcher: the port of
``dlti_tpu/data/prefetch.py``'s ``HostPrefetcher``.

A worker thread consumes the source iterator (a dataset's ``epoch(...)``:
row gathers, padding and packing in numpy) into a FIFO queue ``depth``
batches deep, so the training thread finds the next host batch ready. The
trainer keeps every copy to the card on its own thread: it stacks a
window's host batches and uploads them into the step graph's static inputs
between windows, so nothing the graph reads changes under it.

Guarantees, in the reference's order: (1) the batches arrive in the source
order, one worker consuming it sequentially; (2) at most ``depth`` batches
(plus the one in flight) are made ahead; (3) :meth:`close` stops a worker
blocked on a full queue, joins it, and may be called more than once; (4) an
exception in the source re-raises on the consumer at the ``next()`` that
would have returned its batch.

Iteration yields the source's batches themselves: the reference's
``place_fn`` issued device puts ahead of need, which the port's trainer
keeps on its own thread. Telemetry: a queue-depth gauge, a stall-time
histogram (the reference's names) and a raw ``stats`` dict. The reference's
tracer spans are not ported.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator

from dlti_tpu_torch.telemetry.registry import Gauge, Histogram

PREFETCH_STALL_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5,
)

PREFETCH_METRIC_NAMES = (
    "dlti_train_prefetch_queue_depth",
    "dlti_train_prefetch_stall_seconds",
)

_OK, _ERR, _END = 0, 1, 2


class HostPrefetcher:
    """Iterate ``source`` on a background thread through a bounded queue."""

    def __init__(self, source: Iterable, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self.queue_depth = Gauge(PREFETCH_METRIC_NAMES[0],
                                 help="batches buffered ahead of the training step thread")
        self.stall_time = Histogram(
            PREFETCH_METRIC_NAMES[1], PREFETCH_STALL_BUCKETS,
            help="time the step thread blocked waiting for the next batch",
            stats_key="train_prefetch_stall_seconds")
        self.stats = {"fetches": 0, "stalls": 0, "stall_time_s": 0.0}
        self._thread = threading.Thread(target=self._worker, name="dlti-prefetch",
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item``, looking at the stop flag every 50 ms."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            it = iter(self._source)
            while not self._stop.is_set():
                try:
                    batch = next(it)
                except StopIteration:
                    break
                if not self._put((_OK, batch)):
                    return  # closed while blocked on a full queue
                self.queue_depth.set(self._q.qsize())
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            self._put((_ERR, e))
            return
        self._put((_END, None))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        tag, payload = self._q.get()
        stall = time.perf_counter() - t0
        self.queue_depth.set(self._q.qsize())
        if tag == _END:
            self._done = True
            self._thread.join(timeout=5.0)
            raise StopIteration
        if tag == _ERR:
            self._done = True
            raise payload
        self.stall_time.observe(stall)
        self.stats["fetches"] += 1
        self.stats["stall_time_s"] += stall
        if stall > 1e-4:  # below this the batch was effectively ready
            self.stats["stalls"] += 1
        return payload

    def close(self) -> None:
        """Stop the worker and drop the buffered batches."""
        self._done = True
        self._stop.set()
        while True:  # drain, so a worker blocked in put() sees the stop flag
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        self.queue_depth.set(0)
