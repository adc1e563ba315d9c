"""Low-overhead host-side span tracer with Chrome-trace-event export: the
port of ``dlti_tpu/telemetry/tracer.py`` (standard library only).

The host-side complement to ``torch.profiler`` (which sees device kernels
but not the scheduler): spans cover the *host* phases of a training step (batch
fetch, host→device transfer, compiled-step dispatch, device sync, eval,
checkpoint save) and of a request's life in the serving engine (queued →
prefill → decode). Export is the Chrome trace-event JSON format
(``{"traceEvents": [...]}``), viewable in Perfetto (https://ui.perfetto.dev)
or ``chrome://tracing``.

Design constraints:

* **Near-zero cost when disabled.** ``span()`` on a disabled tracer is one
  attribute read + returning a shared no-op context manager — no dict, no
  clock read, no lock. This is what makes it safe to leave instrumentation
  in the engine's per-step path unconditionally (guarded by the overhead
  smoke in ``tests/test_telemetry.py``).
* **Bounded memory.** Events land in a ring buffer (``deque(maxlen=...)``);
  a long-lived server keeps the most recent ``capacity`` events and never
  grows. Export is a snapshot of the ring.
* **Thread-safe.** Handler threads, the engine stepper, and the trainer all
  append under one lock; ``ts`` comes from ``time.monotonic()`` so all
  threads share a clock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._complete_event(
            self._name, self._t0, time.monotonic(), self._cat,
            threading.get_ident(), self._args)
        return False


class SpanTracer:
    """Ring-buffered span tracer emitting Chrome trace events."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        self.enabled = enabled
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._pid = os.getpid()
        # Events silently evicted by the ring since process start. The ring
        # overwriting oldest-first is the design — but forensics consumers
        # (flight-record dumps, /debug/trace) must be able to tell "this is
        # the whole story" from "this is the most recent window of a longer
        # one", so truncation is counted, never silent.
        self._dropped = 0
        # Total events ever appended — the cursor axis for events_since()
        # (fleet workers ship ring tails incrementally in step/health
        # replies; the cursor survives ring eviction because it counts
        # appends, not positions).
        self._total = 0
        # Optional human label for this process's Perfetto row; when set,
        # exports prepend a "ph":"M" process_name metadata event so a
        # merged multi-process timeline renders one named row per source
        # instead of collapsing everything into anonymous pids.
        self.process_label: Optional[str] = None

    # -- recording ------------------------------------------------------
    def span(self, name: str, cat: str = "host", **args):
        """Context manager timing a host phase. Disabled: a shared no-op."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def complete(self, name: str, start_s: float, end_s: float,
                 cat: str = "host", tid: Optional[int] = None,
                 **args) -> None:
        """Record an already-measured span (``time.monotonic`` seconds) —
        how request-lifecycle phases are emitted after the fact from the
        timestamps the engine keeps on each :class:`Request`."""
        if not self.enabled:
            return
        self._complete_event(name, start_s, end_s, cat,
                             tid if tid is not None else threading.get_ident(),
                             args)

    def instant(self, name: str, cat: str = "host",
                tid: Optional[int] = None, **args) -> None:
        if not self.enabled:
            return
        ev = {"ph": "i", "name": name, "cat": cat, "s": "t",
              "ts": time.monotonic() * 1e6, "pid": self._pid,
              "tid": (tid if tid is not None else threading.get_ident())
              & 0x7FFFFFFF}
        if args:
            ev["args"] = args
        self._append(ev)

    def _complete_event(self, name, start_s, end_s, cat, tid, args) -> None:
        ev = {"ph": "X", "name": name, "cat": cat,
              "ts": start_s * 1e6, "dur": max(0.0, (end_s - start_s) * 1e6),
              "pid": self._pid, "tid": tid & 0x7FFFFFFF}
        if args:
            ev["args"] = args
        self._append(ev)

    def _append(self, ev: dict) -> None:
        with self._lock:
            if (self._events.maxlen is not None
                    and len(self._events) == self._events.maxlen):
                self._dropped += 1
            self._events.append(ev)
            self._total += 1

    # -- inspection / export --------------------------------------------
    @property
    def dropped_events(self) -> int:
        """Events evicted by the ring since process start (monotonic —
        ``clear()`` does not reset it; it feeds a /metrics counter)."""
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    @property
    def total_events(self) -> int:
        """Events ever appended (cursor axis for :meth:`events_since`)."""
        with self._lock:
            return self._total

    def events_since(self, cursor: int, limit: int = 512) -> tuple:
        """Incremental tail read: everything appended after ``cursor``
        (a previous return value; start at 0), oldest first, capped at
        ``limit`` per call. Returns ``(events, dropped, new_cursor)``
        where ``dropped`` counts events that were appended after the
        cursor but already evicted by the ring — shipped as a count so
        the consumer's truncation accounting stays honest."""
        with self._lock:
            unshipped = max(0, self._total - max(0, cursor))
            avail = len(self._events)
            dropped = max(0, unshipped - avail)
            take = min(unshipped - dropped, max(0, limit))
            start = avail - (unshipped - dropped)
            evs = [self._events[i] for i in range(start, start + take)]
            return evs, dropped, self._total - (unshipped - dropped - take)

    def metadata_events(self) -> list:
        """``"ph":"M"`` process_name metadata for this process's row
        (empty unless :attr:`process_label` is set)."""
        if not self.process_label:
            return []
        # ts is meaningless on metadata events but present so every
        # exported event satisfies the {ph, ts, name} schema consumers pin.
        return [{"ph": "M", "name": "process_name", "cat": "__meta",
                 "ts": 0.0, "pid": self._pid, "tid": 0,
                 "args": {"name": self.process_label}}]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_dict(self) -> dict:
        # droppedEvents is an extra top-level key: Perfetto/chrome://tracing
        # ignore unknown keys, while forensics consumers (flight records,
        # /debug/trace readers) use it to see whether the window truncated.
        return {"traceEvents": self.metadata_events() + self.events(),
                "displayTimeUnit": "ms",
                "droppedEvents": self.dropped_events}

    def export(self, path: str) -> str:
        """Write the ring snapshot as Chrome-trace JSON; returns ``path``.
        Open the file in Perfetto (ui.perfetto.dev) or chrome://tracing."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)
        return path


# ----------------------------------------------------------------------
# Process-global tracer: the engine, server, and trainer all record into
# one timeline so a combined trace shows scheduler + request interleaving.
# Disabled by default — entry points enable it from config/CLI flags.
# ----------------------------------------------------------------------
_GLOBAL = SpanTracer()


def get_tracer() -> SpanTracer:
    return _GLOBAL


def configure_tracer(enabled: Optional[bool] = None,
                     capacity: Optional[int] = None) -> SpanTracer:
    """Enable/resize the process-global tracer (idempotent)."""
    t = _GLOBAL
    if capacity is not None and capacity != t.capacity:
        with t._lock:
            t.capacity = capacity
            t._dropped += max(0, len(t._events) - capacity)
            t._events = deque(t._events, maxlen=capacity)
    if enabled is not None:
        t.enabled = enabled
    return t
