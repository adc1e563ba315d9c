"""Fleet-wide distributed tracing: span federation with clock alignment
(the port of ``dlti_tpu/telemetry/distributed_trace.py``, standard library
only). In the port, one process serves every replica, so requests mint and
carry their ``trace_id`` and ``GET /debug/trace?request_id=`` assembles
their timeline; the federation of worker span tails waits for the
multi-process fleet.

The span tracer (``telemetry.tracer``) is strictly per-process — a bounded
ring of Chrome trace events stamped with that process's ``time.monotonic()``
clock. Once serving went multi-process (fleet workers over the wire
protocol, disagg pools, drain migrations, failover resubmits) no single
ring could follow a request gateway → prefill worker → KV handoff → decode
worker → completion. This module federates those rings, Dapper-style:

* **Trace context** — every ``Request`` carries a ``trace_id`` minted at
  the gateway (or at ``submit`` for direct clients) that rides the
  FT_SUBMIT descriptor, handoff envelopes, drain migrations, disagg
  staging, failover resubmits, and shadow-tap replays, so spans emitted in
  any process for any leg of one request share an id
  (:func:`mint_trace_id`).
* **Clock alignment** — ``time.monotonic()`` is per-process: worker span
  timestamps are meaningless on the supervisor's axis until rebased. The
  supervisor samples each RPC round trip (send ``t0``, receive ``t1``,
  worker-reported clock ``tw``) and estimates the worker's clock offset
  NTP-style: ``offset ≈ (t0 + t1)/2 − tw`` with uncertainty ``(t1 − t0)/2``
  (the classic bound — the true offset lies within half the round trip of
  the midpoint estimate), EWMA-smoothed per worker
  (:class:`ClockOffsetEstimator`).
* **Federation** — workers ship bounded span-ring tails in FT_STEP /
  FT_HEALTH replies; the supervisor rebases them onto its own clock and
  merges them into a :class:`TraceFederator` ring tagged with one pid per
  source process (plus ``"ph": "M"`` process_name metadata), so the
  Perfetto export renders one coherent multi-process timeline and
  ``GET /debug/trace?request_id=`` can reconstruct a single request's
  cross-process span tree (:func:`request_timeline`).

Caveat: alignment is an *estimate*. Offsets are only as good as the RPC
round trips that produced them (uncertainty = smoothed half-RTT, exposed
per worker in ``dlti_trace_clock_offset_seconds``); sub-uncertainty
orderings between spans from *different* processes are not trustworthy,
which is why :func:`request_timeline` reports per-leg durations (intra-
process, exact) separately from cross-process wall span.
"""

from __future__ import annotations

import threading
import uuid
from collections import deque
from typing import Dict, Iterable, List, Optional

from dlti_tpu_torch.telemetry.registry import Counter, Gauge

# Scrape contract (pinned in tests/test_bench_contract.py and walked by
# tests/test_metric_naming.py).
TRACE_METRIC_NAMES = (
    "dlti_trace_federated_spans_total",
    "dlti_trace_unparented_spans_total",
    "dlti_trace_clock_offset_seconds",
)

# Module-level like the watchdog/flight counters: every federator in the
# process (serving fleet + both disagg pools) shares one series.
federated_spans_total = Counter(
    TRACE_METRIC_NAMES[0],
    help="remote spans ingested and rebased onto the local clock")
unparented_spans_total = Counter(
    TRACE_METRIC_NAMES[1],
    help="federated spans carrying no request/trace linkage (cannot be "
         "joined into any per-request timeline)")
clock_offset_gauge = Gauge(
    TRACE_METRIC_NAMES[2],
    help="EWMA-smoothed clock offset per worker (local ≈ remote + offset)",
    labelnames=("worker",))


def mint_trace_id() -> str:
    """One trace id per client request — minted once (at the gateway, or
    at ``submit`` for direct clients) and *propagated*, never re-derived,
    so every process that touches any leg of the request agrees on it."""
    return uuid.uuid4().hex[:16]


class ClockOffsetEstimator:
    """NTP-style offset estimator for one remote clock.

    ``sample(t0, t1, remote_time)`` takes the local send/receive
    timestamps around one RPC and the remote ``time.monotonic()`` reading
    taken while serving it. The midpoint estimate ``(t0+t1)/2 − tw`` is
    wrong by at most half the round trip (however asymmetric the two legs
    were, the remote stamp was taken somewhere inside the window), so
    half-RTT is the per-sample uncertainty. Both are EWMA-smoothed; the
    uncertainty term also absorbs observed drift (|raw − smoothed|), so a
    clock that is *moving* reports a wide bound rather than a confident
    stale one.

    Invariant (fixed true offset): ``|offset − true| ≤ uncertainty`` —
    each raw sample is within its half-RTT of the truth, and the
    uncertainty EWMA dominates the error EWMA term-by-term.
    """

    __slots__ = ("alpha", "offset", "uncertainty", "samples", "last_rtt")

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self.offset = 0.0              # local ≈ remote + offset (seconds)
        self.uncertainty = float("inf")
        self.samples = 0
        self.last_rtt = 0.0

    def sample(self, t0: float, t1: float, remote_time: float) -> None:
        if t1 < t0:                    # clock went backwards locally; skip
            return
        raw = 0.5 * (t0 + t1) - remote_time
        half_rtt = 0.5 * (t1 - t0)
        self.last_rtt = t1 - t0
        if self.samples == 0:
            self.offset = raw
            self.uncertainty = half_rtt
        else:
            a = self.alpha
            drift = abs(raw - self.offset)
            self.offset += a * (raw - self.offset)
            self.uncertainty += a * (max(half_rtt, drift) - self.uncertainty)
        self.samples += 1

    def rebase(self, remote_s: float) -> float:
        """Map a remote ``time.monotonic()`` reading onto the local axis."""
        return remote_s + self.offset

    def to_dict(self) -> dict:
        return {"offset_s": self.offset,
                "uncertainty_s":
                    self.uncertainty if self.samples else None,
                "samples": self.samples,
                "last_rtt_s": self.last_rtt}


class TraceFederator:
    """Supervisor-side merged span ring: remote span tails rebased onto
    the local clock, one synthetic pid per source process.

    Sources are registered by a stable key (worker index). Real pids are
    recorded when known, but the *render* pid is synthetic and stable
    across respawns (``100001 + key``) so a respawned worker keeps its
    Perfetto row; the real pid/generation ride in the process_name
    metadata instead.
    """

    SYNTHETIC_PID_BASE = 100001

    def __init__(self, capacity: int = 65536, alpha: float = 0.25):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._dropped = 0              # evicted here (remote drops separate)
        self._remote_dropped = 0       # spans the workers evicted pre-ship
        self._sources: Dict[object, dict] = {}
        self._alpha = alpha

    # -- sources & clocks ----------------------------------------------
    def source(self, key, *, pid: Optional[int] = None,
               label: Optional[str] = None) -> dict:
        """Get-or-create the bookkeeping record for one remote process."""
        with self._lock:
            src = self._sources.get(key)
            if src is None:
                src = self._sources[key] = {
                    "estimator": ClockOffsetEstimator(self._alpha),
                    "pid": None, "label": f"worker{key}",
                    "render_pid": self.SYNTHETIC_PID_BASE + (
                        key if isinstance(key, int) else
                        abs(hash(key)) % 10000),
                }
            if pid is not None:
                src["pid"] = pid
            if label is not None:
                src["label"] = label
            return src

    def estimator(self, key) -> ClockOffsetEstimator:
        return self.source(key)["estimator"]

    def observe_rpc(self, key, t0: float, t1: float,
                    remote_time) -> None:
        """Feed one RPC round trip into the source's clock estimator and
        refresh the per-worker offset gauge."""
        if not isinstance(remote_time, (int, float)):
            return
        est = self.estimator(key)
        est.sample(t0, t1, float(remote_time))
        clock_offset_gauge.labels(worker=str(key)).set(est.offset)

    def offsets(self) -> Dict[str, dict]:
        """Per-source offset estimates (persisted into flight-dump
        context so postmortem --all can rebase dump span tails)."""
        with self._lock:
            items = list(self._sources.items())
        return {str(k): {"label": s["label"], "pid": s["pid"],
                         **s["estimator"].to_dict()}
                for k, s in items}

    # -- ingestion ------------------------------------------------------
    def ingest(self, key, events: Iterable[dict], *,
               remote_dropped: int = 0) -> int:
        """Rebase a shipped span tail onto the local clock and merge it.

        Events arrive as raw Chrome trace dicts on the *remote* clock;
        each is copied (never mutated in place), shifted by the source's
        estimated offset, and re-tagged with the source's render pid.
        """
        src = self.source(key)
        off_us = src["estimator"].offset * 1e6
        n = unparented = 0
        ingested = []
        for ev in events or ():
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            ev["ts"] = float(ev.get("ts", 0.0)) + off_us
            ev["pid"] = src["render_pid"]
            args = ev.get("args")
            if not (isinstance(args, dict)
                    and (args.get("id") or args.get("trace"))):
                unparented += 1
            ingested.append(ev)
            n += 1
        if not n and not remote_dropped:
            return 0
        with self._lock:
            for ev in ingested:
                if (self._events.maxlen is not None
                        and len(self._events) == self._events.maxlen):
                    self._dropped += 1
                self._events.append(ev)
            self._remote_dropped += int(remote_dropped)
        if n:
            federated_spans_total.inc(n)
        if unparented:
            unparented_spans_total.inc(unparented)
        return n

    # -- export ---------------------------------------------------------
    @property
    def dropped_events(self) -> int:
        with self._lock:
            return self._dropped + self._remote_dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def metadata_events(self) -> List[dict]:
        """``"ph": "M"`` process_name events — one per source — so
        Perfetto renders each remote process as its own labeled row."""
        with self._lock:
            items = sorted(self._sources.items(), key=lambda kv: str(kv[0]))
        out = []
        for key, src in items:
            name = src["label"]
            if src["pid"]:
                name = f"{name} (pid {src['pid']})"
            out.append({"ph": "M", "name": "process_name", "cat": "__meta",
                        "ts": 0.0, "pid": src["render_pid"], "tid": 0,
                        "args": {"name": name}})
        return out

    def merged_dict(self, local_tracer=None,
                    local_label: str = "supervisor") -> dict:
        """One Perfetto-loadable timeline: local ring + every federated
        remote tail, already on one clock, with per-process metadata."""
        events = self.metadata_events()
        dropped = self.dropped_events
        if local_tracer is not None:
            events.append({"ph": "M", "name": "process_name",
                           "cat": "__meta", "ts": 0.0,
                           "pid": local_tracer._pid,
                           "tid": 0, "args": {"name": local_label}})
            events.extend(local_tracer.events())
            dropped += local_tracer.dropped_events
        events.extend(self.events())
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "droppedEvents": dropped,
                "clockOffsets": self.offsets()}


# ----------------------------------------------------------------------
# Per-request reconstruction
# ----------------------------------------------------------------------

# Lifecycle legs that tile the request's life (gateway queue → engine
# queue → prefill → decode): the union of their intervals is compared
# against client-observed latency. Other legs (kv_handoff staging, retry
# stalls) overlap these and are reported but never counted toward it.
SEQUENTIAL_LEGS = ("gateway/queued", "request/queued",
                   "request/prefill", "request/decode")


def _union_s(intervals: List[tuple]) -> float:
    """Total measure of a union of [start, end] µs intervals, in seconds.

    Union, not sum: a fleet request is observed TWICE per leg — the
    supervisor's mirror and the owning worker each emit e.g.
    ``request/prefill`` for the same request — and after rebasing the two
    observations overlap almost exactly. Summing would double-count;
    the union keeps 'time covered by this leg' exact."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total / 1e6


def _span_matches(ev: dict, request_id: str, trace_id: str) -> bool:
    args = ev.get("args")
    if not isinstance(args, dict):
        return False
    if request_id and args.get("id") == request_id:
        return True
    return bool(trace_id) and args.get("trace") == trace_id


def request_timeline(events: Iterable[dict], request_id: str, *,
                     trace_id: str = "",
                     client_latency_s: Optional[float] = None) -> dict:
    """Assemble one request's merged, clock-aligned span tree.

    ``events`` is any already-rebased event iterable (federator + local
    tracer). Spans join on ``args.id == request_id`` or ``args.trace ==
    trace_id``. Returns the causally-sorted spans, per-leg durations
    (interval *union* per span name — the supervisor mirror and the
    owning worker both observe each lifecycle leg, and the union
    de-duplicates them), the set of source pids, the cross-process wall
    span, and the residual: client-observed latency (when given; else the
    wall span) minus the time covered by the sequential lifecycle legs.
    """
    events = list(events)
    if not trace_id:
        # Allow lookup by trace id alone: pick it up from the first
        # matching span so the caller can pass either handle.
        for ev in events:
            args = ev.get("args")
            if isinstance(args, dict) and args.get("id") == request_id \
                    and args.get("trace"):
                trace_id = str(args["trace"])
                break
    spans = [ev for ev in events
             if ev.get("ph") in ("X", "i")
             and _span_matches(ev, request_id, trace_id)]
    spans.sort(key=lambda ev: (ev.get("ts", 0.0),
                               ev.get("ts", 0.0) + ev.get("dur", 0.0)))
    legs: Dict[str, dict] = {}
    intervals: Dict[str, List[tuple]] = {}
    for ev in spans:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "?")
        leg = legs.setdefault(name, {"dur_s": 0.0, "count": 0, "pids": []})
        ts = float(ev.get("ts", 0.0))
        intervals.setdefault(name, []).append(
            (ts, ts + float(ev.get("dur", 0.0))))
        leg["count"] += 1
        pid = ev.get("pid")
        if pid not in leg["pids"]:
            leg["pids"].append(pid)
    for name, leg in legs.items():
        leg["dur_s"] = _union_s(intervals[name])
    t0 = min((ev.get("ts", 0.0) for ev in spans), default=0.0)
    t1 = max((ev.get("ts", 0.0) + ev.get("dur", 0.0) for ev in spans),
             default=0.0)
    wall_s = max(0.0, (t1 - t0) / 1e6)
    # One combined union across the sequential legs: their intervals tile
    # enqueue → finish, and unioning (rather than summing per-leg
    # durations) keeps small cross-process overlaps — a worker's queued
    # leg inside the mirror's prefill window — from double-counting.
    seq_sum = _union_s([iv for name in SEQUENTIAL_LEGS
                        for iv in intervals.get(name, ())])
    baseline = client_latency_s if client_latency_s is not None else wall_s
    return {
        "request_id": request_id,
        "trace_id": trace_id,
        "spans": spans,
        "legs": {name: leg for name, leg in legs.items()},
        "sequential_legs": [n for n in SEQUENTIAL_LEGS if n in legs],
        "sequential_sum_s": seq_sum,
        "processes": sorted({ev.get("pid") for ev in spans
                             if ev.get("pid") is not None}),
        "wall_s": wall_s,
        "client_latency_s": client_latency_s,
        "residual_s": baseline - seq_sum,
    }


# ----------------------------------------------------------------------
# Flight-dump merging (postmortem --all)
# ----------------------------------------------------------------------

def merge_dump_tails(dumps: Iterable[dict]) -> dict:
    """Merge per-process flight-dump span tails onto one clock.

    Each entry: ``{"label", "pid", "offset_s", "uncertainty_s", "events",
    "dropped"}`` where ``offset_s`` maps that process's clock onto the
    reference (supervisor) clock — the value the worker persisted into its
    dump context from the supervisor's estimator (0 for the supervisor's
    own dump). Returns a Perfetto-loadable dict; distinct pids per source
    keep each process on its own row even when thread-fleet fakes share
    one real pid.
    """
    events: List[dict] = []
    meta: List[dict] = []
    sources: List[dict] = []
    dropped = 0
    for i, d in enumerate(sorted(dumps, key=lambda d: str(d.get("label")))):
        pid = d.get("pid") or (TraceFederator.SYNTHETIC_PID_BASE + i)
        label = str(d.get("label") or f"process{i}")
        off = d.get("offset_s") or 0.0
        unc = d.get("uncertainty_s")
        name = label if unc is None else f"{label} (±{unc * 1e3:.2f}ms)"
        meta.append({"ph": "M", "name": "process_name", "cat": "__meta",
                     "ts": 0.0, "pid": pid, "tid": 0,
                     "args": {"name": name}})
        sources.append({"label": label, "pid": pid, "offset_s": off,
                        "uncertainty_s": unc})
        dropped += int(d.get("dropped") or 0)
        for ev in d.get("events") or ():
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            ev["ts"] = float(ev.get("ts", 0.0)) + off * 1e6
            ev["pid"] = pid
            events.append(ev)
    events.sort(key=lambda ev: ev.get("ts", 0.0))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "droppedEvents": dropped, "sources": sources}
