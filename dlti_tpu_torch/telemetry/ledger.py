"""Goodput ledger & critical-path attribution: account every training
second and every request millisecond (the port of
``dlti_tpu/telemetry/ledger.py``, standard library only). The serving
engine, gateway and replica fleet book into the critical path; the port's
trainer does not book its phases into a :class:`GoodputLedger` yet
(ROADMAP.md).

MegaScale's observability thesis (echoed in ``steplog.py`` /
``timeseries.py``) is that goodput at scale is *recovered by attribution*:
the framework itself must say where the time went, or recovery work
(restarts, rollbacks, tier restores, failovers) silently eats the wall
clock the throughput headline claims. This module is the two-sided
accounting layer:

**Training — :class:`GoodputLedger`, a phase clock.** At any instant the
run is in exactly one phase; every ``enter(phase)`` transition books the
elapsed interval to the *previous* phase's bucket, so bucket totals sum to
wall clock *by construction* (the conservation property is tier-1-tested,
not aspirational). The trainer transitions at the same sites its tracer
spans cover (data wait, host→device, step dispatch, device sync,
eval, checkpoint save/restore, sentinel rollback, SDC probe); after a
sentinel rollback the re-executed steps book to ``replay`` instead of
``step_compute`` (``begin_replay``/``end_replay``), so a drill that
converges still shows what fraction of the run was productive. The
elastic supervisor stitches per-generation worker ledgers across restarts
and adds the buckets only it can see: ``restart_downtime`` (teardown +
backoff + respawn gaps) and shrunk-world degradation
(:func:`stitch_ledgers`).

**Serving — per-request critical-path attribution.** The engine, gateway,
prefix tiers and failover paths already stamp monotonic timestamps on
each :class:`~dlti_tpu_torch.serving.engine.Request`;
:func:`request_breakdown` assembles them into a phase breakdown
(``gateway_queue`` → ``queue`` → ``tier_restore`` → ``prefill`` →
``decode``, plus ``failover``/``preempt`` requeue stalls) that sums to
the client-observed latency. :class:`CriticalPathTracker` (one per
:class:`~dlti_tpu_torch.telemetry.lifecycle.RequestTelemetry`, shared across
replicas) folds every finished request into the
``dlti_request_phase_seconds_total{phase=}`` exposition and retains the K
worst requests with their full timelines for ``GET /debug/slow`` — the
answer to "why was this p99 request slow: queue, prefill, tier restore,
or failover?".

Cost contract (same as the tracer): a *disabled* ledger's ``enter()`` is
one attribute read + an early return — no clock read, no lock, no dict —
so the per-step instrumentation can stay in the trainer unconditionally.

Metric names are a scrape contract (pinned in
``tests/test_bench_contract.py``); bucket and phase label sets are
parsing contracts for the same reason.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from dlti_tpu_torch.telemetry.registry import Counter, Gauge

# ----------------------------------------------------------------------
# Bucket / phase catalogs (label contracts — postmortem, dashboards and
# the steplog parse these; pinned in tests/test_bench_contract.py)
# ----------------------------------------------------------------------

# Training wall-clock buckets a worker books itself. "step_compute" is
# the host-side dispatch of the compiled step; "device_sync" is the
# blocking wait for its results (where the device work actually
# surfaces); both count as PRODUCTIVE. "other" absorbs bookkeeping and
# anything not worth its own bucket — it must stay small, and because
# every second lands somewhere, a regression there is visible instead of
# invisible.
GOODPUT_BUCKETS = (
    "startup",            # init, compile, resume scan before first step
    "step_compute",       # compiled-step dispatch (host side)
    "device_sync",        # blocking wait on step results
    "data_wait",          # batch fetch stall (prefetch hides, not books)
    "host_to_device",     # global batch assembly / placement
    "eval",
    "checkpoint_save",
    "checkpoint_restore",  # verified resume at train start
    "rollback",           # sentinel rollback: restore + quarantine writes
    "replay",             # re-executing steps discarded by a rollback
    "sdc_probe",          # cross-rank param digest checks
    "shutdown",           # final saves / teardown
    "other",              # per-step bookkeeping, logging, residual host work
)

# Buckets only the elastic supervisor can book (stitched ledger).
SUPERVISOR_BUCKETS = ("restart_downtime",)

PRODUCTIVE_BUCKETS = ("step_compute", "device_sync")

# Serving per-request phases. A breakdown's values sum to the
# client-observed latency (enqueue-or-arrival → finish); "other" is the
# residual that keeps the sum exact when clamping eats sub-ms slivers.
REQUEST_PHASES = (
    "gateway_queue",   # admission-gateway queue (enqueue → engine submit)
    "queue",           # engine waiting deque (submit → slot admission)
    "tier_restore",    # host/disk prefix-block fetch + restore scatter
    "prefill",         # admission → first token, minus restore/stalls
    "failover",        # requeued after a replica fault, waiting again
    "preempt",         # preempted under memory pressure, waiting again
    "kv_handoff",      # disagg: prefill→decode paged-KV block migration
    "decode",          # first token → finish, minus requeue stalls
    "other",           # residual (clamp slivers; sum stays exact)
)

# Name-stability contracts (pinned in tests/test_bench_contract.py).
LEDGER_METRIC_NAMES = (
    "dlti_goodput_fraction",
    "dlti_goodput_seconds_total",
    "dlti_goodput_mfu_percent",
)
REQUEST_PHASE_METRIC_NAMES = (
    "dlti_request_phase_seconds_total",
    "dlti_request_phase_requests_total",
)

# Module-level metrics (the checkpoint-store/watchdog pattern: trainer
# sets them, the server registry registers them for /metrics).
goodput_fraction_gauge = Gauge(
    LEDGER_METRIC_NAMES[0],
    help="fraction of booked wall clock spent in productive step compute")
goodput_seconds_total = Counter(
    LEDGER_METRIC_NAMES[1],
    help="wall-clock seconds booked per goodput bucket (bucket label)",
    labelnames=("bucket",))
goodput_mfu_gauge = Gauge(
    LEDGER_METRIC_NAMES[2],
    help="model FLOPs utilization of the most recent training step")
phase_seconds_total = Counter(
    REQUEST_PHASE_METRIC_NAMES[0],
    help="per-request critical-path seconds per phase (phase label)",
    labelnames=("phase",))
phase_requests_total = Counter(
    REQUEST_PHASE_METRIC_NAMES[1],
    help="finished requests folded into the phase attribution")


# ----------------------------------------------------------------------
# Training: the phase clock
# ----------------------------------------------------------------------

class GoodputLedger:
    """Wall-clock phase clock with conservation by construction.

    Thread-safety: ``enter`` is called from the trainer's step thread
    only; ``totals``/``scalars`` may be read concurrently by the
    time-series sampler thread, so transitions and reads share one lock.
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = enabled
        self._clock = clock
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._deltas: Dict[str, float] = {}
        self._phase = "startup"
        now = clock() if enabled else 0.0
        self._t0 = now
        self._start = now
        # While replaying rolled-back steps, step buckets reclass to
        # "replay": set to the pre-rollback high-water step by
        # begin_replay, cleared by end_replay.
        self.replay_until: Optional[int] = None

    # -- transitions ----------------------------------------------------
    def enter(self, phase: str) -> None:
        """Book time since the last transition to the previous phase and
        make ``phase`` current. Disabled: one attribute read."""
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            prev = self._phase
            if self.replay_until is not None and prev in PRODUCTIVE_BUCKETS:
                prev = "replay"
            dt = max(0.0, now - self._t0)
            self._totals[prev] = self._totals.get(prev, 0.0) + dt
            self._deltas[prev] = self._deltas.get(prev, 0.0) + dt
            self._phase = phase
            self._t0 = now

    def begin_replay(self, until_step: int) -> None:
        """Steps (re-)executed while the optimizer step stays at or below
        ``until_step`` are rollback replay, not fresh progress."""
        if self.enabled:
            self.replay_until = int(until_step)

    def end_replay(self) -> None:
        self.replay_until = None

    # -- reads ----------------------------------------------------------
    def wall(self) -> float:
        """Seconds since construction (0.0 disabled)."""
        return self._clock() - self._start if self.enabled else 0.0

    def totals(self) -> Dict[str, float]:
        """Bucket seconds including the still-open current phase; the
        values sum to :meth:`wall` exactly (float rounding aside)."""
        if not self.enabled:
            return {}
        now = self._clock()
        with self._lock:
            out = dict(self._totals)
            cur = self._phase
            if self.replay_until is not None and cur in PRODUCTIVE_BUCKETS:
                cur = "replay"
            out[cur] = out.get(cur, 0.0) + max(0.0, now - self._t0)
        return out

    def take_deltas(self) -> Dict[str, float]:
        """Bucket seconds accrued since the previous call (the per-step
        feed for the steplog fields and the ``dlti_goodput_seconds_total``
        counter). Does not close the open phase — sub-transition time
        rides into the next call."""
        if not self.enabled:
            return {}
        with self._lock:
            d, self._deltas = self._deltas, {}
        return d

    def goodput_fraction(self,
                         totals: Optional[Dict[str, float]] = None) -> float:
        t = self.totals() if totals is None else totals
        wall = sum(t.values())
        if wall <= 0:
            return 0.0
        return sum(t.get(b, 0.0) for b in PRODUCTIVE_BUCKETS) / wall

    def scalars(self) -> Dict[str, float]:
        """``goodput_*`` keys for the time-series ring / ``/debug/vars``
        (what the watchdog's goodput_collapse rule and the flight-dump
        metrics snapshot consume)."""
        if not self.enabled:
            return {}
        t = self.totals()
        out = {f"goodput_{k}_seconds": round(v, 6) for k, v in t.items()}
        out["goodput_wall_seconds"] = round(sum(t.values()), 6)
        out["goodput_fraction"] = round(self.goodput_fraction(t), 6)
        return out

    def to_dict(self) -> dict:
        t = self.totals()
        return {"buckets": {k: round(v, 6) for k, v in t.items()},
                "wall_s": round(sum(t.values()), 6),
                "goodput_fraction": round(self.goodput_fraction(t), 6)}

    def save(self, path: str, **extra) -> Optional[str]:
        """Atomic JSON write of :meth:`to_dict` + ``extra``; never raises
        (accounting must not kill the run it accounts). None disabled."""
        if not self.enabled:
            return None
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({**self.to_dict(), **extra}, f)
            os.replace(tmp, path)
            return path
        except OSError:
            return None


# ----------------------------------------------------------------------
# Elastic stitching: one ledger across restarts
# ----------------------------------------------------------------------

def load_generation_ledgers(elastic_dir: str) -> List[dict]:
    """Parse every ``ledger_g*_r*.json`` a worker saved into the elastic
    rendezvous dir (``training.elastic.save_generation_ledger``)."""
    out: List[dict] = []
    try:
        names = sorted(os.listdir(elastic_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("ledger_g") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(elastic_dir, name)) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            continue
    return out


def stitch_ledgers(worker_ledgers: List[dict], timeline: List[dict],
                   num_slots: int) -> dict:
    """Stitch per-generation worker ledgers + the supervisor's generation
    timeline into one run-level ledger.

    ``timeline`` entries: ``{"generation", "world_size", "start", "end",
    "outcome"}`` on the supervisor's clock. Only the supervisor sees the
    two buckets workers cannot: ``restart_downtime`` (the gap between one
    generation's end and the next one's start — teardown residue, backoff,
    respawn) and shrunk-world degradation (wall clock run at
    ``world_size < num_slots``, with the pro-rata capacity loss).

    Worker buckets are taken from ONE rank per generation (rank 0 when
    present): ranks run the same step-synchronous schedule in parallel,
    so summing across ranks would double-count wall clock.
    """
    per_gen: Dict[int, List[dict]] = {}
    for w in worker_ledgers:
        per_gen.setdefault(int(w.get("generation", 0)), []).append(w)
    buckets: Dict[str, float] = {}
    generations = []
    for gen in sorted(per_gen):
        ws = sorted(per_gen[gen], key=lambda w: int(w.get("rank", 0)))
        rep = ws[0]
        for k, v in (rep.get("buckets") or {}).items():
            buckets[k] = buckets.get(k, 0.0) + float(v)
        generations.append({
            "generation": gen, "rank": rep.get("rank"),
            "wall_s": rep.get("wall_s"),
            "goodput_fraction": rep.get("goodput_fraction"),
            "buckets": rep.get("buckets") or {},
            "num_rank_ledgers": len(ws),
        })
    segs = sorted(timeline, key=lambda s: s.get("start", 0.0))
    downtime = sum(max(0.0, b["start"] - a["end"])
                   for a, b in zip(segs, segs[1:]))
    shrunk_wall = 0.0
    shrunk_loss = 0.0
    for s in segs:
        wall = max(0.0, float(s.get("end", 0.0)) - float(s.get("start", 0.0)))
        world = int(s.get("world_size", num_slots))
        if 0 < world < num_slots:
            shrunk_wall += wall
            shrunk_loss += wall * (num_slots - world) / num_slots
    if downtime > 0:
        buckets["restart_downtime"] = round(
            buckets.get("restart_downtime", 0.0) + downtime, 6)
    total = sum(buckets.values())
    productive = sum(buckets.get(b, 0.0) for b in PRODUCTIVE_BUCKETS)
    return {
        "num_slots": num_slots,
        "num_generations": len(segs) or len(generations),
        "generations": generations,
        "buckets": {k: round(v, 6) for k, v in buckets.items()},
        "wall_s": round(total, 6),
        "restart_downtime_s": round(downtime, 6),
        "shrunk_world_s": round(shrunk_wall, 6),
        "shrunk_world_capacity_loss_s": round(shrunk_loss, 6),
        "goodput_fraction": round(productive / total, 6) if total else 0.0,
    }


# ----------------------------------------------------------------------
# Serving: per-request critical-path attribution
# ----------------------------------------------------------------------

def note_requeue(req, kind: str) -> None:
    """Mark a request leaving a slot back to a waiting queue (``kind`` in
    ``("failover", "preempt", "kv_handoff")``); the wait until
    re-admission books to that phase instead of inflating prefill/decode.

    A mark may already be open: a slot preempted mid-chunked-prefill whose
    replica then dies is requeued AGAIN (failover) before the preempt wait
    was ever closed by a re-admission. Fold the open window into its phase
    first — overwriting the mark would silently drop the elapsed wait and
    restart the charge window, and the lost time would book into prefill.
    """
    note_readmitted(req)
    req._requeue_mark = (kind, time.monotonic())


def note_readmitted(req) -> None:
    """Close an open requeue mark at (re-)admission time."""
    mark = getattr(req, "_requeue_mark", None)
    if not mark:
        return
    kind, t0 = mark
    req._requeue_mark = None
    dt = max(0.0, time.monotonic() - t0)
    req.stall_s[kind] = req.stall_s.get(kind, 0.0) + dt
    if req.first_token_time is None:
        req.stall_prefill_s += dt


def request_breakdown(req, end: Optional[float] = None) -> dict:
    """Assemble a request's recorded timestamps into a phase breakdown
    whose values sum to the client-observed latency (t0 = gateway enqueue
    when the request came through one, else engine arrival; end = finish).

    Returns ``{"total_s", "ttft_s", "phases": {phase: s}, "timeline":
    [(event, offset_s)]}``; ``phases`` keys come from
    :data:`REQUEST_PHASES` and always include the ``other`` residual that
    keeps the sum exact when clamping trims negative slivers.
    """
    gw_t = getattr(req, "gateway_enqueue_time", None)
    t0 = gw_t if gw_t is not None else req.arrival_time
    end = req.finish_time if req.finish_time is not None \
        else (end if end is not None else time.monotonic())
    first = req.first_token_time
    admitted = req.admitted_time
    restore = float(getattr(req, "restore_s", 0.0))
    stall = dict(getattr(req, "stall_s", {}) or {})
    stall_pre = float(getattr(req, "stall_prefill_s", 0.0))
    mark = getattr(req, "_requeue_mark", None)
    if mark:  # died waiting on a requeue (e.g. failover exhausted)
        dt = max(0.0, end - mark[1])
        stall[mark[0]] = stall.get(mark[0], 0.0) + dt
        if first is None:
            stall_pre += dt
    stall_total = sum(stall.values())
    stall_pre = min(stall_pre, stall_total)

    phases: Dict[str, float] = {}
    timeline: List[tuple] = [("submitted", max(0.0, req.arrival_time - t0))]
    if gw_t is not None:
        phases["gateway_queue"] = max(0.0, req.arrival_time - gw_t)
        timeline.insert(0, ("gateway_enqueue", 0.0))
    adm = admitted if admitted is not None else (first or end)
    phases["queue"] = max(0.0, adm - req.arrival_time)
    if admitted is not None:
        timeline.append(("admitted", max(0.0, admitted - t0)))
    if restore > 0:
        phases["tier_restore"] = restore
    pre_end = first if first is not None else end
    phases["prefill"] = max(0.0, (pre_end - adm) - restore - stall_pre)
    if first is not None:
        timeline.append(("first_token", max(0.0, first - t0)))
        phases["decode"] = max(0.0, (end - first)
                               - (stall_total - stall_pre))
    for kind, s in stall.items():
        if s > 0:
            phases[kind] = s
    timeline.append(("finish", max(0.0, end - t0)))
    total = round(max(0.0, end - t0), 6)
    # The residual is computed AGAINST THE ROUNDED values: the emitted
    # phases sum to the emitted total exactly (per-phase rounding would
    # otherwise leak a few microseconds of drift into consumers'
    # conservation checks).
    rounded = {k: round(v, 6) for k, v in phases.items()}
    residual = round(total - sum(rounded.values()), 6)
    rounded["other"] = max(0.0, residual)
    if residual < 0:
        # Per-phase round-ups can overshoot the rounded total by a few
        # microseconds; shave the excess off the largest phase so the
        # emitted numbers conserve exactly.
        top = max(rounded, key=lambda k: rounded[k])
        rounded[top] = round(rounded[top] + residual, 6)
    return {
        "total_s": total,
        "ttft_s": (round(first - t0, 6) if first is not None else None),
        "phases": rounded,
        "timeline": [(name, round(off, 6)) for name, off in timeline],
    }


class SlowLog:
    """Bounded retention of the K worst (slowest) finished requests with
    their full phase timelines — the ``GET /debug/slow`` payload."""

    def __init__(self, k: int = 32):
        self.k = max(1, int(k))
        self._lock = threading.Lock()
        self._entries: List[dict] = []

    def add(self, entry: dict) -> None:
        with self._lock:
            self._entries.append(entry)
            self._entries.sort(key=lambda e: -e.get("total_s", 0.0))
            del self._entries[self.k:]

    def worst(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._entries)
        return out if n is None else out[:n]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class CriticalPathTracker:
    """Folds finished requests into the phase exposition + slow log.
    One per :class:`RequestTelemetry` (shared across replicas). Per
    REQUEST, not per token — and ``enabled = False`` reduces
    ``observe()`` to one attribute read."""

    def __init__(self, slow_k: int = 32):
        self.enabled = True
        self.slow = SlowLog(slow_k)

    def observe(self, req) -> Optional[dict]:
        if not self.enabled:
            return None
        if getattr(req, "_cp_observed", False):
            return None  # failover-errored requests can finish twice
        req._cp_observed = True
        b = request_breakdown(req)
        phase_requests_total.inc()
        for k, v in b["phases"].items():
            if v > 0:
                phase_seconds_total.labels(phase=k).inc(v)
        self.slow.add({
            "id": req.request_id,
            "trace_id": getattr(req, "trace_id", ""),
            "tenant": req.tenant,
            "priority": req.priority,
            "replica": req.replica,
            "finish_reason": req.finish_reason,
            "prompt_tokens": len(req.prompt_token_ids),
            "output_tokens": len(req.output_token_ids),
            "preemptions": req.num_preemptions,
            "retries": req.num_retries,
            "wall": time.time(),
            "total_s": b["total_s"],
            "ttft_s": b["ttft_s"],
            "phases": b["phases"],
            "timeline": b["timeline"],
        })
        return b
