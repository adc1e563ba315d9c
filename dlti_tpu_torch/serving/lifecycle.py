"""Replica lifecycle: the serving fleet's self-healing state machine, the
port of ``dlti_tpu/serving/lifecycle.py``.

Each replica walks::

    live -> quarantined -> probing -> live
                 \\-> (flap breaker) -> evicted

* A fault quarantines the replica (its engine is torn down and rebuilt from
  known-good weights by :class:`~dlti_tpu_torch.serving.replicas.
  ReplicatedEngine`).
* After an exponential probation (``probation_initial_s *
  probation_backoff**failures``, capped at ``probation_max_s``) the replica
  is probed: a short greedy canary generation on the rebuilt engine,
  checked against a digest pinned at fleet construction (and re-pinned by a
  weight reload). A pass reinstates; a failure re-quarantines with a longer
  probation.
* The flap breaker evicts for good: more than ``flap_max_cycles``
  quarantines inside ``flap_window_s`` mean the replica is bad, and
  re-probing it only churns the fleet.

``draining`` is the planned exit (rolling reload, chaos ``preempt``): the
replica takes no dispatch while its decodes migrate to survivors over the
paged-KV handoff.

The class is bookkeeping on an injectable clock (no engine calls, no
threads); the owning ``ReplicatedEngine`` does the rebuild, probe and
migration work on its stepper thread. The series keep the reference's names
(module-level, shared by every fleet in the process).
"""

from __future__ import annotations

import hashlib
import logging
import time
from collections import deque
from typing import Callable, Dict, List, Sequence

from dlti_tpu_torch.config import ReplicaLifecycleConfig
from dlti_tpu_torch.telemetry.registry import Counter, Gauge

logger = logging.getLogger("dlti_tpu_torch.serving.lifecycle")

LIFECYCLE_METRIC_NAMES = (
    "dlti_replica_lifecycle_quarantines_total",
    "dlti_replica_lifecycle_reinstates_total",
    "dlti_replica_lifecycle_flaps_total",
    "dlti_replica_lifecycle_migrations_total",
    "dlti_replica_lifecycle_migration_fallbacks_total",
    "dlti_replica_state",
)

quarantines_total = Counter(
    LIFECYCLE_METRIC_NAMES[0],
    help="replicas quarantined after a fault or planned preemption")
reinstates_total = Counter(
    LIFECYCLE_METRIC_NAMES[1],
    help="quarantined replicas reinstated after a passing canary probe")
flaps_total = Counter(
    LIFECYCLE_METRIC_NAMES[2],
    help="replicas permanently evicted by the flap breaker")
migrations_total = Counter(
    LIFECYCLE_METRIC_NAMES[3],
    help="in-flight decodes moved to a survivor via paged-KV handoff")
migration_fallbacks_total = Counter(
    LIFECYCLE_METRIC_NAMES[4],
    help="drain migrations that fell back to failover re-prefill")
replica_state_gauge = Gauge(
    LIFECYCLE_METRIC_NAMES[5],
    help="per-replica lifecycle state code "
         "(0=live 1=quarantined 2=probing 3=draining 4=evicted)",
    labelnames=("replica",))

METRICS = (quarantines_total, reinstates_total, flaps_total, migrations_total,
           migration_fallbacks_total, replica_state_gauge)

LIVE, QUARANTINED, PROBING, DRAINING, EVICTED = STATES = (
    "live", "quarantined", "probing", "draining", "evicted")
_STATE_CODE = {s: i for i, s in enumerate(STATES)}


def canary_digest(tokens: Sequence[int]) -> str:
    """Stable digest of a canary generation's token ids (the reinstate gate
    compares a rebuilt replica's output against the pinned one)."""
    h = hashlib.sha256()
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()


class ReplicaLifecycle:
    """Per-replica state machine with probation and flap bookkeeping. Every
    method is cheap and never blocks; ``clock`` is injectable for tests."""

    def __init__(self, cfg: ReplicaLifecycleConfig, n_replicas: int, *,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self._state: Dict[int, str] = {i: LIVE for i in range(n_replicas)}
        self._probe_failures: Dict[int, int] = {i: 0 for i in range(n_replicas)}
        self._next_probe_t: Dict[int, float] = {}
        # Quarantine times inside the flap window, per replica.
        self._flap_times: Dict[int, deque] = {i: deque() for i in range(n_replicas)}
        # Local counters (the fleet's stats); the module counters feed /metrics.
        self.counters = {"quarantines": 0, "reinstates": 0, "flaps": 0,
                         "migrations": 0, "migration_fallbacks": 0}
        for i in range(n_replicas):
            self._publish(i)

    def _publish(self, idx: int) -> None:
        replica_state_gauge.labels(replica=str(idx)).set(_STATE_CODE[self._state[idx]])

    def _probation_s(self, idx: int) -> float:
        c = self.cfg
        return min(c.probation_max_s,
                   c.probation_initial_s * (c.probation_backoff ** self._probe_failures[idx]))

    def state(self, idx: int) -> str:
        return self._state[idx]

    def states(self) -> Dict[int, str]:
        return dict(self._state)

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in STATES}
        for s in self._state.values():
            out[s] += 1
        return out

    def on_fault(self, idx: int) -> str:
        """A replica faulted (or finished a planned drain). Returns where it
        landed: ``quarantined``, or ``evicted`` when the flap breaker
        tripped."""
        if self._state[idx] == EVICTED:
            return EVICTED
        now = self.clock()
        window = self._flap_times[idx]
        window.append(now)
        while window and now - window[0] > self.cfg.flap_window_s:
            window.popleft()
        if len(window) > self.cfg.flap_max_cycles:
            self._state[idx] = EVICTED
            self.counters["flaps"] += 1
            flaps_total.inc()
            self._publish(idx)
            logger.error("replica %d evicted by flap breaker: %d quarantines inside "
                         "%.0fs window (limit %d)", idx, len(window),
                         self.cfg.flap_window_s, self.cfg.flap_max_cycles)
            return EVICTED
        self._state[idx] = QUARANTINED
        self.counters["quarantines"] += 1
        quarantines_total.inc()
        self._next_probe_t[idx] = now + self._probation_s(idx)
        self._publish(idx)
        logger.warning("replica %d quarantined; probe in %.1fs", idx, self._probation_s(idx))
        return QUARANTINED

    def begin_drain(self, idx: int) -> None:
        """Planned exit: stop dispatch while in-flight work migrates off."""
        if self._state[idx] != EVICTED:
            self._state[idx] = DRAINING
            self._publish(idx)

    def due_probes(self) -> List[int]:
        """Quarantined replicas whose probation has elapsed."""
        now = self.clock()
        return [i for i, s in sorted(self._state.items())
                if s == QUARANTINED and now >= self._next_probe_t.get(i, 0.0)]

    def begin_probe(self, idx: int) -> None:
        self._state[idx] = PROBING
        self._publish(idx)

    def on_probe_result(self, idx: int, ok: bool) -> str:
        """The canary's verdict: a pass goes live (probation resets), a
        failure re-quarantines with an exponentially longer probation."""
        if ok:
            self._state[idx] = LIVE
            self._probe_failures[idx] = 0
            self.counters["reinstates"] += 1
            reinstates_total.inc()
            self._publish(idx)
            logger.info("replica %d reinstated after passing canary", idx)
            return LIVE
        self._probe_failures[idx] += 1
        self._state[idx] = QUARANTINED
        self._next_probe_t[idx] = self.clock() + self._probation_s(idx)
        self._publish(idx)
        logger.warning("replica %d canary failed (%d consecutive); next probe in %.1fs",
                       idx, self._probe_failures[idx], self._probation_s(idx))
        return QUARANTINED

    def evict(self, idx: int) -> None:
        """Permanent removal outside the flap breaker (counted as a flap)."""
        if self._state[idx] != EVICTED:
            self._state[idx] = EVICTED
            self.counters["flaps"] += 1
            flaps_total.inc()
            self._publish(idx)
            logger.error("replica %d permanently evicted", idx)

    def mark_dead(self, idx: int) -> None:
        """Terminal state without flap accounting: a fault with healing off
        (the replica was never quarantined, it died)."""
        if self._state[idx] != EVICTED:
            self._state[idx] = EVICTED
            self._publish(idx)

    def note_migration(self, n: int = 1) -> None:
        self.counters["migrations"] += n
        migrations_total.inc(n)

    def note_migration_fallback(self, n: int = 1) -> None:
        self.counters["migration_fallbacks"] += n
        migration_fallbacks_total.inc(n)

    def scalars(self) -> Dict[str, float]:
        """Flat snapshot for stats aggregation."""
        out = {f"replica_lifecycle_{k}_total": v for k, v in self.counters.items()}
        for s, n in self.counts().items():
            out[f"replica_lifecycle_{s}"] = n
        return out
