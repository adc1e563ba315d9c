"""Admission gateway: the scheduling front end between HTTP and the
engine(s), the port of ``dlti_tpu/serving/gateway.py``.

* **Bounded admission queue**: at most ``max_queued_requests`` requests and
  ``max_queued_tokens`` prompt tokens wait; overflow is refused with HTTP
  429 and a ``Retry-After``.
* **Per-tenant token-bucket rate limit**: the tenant comes from the
  ``X-Tenant`` header (else a digest of ``Authorization``, else the default
  tenant); a refusal's Retry-After is derived from the bucket's deficit.
* **Priority and deadline scheduling**: ``interactive`` strictly before
  ``batch``, and within a class a weighted fair dequeue across tenants
  (stride scheduling: the queued tenant with the least virtual time goes
  next and advances by 1/weight). A request whose deadline passes while
  queued is shed before prefill with 503; one past its deadline mid-decode
  gets ``cancel_requested``.
* **Graceful drain**: :meth:`AdmissionGateway.drain` (SIGTERM in
  ``server.serve``) refuses new admissions with 503 while queued and
  in-flight requests finish.
* **Tenant -> adapter routing** (``adapter_map``) for requests without an
  ``X-Adapter`` header.

The gateway holds requests in its own per-(priority, tenant) queues and
dispatches into the engine only while the engine (every live replica of a
fleet) has free slots, so ordering is decided here, not in the engine's
FCFS deque. Its series on ``/metrics`` keep the reference's
``dlti_gateway_*`` names. Not ported (ROADMAP.md, with the tracer): the
``gateway/queued`` spans, the shed and reject instants and the request's
``trace_id``; no decision depends on them.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from dlti_tpu_torch.config import GatewayConfig
from dlti_tpu_torch.serving.sampling import SamplingParams
from dlti_tpu_torch.telemetry.registry import Counter

logger = logging.getLogger("dlti_tpu_torch.serving.gateway")

# Strict class order: every queued interactive request dequeues before any
# batch request (fairness applies across tenants within a class).
PRIORITIES = ("interactive", "batch")

GATEWAY_METRIC_NAMES = (
    "dlti_gateway_queue_depth",
    "dlti_gateway_queued_tokens",
    "dlti_gateway_inflight",
    "dlti_gateway_replicas_alive",
    "dlti_gateway_admitted_total",
    "dlti_gateway_rejected_total",
    "dlti_gateway_shed_total",
    "dlti_gateway_retries_total",
    "dlti_gateway_replica_faults_total",
    "dlti_gateway_affinity_sticky_total",
    "dlti_gateway_affinity_spill_total",
)


class AdmissionError(RuntimeError):
    """A synchronous admission refusal: one HTTP error response."""

    def __init__(self, status: int, message: str, retry_after: Optional[float] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.retry_after = retry_after


class GatewayRequest:
    """The request handle the HTTP handler gets at admission: the engine
    request's surface the server reads (id, prompt ids, parameters,
    outputs, the cancel flag), bound to the engine's request when the
    dispatcher admits it. ``cancel_requested`` set while queued makes the
    dispatcher drop the entry without a prefill."""

    def __init__(self, request_id: str, prompt_token_ids: List[int], params: SamplingParams):
        self.request_id = request_id
        self.prompt_token_ids = list(prompt_token_ids)
        self.params = params
        self._req = None
        self._cancel = False

    def bind(self, req) -> None:
        self._req = req
        if self._cancel:
            req.cancel_requested = True

    @property
    def output_token_ids(self) -> list:
        return self._req.output_token_ids if self._req is not None else []

    @property
    def done(self) -> bool:
        return self._req is not None and self._req.done

    @property
    def cancel_requested(self) -> bool:
        if self._req is not None:
            return self._req.cancel_requested
        return self._cancel

    @cancel_requested.setter
    def cancel_requested(self, value: bool) -> None:
        self._cancel = bool(value)
        if self._req is not None:
            self._req.cancel_requested = bool(value)


@dataclass
class _Pending:
    """One queued admission."""

    handle: GatewayRequest
    q: "queue.Queue"
    tenant: str
    priority: str
    deadline: Optional[float]  # absolute monotonic; None = none
    # Cache-affinity key (None = least-loaded dispatch).
    affinity_key: Optional[str] = None
    # Resolved LoRA adapter ("" = the base): X-Adapter, else the tenant's map.
    adapter: str = ""


class _TokenBucket:
    """A token bucket; the caller holds the gateway's lock."""

    __slots__ = ("tokens", "stamp")

    def __init__(self, burst: float):
        self.tokens = burst
        self.stamp = time.monotonic()

    def take(self, rate: float, burst: float) -> Optional[float]:
        """Take one token: None on success, else the seconds until one
        accrues (the Retry-After)."""
        now = time.monotonic()
        self.tokens = min(burst, self.tokens + (now - self.stamp) * rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        return max(0.001, (1.0 - self.tokens) / rate)


def tenant_from_headers(headers, default: str = "default") -> str:
    """``X-Tenant`` wins; else a stable digest of the ``Authorization``
    credential (per-key limits without a tenant registry); else the
    default tenant."""
    tenant = headers.get("X-Tenant") if headers is not None else None
    if tenant:
        return tenant.strip()
    auth = headers.get("Authorization") if headers is not None else None
    if auth:
        return "auth-" + hashlib.sha256(auth.encode()).hexdigest()[:12]
    return default


def affinity_key_from(headers, prompt_token_ids, prefix_tokens: int = 32,
                      adapter: str = "") -> str:
    """Session or prefix key for cache-affinity routing: ``X-Session`` wins,
    else a digest of the prompt's first ``prefix_tokens`` ids. The adapter
    is mixed into both (prefix-cache chains are namespaced by adapter); no
    adapter keeps the plain keys."""
    sess = headers.get("X-Session") if headers is not None else None
    tag = f"@{adapter}" if adapter else ""
    if sess:
        return "sess-" + sess.strip() + tag
    ids = list(prompt_token_ids[:max(1, prefix_tokens)])
    return "pfx-" + hashlib.sha256((repr(ids) + tag).encode()).hexdigest()[:16]


def parse_adapter_map(spec: str) -> Dict[str, str]:
    """``"tenantA:ad1,tenantB:ad2"`` -> ``{"tenantA": "ad1", ...}``."""
    out: Dict[str, str] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, ad = part.partition(":")
        if not sep or not name.strip() or not ad.strip():
            raise ValueError(f"bad adapter mapping {part!r} (expected tenant:adapter)")
        out[name.strip()] = ad.strip()
    return out


def parse_tenant_weights(spec: str) -> Dict[str, float]:
    """``"tenantA:4,tenantB:1"`` -> ``{"tenantA": 4.0, "tenantB": 1.0}``."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            weight = float(w) if w else 1.0
        except ValueError:
            raise ValueError(f"bad tenant weight {part!r} (expected name:weight)")
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0: {part!r}")
        out[name.strip()] = weight
    return out


class AdmissionGateway:
    """Bounded, rate-limited, priority- and deadline-scheduled admission in
    front of an :class:`~dlti_tpu_torch.serving.server.AsyncEngine`."""

    def __init__(self, async_engine, cfg: GatewayConfig, registry=None):
        self.async_engine = async_engine
        self.cfg = cfg
        self._weights = parse_tenant_weights(cfg.tenant_weights)
        self._adapter_map = parse_adapter_map(cfg.adapter_map)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # Per-class, per-tenant FIFO queues and the stride scheduler's state.
        self._queues: Dict[str, Dict[str, collections.deque]] = {p: {} for p in PRIORITIES}
        self._vtime: Dict[str, float] = {}
        self._vfloor = 0.0
        self._buckets: Dict[str, _TokenBucket] = {}
        self._queued_requests = 0
        self._queued_tokens = 0
        self._inflight: List[_Pending] = []
        self._draining = False
        self._drain_t0: Optional[float] = None
        self._stop = False

        # Labelled counters are registry objects; the live gauges and the
        # fleet's failover counters ride a scalar source.
        self._m_admitted = self._m_rejected = self._m_shed = None
        if registry is not None:
            self._m_admitted = Counter(
                "dlti_gateway_admitted_total",
                help="requests admitted through the gateway",
                labelnames=("tenant", "priority"))
            self._m_rejected = Counter(
                "dlti_gateway_rejected_total",
                help="admissions refused (reason + priority labels)",
                labelnames=("reason", "priority"))
            self._m_shed = Counter(
                "dlti_gateway_shed_total",
                help="queued requests shed at deadline expiry before prefill "
                     "(priority label)",
                labelnames=("priority",))
            for metric in (self._m_admitted, self._m_rejected, self._m_shed):
                registry.register(metric)
            registry.add_scalar_source(
                self._scalars,
                gauge_keys=("gateway_queue_depth", "gateway_queued_tokens",
                            "gateway_inflight", "gateway_replicas_alive"),
                prefix="dlti_")

        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dlti-gateway-dispatch")
        self._thread.start()

    # -- observability --------------------------------------------------
    def _scalars(self) -> dict:
        eng = self.async_engine.engine
        fail = getattr(eng, "failover", None) or {}
        aff = getattr(eng, "affinity", None) or {}
        with self._lock:
            depth, toks, infl = (self._queued_requests, self._queued_tokens,
                                 len(self._inflight))
        return {
            "gateway_queue_depth": depth,
            "gateway_queued_tokens": toks,
            "gateway_inflight": infl,
            "gateway_replicas_alive": getattr(eng, "num_live", 1),
            "gateway_retries_total": fail.get("retries", 0),
            "gateway_replica_faults_total": fail.get("replica_faults", 0),
            "gateway_affinity_sticky_total": aff.get("sticky", 0),
            "gateway_affinity_spill_total": aff.get("spill", 0),
        }

    @property
    def draining(self) -> bool:
        return self._draining

    def adapter_for(self, tenant: str) -> str:
        """The tenant's mapped LoRA adapter ("" = the base model); an
        ``X-Adapter`` header overrides it."""
        return self._adapter_map.get(tenant, "")

    # -- admission ------------------------------------------------------
    def submit(self, prompt_token_ids, params: SamplingParams, request_id: str, *,
               tenant: Optional[str] = None, priority: str = "interactive",
               deadline_s: float = 0.0, affinity_key: Optional[str] = None,
               adapter: str = "") -> Tuple[GatewayRequest, queue.Queue]:
        """Admit or refuse synchronously. Returns ``(handle, event queue)``:
        ``AsyncEngine.submit``'s events, plus a terminal ``("reject",
        status, message, retry_after)`` for a shed after admission. Raises
        :class:`AdmissionError` on refusal (429 bounds or rate, 503 drain,
        404 unknown adapter, 400 bad priority)."""
        tenant = tenant or self.cfg.default_tenant
        if priority not in PRIORITIES:
            raise AdmissionError(400, f"priority must be one of {PRIORITIES}, got {priority!r}")
        if not adapter:
            adapter = self._adapter_map.get(tenant, "")
        if adapter:
            # An unknown adapter is the client's error: 404 here, before it
            # takes a queue slot.
            from dlti_tpu_torch.serving.adapters import get_catalog

            if adapter not in get_catalog():
                self._reject("unknown_adapter", priority)
                raise AdmissionError(404, f"unknown adapter {adapter!r}: register it via "
                                          f"POST /v1/adapters first")
        n_tokens = len(prompt_token_ids)
        with self._cond:
            if self._draining or self._stop:
                self._reject("draining", priority)
                # The remaining drain grace, floored at the static backoff:
                # a client that honors it lands on the replacement process.
                retry_after = self.cfg.retry_after_s
                if self._drain_t0 is not None:
                    remaining = self.cfg.drain_grace_s - (time.monotonic() - self._drain_t0)
                    retry_after = max(retry_after, remaining)
                raise AdmissionError(503, "server is draining; not accepting new requests",
                                     retry_after=retry_after)
            if self.cfg.rate_limit_rps > 0:
                burst = self.cfg.rate_limit_burst or max(1.0, 2.0 * self.cfg.rate_limit_rps)
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = _TokenBucket(burst)
                wait = bucket.take(self.cfg.rate_limit_rps, burst)
                if wait is not None:
                    self._reject("rate_limited", priority)
                    raise AdmissionError(429, f"tenant {tenant!r} over rate limit "
                                              f"({self.cfg.rate_limit_rps:g} req/s)",
                                         retry_after=wait)
            if self._queued_requests + 1 > self.cfg.max_queued_requests:
                self._reject("queue_full", priority)
                raise AdmissionError(429, f"admission queue full "
                                          f"({self.cfg.max_queued_requests} requests)",
                                     retry_after=self.cfg.retry_after_s)
            if (self.cfg.max_queued_tokens > 0
                    and self._queued_tokens + n_tokens > self.cfg.max_queued_tokens):
                self._reject("queue_full", priority)
                raise AdmissionError(429, f"admission queue full "
                                          f"({self.cfg.max_queued_tokens} queued prompt tokens)",
                                     retry_after=self.cfg.retry_after_s)

            handle = GatewayRequest(request_id, prompt_token_ids, params)
            entry = _Pending(handle=handle, q=queue.Queue(), tenant=tenant, priority=priority,
                             deadline=(time.monotonic() + deadline_s
                                       if deadline_s and deadline_s > 0 else None),
                             affinity_key=affinity_key, adapter=adapter)
            dq = self._queues[priority].setdefault(tenant, collections.deque())
            if not dq:
                # A (re)activating tenant starts at the floor, so an idle
                # spell banks no credit.
                self._vtime[tenant] = max(self._vtime.get(tenant, 0.0), self._vfloor)
            dq.append(entry)
            self._queued_requests += 1
            self._queued_tokens += n_tokens
            if self._m_admitted is not None:
                self._m_admitted.labels(tenant=tenant, priority=priority).inc()
            self._cond.notify()
        return handle, entry.q

    def _reject(self, reason: str, priority: str = "interactive") -> None:
        if self._m_rejected is not None:
            self._m_rejected.labels(reason=reason, priority=priority).inc()

    # -- scheduling -----------------------------------------------------
    def _engine_room(self) -> int:
        """Free decode slots across the live replicas, less what already
        waits in their queues and in the stepper's hand-over: dispatch keeps
        the engines' FCFS deques near empty, so ordering stays a gateway
        decision."""
        eng = self.async_engine.engine
        engines = eng.live_engines() if hasattr(eng, "live_engines") else [eng]
        room = sum(e.cfg.max_seqs - e.num_active - len(e.waiting) for e in engines)
        return room - getattr(self.async_engine, "pending_submits", 0)

    def _pop_next_locked(self) -> Optional[_Pending]:
        for prio in PRIORITIES:
            by_tenant = self._queues[prio]
            ready = [t for t, dq in by_tenant.items() if dq]
            if not ready:
                continue
            # Stride scheduling: the least virtual time wins; advancing by
            # 1/weight gives each tenant its weight's share.
            t = min(ready, key=lambda t: (self._vtime.get(t, 0.0), t))
            self._vtime[t] = self._vtime.get(t, 0.0) + 1.0 / self._weights.get(t, 1.0)
            self._vfloor = self._vtime[t]
            entry = by_tenant[t].popleft()
            self._queued_requests -= 1
            self._queued_tokens -= len(entry.handle.prompt_token_ids)
            return entry
        return None

    def _shed_expired_locked(self) -> None:
        """Queued entries past their deadline are shed before prefill (503
        to the waiting handler); in-flight ones get ``cancel_requested``, so
        the engine frees their slot within one decode window."""
        now = time.monotonic()
        for prio in PRIORITIES:
            for tenant, dq in self._queues[prio].items():
                expired = [e for e in dq if e.deadline is not None and e.deadline <= now]
                for e in expired:
                    dq.remove(e)
                    self._queued_requests -= 1
                    self._queued_tokens -= len(e.handle.prompt_token_ids)
                    if self._m_shed is not None:
                        self._m_shed.labels(priority=prio).inc()
                    e.q.put(("reject", 503, "deadline expired while queued (shed before "
                                            "prefill)", self.cfg.retry_after_s))
        alive = []
        for e in self._inflight:
            if e.handle.done:
                continue
            if e.deadline is not None and e.deadline <= now:
                e.handle.cancel_requested = True
                continue
            alive.append(e)
        self._inflight = alive

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                self._shed_expired_locked()
                entry = None
                if self._queued_requests > 0 and self._engine_room() > 0:
                    entry = self._pop_next_locked()
                if entry is None:
                    # Deadlines and slot churn are time-driven: bounded wait.
                    self._cond.wait(timeout=0.005)
                    continue
            if entry.handle.cancel_requested:
                # Cancelled while queued: never reaches the engine.
                entry.q.put(("done", "stop"))
                continue
            try:
                kw = {"affinity_key": entry.affinity_key} if entry.affinity_key else {}
                if entry.adapter:
                    kw["adapter"] = entry.adapter
                req, _ = self.async_engine.submit(
                    entry.handle.prompt_token_ids, entry.handle.params,
                    entry.handle.request_id, q=entry.q, **kw)
            except Exception as e:  # noqa: BLE001 - engine parked, every replica dead
                self._reject("engine_unavailable", entry.priority)
                entry.q.put(("reject", 503, f"{type(e).__name__}: {e}"))
                continue
            entry.handle.bind(req)
            with self._cond:
                self._inflight.append(entry)

    # -- drain / shutdown ----------------------------------------------
    def drain(self) -> None:
        """Stop admitting (new submits get 503); queued and in-flight
        requests run to completion. ``/health`` reports ``draining``."""
        with self._cond:
            self._draining = True
            if self._drain_t0 is None:
                self._drain_t0 = time.monotonic()
            self._cond.notify()
        logger.info("gateway draining: refusing new admissions")

    def wait_idle(self, timeout_s: float) -> bool:
        """Block until the queue and the in-flight list are empty and the
        engine has no work (True), or the grace lapses (False)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                idle = (self._queued_requests == 0
                        and not any(not e.handle.done for e in self._inflight))
            if idle and not self.async_engine.engine.has_work:
                return True
            time.sleep(0.01)
        return False

    def shutdown(self) -> None:
        with self._cond:
            self._stop = True
            for prio in PRIORITIES:
                for dq in self._queues[prio].values():
                    while dq:
                        dq.popleft().q.put(("error", "server shutting down"))
            self._queued_requests = 0
            self._queued_tokens = 0
            self._cond.notify()
        self._thread.join(timeout=5)
