"""OpenAI-compatible HTTP server over the continuous-batching engine or a
replica fleet: the port of ``dlti_tpu/serving/server.py``.

* ``POST /v1/completions``      — text completion, optional SSE streaming
* ``POST /v1/chat/completions`` — chat with the Llama-2 template
  (``<s>[INST] {q} [/INST] {a}</s>``, the training data's format)
* ``GET /v1/models`` · ``GET /health`` · ``GET /stats`` · ``GET /metrics``
  (Prometheus text exposition of the same counters and histograms, with
  the prefix-cache series, ``dlti_prefix_cache_hit_rate``, the five
  ``dlti_spec_*`` series and the six ``dlti_adapter_*`` series under the
  reference's names)
* ``GET /v1/adapters`` lists the registered LoRA adapters; ``POST
  /v1/adapters {"name", "directory"}`` registers one (digest-verified; a
  bad or corrupt directory answers 400 and stays unregistered). A
  completion names its adapter in the ``X-Adapter`` header; an unknown name
  answers 404 before the engine sees it.
* ``POST /v1/reload {"directory"}``: a rolling weight reload of a replica
  fleet (``serving.replicas``) from a ``save_pytree`` export, digest-checked
  before every replica's swap: 200 ``reloading`` once the export is loaded,
  409 while a reload is in flight, 400 on a single engine (no replica
  lifecycle).
* ``GET /debug/vars`` (the time-series ring, ``?tail=N``) and ``GET
  /dashboard`` (a self-contained page polling it); ``GET /debug/slow``
  (the worst requests' critical paths, ``?n=N``); ``GET /debug/trace``
  (the span ring as Chrome-trace JSON, or with ``?request_id=`` one
  request's timeline; 404 while tracing is off); ``GET /debug/memory`` (the
  engine's memory ledger; 404 when disabled or on a replica fleet);
  ``POST /debug/profile {"seconds"}``: a ``torch.profiler`` capture of the
  live server (CUDA activities on the card) into
  ``<trace_dir>/serve_profile``: 400 without a trace dir or for seconds
  outside (0, 120], 409 while a capture runs, 500 if the profiler fails.
* With ``ServerConfig.gateway`` enabled, admissions go through the
  admission gateway (``serving.gateway``): the tenant from ``X-Tenant``,
  ``priority`` and ``deadline_s`` from the body (or ``X-Priority``), the
  tenant's mapped adapter, cache-affinity keys; refusals answer 429 or 503
  with ``Retry-After``. ``/health`` answers 503 ``draining`` while it
  drains, and SIGTERM drains it for up to ``drain_grace_s`` before exit.

Requests take OpenAI's ``stop`` strings (matched on detokenized text, the
stop string never returned or streamed), ``n`` choices decoding
concurrently, ``seed``, ``logprobs`` and ``stop_token_ids``. Responses keep
the reference's JSON keys: a finished response (and a stream's final
chunk) carries the request's critical-path ``phases`` (parts summing to
``total_s``), ``migrations``, ``retries`` and ``trace_id``. Not ported
(ROADMAP.md, queue 1): ``/v1/deploy`` and ``/debug/slo``, which answer 404
and say so.

Standard library HTTP (``http.server`` + threads): the engine steps in one
background thread, which selects the engine's CUDA device before its first
step; handler threads block on per-request event queues and touch only
Python values. A fleet's requests are dispatched to a replica on that
thread too, between steps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import signal
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import torch

from dlti_tpu_torch.config import GatewayConfig, TelemetryConfig
from dlti_tpu_torch.data.tokenizer import Tokenizer
from dlti_tpu_torch.serving import adapters, lifecycle, prefix_cache
from dlti_tpu_torch.serving.engine import InferenceEngine, Request
from dlti_tpu_torch.serving.gateway import (
    PRIORITIES, AdmissionError, AdmissionGateway, affinity_key_from, tenant_from_headers,
)
from dlti_tpu_torch.serving.sampling import SamplingParams
from dlti_tpu_torch.telemetry import distributed_trace, ledger, memledger
from dlti_tpu_torch.telemetry.ledger import REQUEST_PHASES, request_breakdown
from dlti_tpu_torch.telemetry.registry import MetricsRegistry
from dlti_tpu_torch.telemetry.timeseries import TimeSeriesSampler, render_dashboard_html
from dlti_tpu_torch.telemetry.tracer import get_tracer
from dlti_tpu_torch.utils.logging import get_logger

# /stats keys exposed as Prometheus gauges; every other numeric stat is a
# counter. Names are the reference server's: dlti_<key>.
_GAUGE_KEYS = ("active_seqs", "waiting", "free_blocks")

# Routes of the reference server whose subsystems are not ported.
_NOT_PORTED_ROUTES = ("/debug/slo", "/v1/deploy")


def _not_ported(what: str) -> str:
    return f"{what} is not ported to the PyTorch server yet (see ROADMAP.md, queue 1)"


def build_registry(async_engine: "AsyncEngine") -> MetricsRegistry:
    """The backing store for ``/stats`` and ``/metrics``: the engine's stats
    dict plus its gauges as a scalar source, and its request histograms."""
    registry = MetricsRegistry()

    def _engine_scalars() -> dict:
        eng = async_engine.engine
        return {
            **eng.stats,
            "active_seqs": eng.num_active,
            "waiting": len(eng.waiting),
            "free_blocks": eng.num_free_blocks,
        }

    registry.add_scalar_source(_engine_scalars, gauge_keys=_GAUGE_KEYS,
                               prefix="dlti_")
    for hist in async_engine.engine.telemetry.histograms():
        registry.register(hist)
    # Self-monitoring: the span ring's eviction counter (a truncated trace
    # announces itself), the critical-path series and the memory ledger's
    # gauges (module-level, as in the reference: every engine in the
    # process shares them). The reference's goodput and trace-federation
    # series have no writer in the port's server process (the trainer's
    # booking and the multi-process fleet are not ported), so they are not
    # registered.
    registry.add_scalar_source(
        lambda: {"trace_dropped_events": get_tracer().dropped_events}, prefix="dlti_")
    for metric in (ledger.phase_seconds_total, ledger.phase_requests_total,
                   memledger.hbm_bytes_gauge, memledger.hbm_peak_gauge,
                   memledger.hbm_headroom_gauge, memledger.hbm_untracked_gauge):
        registry.register(metric)
    # Tiered prefix-cache telemetry (module-level, as in the reference):
    # per-tier hit/miss/eviction/promotion/demotion counters and block
    # gauges, rendered once an engine has touched them.
    for metric in (prefix_cache.hits_total, prefix_cache.misses_total,
                   prefix_cache.evictions_total, prefix_cache.promotions_total,
                   prefix_cache.demotions_total, prefix_cache.blocks_gauge):
        registry.register(metric)
    # The adapter pool's series (module-level too): loads, evictions, hits,
    # misses, and the slot and byte gauges, on a server whose engine has a
    # pool (the reference's show only once a pool has touched them).
    if async_engine.engine.adapter_pool is not None:
        for metric in adapters.METRICS:
            registry.register(metric)
    # The replica lifecycle's series (module-level, every fleet's), on a
    # fleet's server: the port's unlabelled counters render from 0, where the
    # reference's render once they move, so one engine's server shows none.
    if hasattr(async_engine.engine, "lifecycle"):
        for metric in lifecycle.METRICS:
            registry.register(metric)

    def _prefix_hit_rate() -> dict:
        # The fraction of prompt tokens served from the cache (HBM hits
        # plus lower-tier restores) over everything the engine handled.
        s = async_engine.engine.stats
        cached = s.get("prefix_cached_tokens", 0)
        restored = s.get("prefix_restored_tokens", 0)
        total = cached + restored + s.get("prefill_tokens", 0)
        return {"prefix_cache_hit_rate":
                (cached + restored) / total if total else 0.0}

    registry.add_scalar_source(_prefix_hit_rate,
                               gauge_keys=("prefix_cache_hit_rate",),
                               prefix="dlti_")

    def _spec_scalars() -> dict:
        # The speculative-decode series (engine.SPEC_METRIC_NAMES): raw
        # draft counters, the cumulative acceptance ratio and the draft
        # length of the last decode round.
        eng = async_engine.engine
        s = eng.stats
        p = s.get("spec_proposed", 0)
        return {
            "spec_proposed_total": p,
            "spec_accepted_total": s.get("spec_accepted", 0),
            "spec_paused_rounds_total": s.get("spec_paused_rounds", 0),
            "spec_acceptance_rate":
                s.get("spec_accepted", 0) / p if p else 0.0,
            "spec_draft_len": getattr(eng, "spec_draft_len", 0),
        }

    registry.add_scalar_source(
        _spec_scalars,
        gauge_keys=("spec_acceptance_rate", "spec_draft_len"),
        prefix="dlti_")
    return registry


def llama2_chat_prompt(messages: List[dict]) -> str:
    """Messages -> Llama-2 chat string (the training data's format), so
    serve-time prompts match the fine-tuning distribution."""
    system = ""
    turns: List[Tuple[str, Optional[str]]] = []  # (user, assistant?) pairs
    pending_user: Optional[str] = None
    for m in messages:
        role, content = m.get("role"), m.get("content", "")
        if role == "system":
            system = content
        elif role == "user":
            if pending_user is not None:
                turns.append((pending_user, ""))
            pending_user = content
        elif role == "assistant":
            turns.append((pending_user or "", content))
            pending_user = None
    if pending_user is not None:
        turns.append((pending_user, None))

    out = []
    first = True
    for user, assistant in turns:
        u = user
        if first and system:
            u = f"<<SYS>>\n{system}\n<</SYS>>\n\n{user}"
        first = False
        if assistant is None:
            out.append(f"[INST] {u} [/INST]")
        else:
            out.append(f"[INST] {u} [/INST] {assistant}")
    return " ".join(out)


class AsyncEngine:
    """Thread-safe facade: a single stepper thread drives the engine;
    callers get a per-request event queue for streaming. Over a replica
    fleet (an engine with ``dispatch``) a submit builds the request on the
    caller's thread and the stepper dispatches it to a replica between
    steps, so only the stepper touches the replicas' queues (a fault's
    failover rewrites them)."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        self.logger = get_logger()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: Dict[str, queue.Queue] = {}
        self._seen: Dict[str, int] = {}
        # A fleet's submissions awaiting dispatch: (request, affinity key).
        self._inbox: List[tuple] = []
        self._fleet = hasattr(engine, "dispatch")
        # make_server's time-series sampler, stopped with the stepper.
        self.sampler: Optional[TimeSeriesSampler] = None
        # Calls to run on the stepper thread between two steps:
        # (fn, result box) pairs (call_between_steps).
        self._calls: List[tuple] = []
        self._stop = False
        self._dead = False  # set when even fault recovery failed
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dlti-engine-stepper")
        self._thread.start()

    @property
    def dead(self) -> bool:
        """True once even fault recovery failed and the stepper parked
        (every later submit raises; ``/health`` reports 503)."""
        return self._dead

    @property
    def pending_submits(self) -> int:
        """A fleet's submissions not yet dispatched to a replica."""
        return len(self._inbox)

    def submit(self, prompt_ids: List[int], params: SamplingParams,
               request_id: Optional[str] = None,
               q: Optional[queue.Queue] = None,
               affinity_key: Optional[str] = None,
               adapter: str = "", trace_id: str = "") -> Tuple[Request, queue.Queue]:
        """Enqueue a request (under LoRA ``adapter``, "" = the base model);
        returns (request, event queue). ``q``: a queue the caller made (the
        gateway hands it to the handler before dispatch); ``affinity_key``:
        a fleet's sticky-replica key (ignored by one engine); ``trace_id``:
        the gateway's trace context ("" mints one).

        Queue events: ``("token", token_id, logprob)`` per generated token,
        then ``("done", finish_reason)`` — or ``("error", message)``.
        """
        q = q if q is not None else queue.Queue()
        with self._work:
            if self._dead:
                raise RuntimeError("engine is down (unrecoverable step fault)")
            if self._fleet:
                if self.engine.num_live == 0:
                    raise RuntimeError("all replicas dead (step faults); engine cannot "
                                       "accept requests")
                req = self.engine.new_request(prompt_ids, params, request_id, adapter=adapter,
                                              trace_id=trace_id)
                self._inbox.append((req, affinity_key))
            else:
                req = self.engine.submit(prompt_ids, params, request_id, adapter=adapter,
                                         trace_id=trace_id)
            self._queues[req.request_id] = q
            self._seen[req.request_id] = 0
            self._work.notify()
        return req, q

    def call_between_steps(self, fn, timeout: float = 600.0):
        """Run ``fn()`` on the stepper thread between two engine steps and
        return its result (raising what it raised): how the profiler starts
        and stops on the thread that issues every device call, never beside
        a graph replay on another thread. Raises ``RuntimeError`` once the
        stepper is down."""
        box = {"done": threading.Event()}
        with self._work:
            if self._dead or self._stop:
                raise RuntimeError("engine is down (stepper stopped)")
            self._calls.append((fn, box))
            self._work.notify()
        if not box["done"].wait(timeout):
            raise TimeoutError(f"the stepper did not run the call in {timeout:g} s")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _run_calls(self, calls: List[tuple]) -> None:
        for fn, box in calls:
            try:
                box["result"] = fn()
            except Exception as e:  # noqa: BLE001 - handed to the caller
                box["error"] = e
            box["done"].set()

    def _fail_calls(self) -> None:
        """(Under the lock.) The stepper is leaving: refuse pending calls."""
        for _, box in self._calls:
            box["error"] = RuntimeError("engine is down (stepper stopped)")
            box["done"].set()
        self._calls.clear()

    def _dispatch_inbox(self) -> None:
        """Hand the fleet's pending submissions to replicas (the stepper's
        side, under the lock). A request no replica can take gets its error
        event."""
        for req, key in self._inbox:
            try:
                self.engine.dispatch(req, key)
            except Exception as e:  # noqa: BLE001 - every replica dead
                q = self._queues.pop(req.request_id, None)
                self._seen.pop(req.request_id, None)
                if q is not None:
                    q.put(("error", f"{type(e).__name__}: {e}"))
        self._inbox.clear()

    def shutdown(self) -> None:
        """Stop the server's time-series sampler and the stepper, then
        release a tensor-parallel engine's followers (they leave their loop
        once the stepper's last call is theirs too)."""
        if self.sampler is not None:
            self.sampler.stop()
        with self._work:
            self._stop = True
            self._work.notify()
        self._thread.join(timeout=10)
        stop = getattr(self.engine, "stop_followers", None)
        if stop is not None:
            stop()

    def _run(self) -> None:
        try:
            device = getattr(self.engine, "device", None)
            if device is not None and device.type == "cuda":
                # CUDA's current device is per thread: the kernels launch on it.
                torch.cuda.set_device(device.index if device.index is not None
                                      else torch.cuda.current_device())
        except Exception as e:
            # A stepper that cannot select the card can never step: park it,
            # so /health answers 503 and submits fail at once.
            self.logger.exception("stepper could not select the engine's "
                                  "device; stepper parked")
            with self._work:
                self._dead = True
                self._stop = True
                for q in self._queues.values():
                    q.put(("error", f"{type(e).__name__}: {e}"))
                self._queues.clear()
                self._seen.clear()
                self._fail_calls()
            return
        while True:
            with self._work:
                while (not self._stop and not self.engine.has_work and not self._inbox
                       and not self._calls):
                    if getattr(self.engine, "lifecycle_pending", False):
                        # A quarantined replica awaits its probe or a reload
                        # is rolling: poll, so the fleet's lifecycle tick
                        # runs on an idle server too (a step without work is
                        # just the tick).
                        self._work.wait(timeout=0.05)
                        break
                    self._work.wait()
                if self._stop:
                    for q in self._queues.values():
                        q.put(("error", "server shutting down"))
                    self._fail_calls()
                    return
                self._dispatch_inbox()
                calls, self._calls = self._calls, []
            self._run_calls(calls)
            # Step outside the lock: a concurrent submit only appends to the
            # engine's waiting deque, which admission reads at one point
            # inside step(), so a racing submit lands this step or the next.
            try:
                self.engine.step()
            except Exception as e:  # surface engine faults to the waiters
                self.logger.exception("engine step failed")
                with self._work:
                    # Fail fast: abort every request the engine holds and
                    # error every registered consumer; the engine ends
                    # empty, so a persistent fault is not retried forever.
                    try:
                        self.engine.abort_all(reason="error")
                    except Exception:
                        # Bookkeeping is beyond recovery: park the stepper
                        # and fail every later submit.
                        self.logger.exception("engine abort failed; stepper parked")
                        self._dead = True
                        self._stop = True
                    for q in self._queues.values():
                        q.put(("error", f"{type(e).__name__}: {e}"))
                    self._queues.clear()
                    self._seen.clear()
                    if self._stop:
                        self._fail_calls()
                        return
                continue
            with self._work:
                self._drain_events()

    def _drain_events(self) -> None:
        """Push tokens generated since the last step to per-request queues."""
        reqs = [s.request for s in self.engine.slots if s.request is not None]
        reqs.extend(r for r in list(self.engine.finished)
                    if r.request_id in self._queues)
        for req in reqs:
            q = self._queues.get(req.request_id)
            if q is None:
                continue
            seen = self._seen.get(req.request_id, 0)
            for i in range(seen, len(req.output_token_ids)):
                q.put(("token", req.output_token_ids[i], req.output_logprobs[i]))
            self._seen[req.request_id] = len(req.output_token_ids)
            if req.done:
                if req.finish_reason == "error":
                    # Failover ran out of retries or survivors (or the
                    # request's adapter failed at admission): this request
                    # failed, the engine serves on.
                    q.put(("error", "request failed: replica fault, retries exhausted"))
                else:
                    q.put(("done", req.finish_reason))
                del self._queues[req.request_id]
                del self._seen[req.request_id]


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    model_name: str = "dlti-tpu-model"
    request_timeout_s: float = 600.0
    default_params: SamplingParams = field(default_factory=SamplingParams)
    # Admission gateway (serving.gateway): None or disabled admits directly
    # into the engine.
    gateway: Optional[GatewayConfig] = None
    # trace_dir receives POST /debug/profile's captures (None or "":
    # profiling answers 400). The /debug/vars sampler is always on.
    telemetry: Optional[TelemetryConfig] = None


class _Handler(BaseHTTPRequestHandler):
    """One instance per connection (ThreadingHTTPServer)."""

    server_version = "dlti-tpu"
    protocol_version = "HTTP/1.1"

    # Bound per server by make_server's subclass.
    async_engine: AsyncEngine
    tokenizer: Tokenizer
    cfg: ServerConfig
    registry: MetricsRegistry
    gateway: Optional[AdmissionGateway] = None
    sampler: Optional[TimeSeriesSampler] = None  # behind /debug/vars and /dashboard
    profile_lock: Optional[threading.Lock] = None  # one POST /debug/profile at a time

    def log_message(self, fmt, *args):  # route through our logger
        get_logger().debug("http: " + fmt, *args)

    # -- helpers -------------------------------------------------------
    def _json(self, code: int, obj: dict, headers: Optional[dict] = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str, retry_after: Optional[float] = None) -> None:
        headers = None
        if retry_after is not None:
            # Whole seconds (RFC 9110), never 0: a 429 that says "now"
            # invites the same overload back at once.
            headers = {"Retry-After": str(max(1, int(-(-retry_after // 1))))}
        err_type = ("rate_limit_error" if code == 429
                    else "overloaded_error" if code == 503
                    else "invalid_request_error")
        self._json(code, {"error": {"message": message, "type": err_type}}, headers=headers)

    def _read_body(self) -> Optional[dict]:
        try:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._error(400, "invalid JSON body")
            return None

    class _StopMatcher:
        """Stateful windowed stop-string scanner shared by the stream and
        non-stream paths: feed(text) -> (cut, safe), with the scan window
        advanced past text already scanned."""

        def __init__(self, stops: tuple):
            self.stops = stops
            self._max = max((len(s) for s in stops), default=0)
            self._prev = 0

        def feed(self, text: str) -> tuple:
            cut, safe = _Handler._scan_stops(
                text, self.stops, start=self._prev - self._max + 1)
            self._prev = len(text)
            return cut, safe

    @staticmethod
    def _scan_stops(text: str, stops: tuple, start: int = 0) -> tuple:
        """(cut, safe): ``cut`` is the index of the earliest stop-string
        match (None if absent); ``safe`` is how much of ``text`` may be
        emitted now — a tail that could begin a stop string arriving across
        token boundaries is held back, since the OpenAI contract excludes
        the stop string from the returned text. ``start`` windows the
        search so per-token scanning stays linear in the output length."""
        cut = None
        for s in stops:
            i = text.find(s, max(0, start))
            if i != -1 and (cut is None or i < cut):
                cut = i
        if cut is not None:
            return cut, cut
        hold = 0
        for s in stops:
            for k in range(1, len(s)):
                if text.endswith(s[:k]):
                    hold = max(hold, k)
        return None, len(text) - hold

    @staticmethod
    def _stops_from(body: dict) -> tuple:
        """OpenAI ``stop``: a string or list of strings (<= 4)."""
        stop = body.get("stop")
        if stop is None:
            return ()
        if isinstance(stop, str):
            stop = [stop]
        if (not isinstance(stop, list) or len(stop) > 4
                or not all(isinstance(s, str) and s for s in stop)):
            raise ValueError(
                "stop must be a non-empty string or a list of up to 4")
        return tuple(stop)

    def _params_from(self, body: dict) -> SamplingParams:
        # Every client-supplied field is cast here, before the request
        # reaches the stepper thread: a malformed value fails this one
        # request with a 400, not every in-flight one.
        d = self.cfg.default_params
        stop_ids = tuple(int(t) for t in body.get("stop_token_ids", ()))
        seed = body.get("seed")
        return SamplingParams(
            temperature=float(body.get("temperature", d.temperature)),
            top_k=int(body.get("top_k", d.top_k)),
            top_p=float(body.get("top_p", d.top_p)),
            max_tokens=int(body.get("max_tokens", d.max_tokens)),
            stop_token_ids=stop_ids,
            seed=int(seed) if seed is not None else None,
            logprobs=bool(body.get("logprobs", False)),
        )

    # -- routes --------------------------------------------------------
    def do_GET(self):
        path, _, query = self.path.partition("?")
        if path == "/debug/vars":
            # The time-series ring (every registry scalar and histogram
            # summary, sampled on a cadence): what /dashboard polls.
            if self.sampler is None:
                return self._error(404, "no time-series sampler")
            tail = None
            if query.startswith("tail="):
                try:
                    tail = max(1, int(query[5:]))
                except ValueError:
                    return self._error(400, "tail must be an integer")
            return self._json(200, self.sampler.snapshot(tail))
        if path == "/debug/slow":
            # The K worst requests with their critical-path timelines.
            cp = self.async_engine.engine.telemetry.critical_path
            n = None
            if query.startswith("n="):
                try:
                    n = max(1, int(query[2:]))
                except ValueError:
                    return self._error(400, "n must be an integer")
            return self._json(200, {"k": cp.slow.k, "retained": len(cp.slow),
                                    "phases": list(REQUEST_PHASES),
                                    "worst": cp.slow.worst(n)})
        if path == "/debug/trace":
            return self._trace(query)
        if path == "/debug/memory":
            # The memory ledger's map: owners, untracked and residual
            # summing to bytes in use, the top untracked tensors.
            led = getattr(self.async_engine.engine, "memledger", None)
            if led is None or not led.enabled:
                return self._error(404, "memory ledger disabled")
            return self._json(200, led.to_dict(top_k=8))
        if path == "/dashboard":
            # A self-contained page polling /debug/vars.
            body = render_dashboard_html().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path in _NOT_PORTED_ROUTES:
            self._error(404, _not_ported(path))
        elif self.path == "/health":
            # A parked stepper or a draining gateway must read unhealthy, so
            # a balancer routes elsewhere instead of sending requests that
            # 503. A fleet adds its replicas' lifecycle counts.
            counts = getattr(self.async_engine.engine, "lifecycle_counts", None)
            body = counts() if counts is not None else {}
            if self.async_engine.dead:
                self._json(503, {"status": "dead", **body})
            elif self.gateway is not None and self.gateway.draining:
                self._json(503, {"status": "draining", **body})
            else:
                self._json(200, {"status": "ok", **body})
        elif self.path == "/stats":
            self._json(200, self.registry.stats_dict())
        elif self.path == "/metrics":
            body = self.registry.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [{
                "id": self.cfg.model_name, "object": "model",
                "owned_by": "dlti_tpu",
            }]})
        elif self.path == "/v1/adapters":
            # What a client may put in X-Adapter right now.
            self._json(200, {"object": "list", "data": adapters.get_catalog().names()})
        else:
            self._error(404, f"no route {self.path}")

    def do_POST(self):
        if self.path == "/v1/completions":
            self._completions(chat=False)
        elif self.path == "/v1/chat/completions":
            self._completions(chat=True)
        elif self.path == "/v1/adapters":
            self._register_adapter()
        elif self.path == "/v1/reload":
            self._reload_weights()
        elif self.path == "/debug/profile":
            self._profile()
        elif self.path in _NOT_PORTED_ROUTES:
            self._error(404, _not_ported(self.path))
        else:
            self._error(404, f"no route {self.path}")

    def _trace(self, query: str) -> None:
        """``GET /debug/trace``: the span ring as Chrome-trace JSON; with
        ``?request_id=`` (and ``&latency_s=``, the client's latency) one
        request's spans, legs and residual (``request_timeline``)."""
        tracer = get_tracer()
        if not tracer.enabled:
            return self._error(404, "tracing disabled (start the server with --trace-dir)")
        qp = {}
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if k:
                qp[k] = v
        rid = qp.get("request_id", "")
        if not rid:
            return self._json(200, tracer.to_dict())
        latency = None
        if qp.get("latency_s"):
            try:
                latency = float(qp["latency_s"])
            except ValueError:
                return self._error(400, "latency_s must be a float")
        tl = distributed_trace.request_timeline(tracer.events(), rid,
                                                client_latency_s=latency)
        if not tl["spans"]:
            return self._error(404, f"no spans retained for request {rid!r} (ring "
                                    f"evicted, or id unknown)")
        self._json(200, tl)

    def _profile(self) -> None:
        """``POST /debug/profile {"seconds": s}``: a ``torch.profiler``
        capture of the live server (the card's kernels and the runtime calls
        that launched them where a card is up, else the host's operators)
        for ``s`` seconds, its Chrome
        trace written into ``<trace_dir>/serve_profile``. The capture starts
        and stops on the stepper thread between two engine steps
        (:meth:`AsyncEngine.call_between_steps`): stopping it from this
        thread while the stepper replays a decode graph can deadlock the
        two. One capture at a time: the profiler is process-global, so a
        concurrent request gets 409."""
        body = self._read_body()
        if body is None:
            return
        trace_dir = self.cfg.telemetry.trace_dir if self.cfg.telemetry is not None else ""
        if not trace_dir:
            return self._error(400, "profiling needs a trace dir: start the server with "
                                    "--trace-dir")
        try:
            seconds = float(body.get("seconds", 3.0))
        except (TypeError, ValueError):
            return self._error(400, "seconds must be a number")
        if not 0.0 < seconds <= 120.0:
            return self._error(400, "seconds must be in (0, 120]")
        if self.profile_lock is None or not self.profile_lock.acquire(blocking=False):
            return self._error(409, "a profile capture is already running")
        try:
            from torch.profiler import ProfilerActivity, profile

            out_dir = os.path.join(trace_dir, "serve_profile")
            os.makedirs(out_dir, exist_ok=True)
            # A device trace on the card: recording every host operator of a
            # busy server's prefills would cost the capture seconds.
            activities = [ProfilerActivity.CUDA if torch.cuda.is_available()
                          else ProfilerActivity.CPU]
            prof = profile(activities=activities)
            t0 = time.monotonic()
            self.async_engine.call_between_steps(prof.start)
            try:
                time.sleep(seconds)
            finally:
                self.async_engine.call_between_steps(prof.stop)
            wall = time.monotonic() - t0
            path = os.path.join(out_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
            prof.export_chrome_trace(path)
            self._json(200, {"status": "ok", "trace_dir": out_dir, "trace": path,
                             "seconds": round(wall, 3)})
        except Exception as e:  # noqa: BLE001 - the profiler failed this request
            self._error(500, f"profiler: {type(e).__name__}: {e}")
        finally:
            self.profile_lock.release()

    def _register_adapter(self) -> None:
        """``POST /v1/adapters {"name", "directory"}``: register an adapter
        checkpoint without a restart. The directory is digest-verified
        before the name exists; a corrupt one is quarantined, and either
        failure answers 400 with the name still unknown."""
        body = self._read_body()
        if body is None:
            return
        name = str(body.get("name", "") or "")
        directory = str(body.get("directory", "") or "")
        if not name or not directory:
            return self._error(400, "name and directory are required")
        try:
            adapters.register_adapter(name, directory)
        except adapters.AdapterError as e:
            return self._error(400, str(e))
        self._json(200, {"object": "adapter", "name": name, "directory": directory})

    def _reload_weights(self) -> None:
        """``POST /v1/reload {"directory"}``: a rolling weight reload of a
        replica fleet from a ``checkpoint.store.save_pytree`` export (drain
        by live migration, rebuild, canary, reinstate, one replica at a
        time; no request errors, but each swap stalls the stepper). The
        export loads digest-verified on this request's thread while the
        fleet serves; its manifest digest is pinned now and the export
        re-verified before every replica's swap, so bytes that change
        mid-roll abort the rest. 409 while a reload loads or rolls; 400 on
        a single engine, which restarts instead."""
        body = self._read_body()
        if body is None:
            return
        directory = str(body.get("directory", "") or "")
        if not directory:
            return self._error(400, "directory is required")
        if not os.path.isfile(os.path.join(directory, "MANIFEST.json")):
            return self._error(400, f"{directory!r} is not a checkpoint-store params "
                                    f"export (no MANIFEST.json)")
        request_reload = getattr(self.async_engine.engine, "request_reload", None)
        if request_reload is None:
            return self._error(400, "engine has no replica lifecycle (rolling reload "
                                    "needs a replicated fleet; restart single-engine "
                                    "servers instead)")
        from dlti_tpu_torch.checkpoint.store import (
            load_pytree, manifest_digest, verify_pytree_dir,
        )
        from dlti_tpu_torch.models.interop import params_from_jax

        def provider():
            return params_from_jax(load_pytree(directory, verify=True))

        expect_digest = manifest_digest(directory)

        def verify() -> bool:
            if manifest_digest(directory) != expect_digest:
                return False
            return verify_pytree_dir(directory)[0]

        if not request_reload(provider, verify=verify):
            return self._error(409, "a rolling reload is already in progress")
        with self.async_engine._work:
            self.async_engine._work.notify()  # wake an idle stepper
        self._json(200, {"status": "reloading", "directory": directory})

    # -- completion core ----------------------------------------------
    def _completions(self, chat: bool) -> None:
        body = self._read_body()
        if body is None:
            return
        tok = self.tokenizer
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                return self._error(400, "messages must be a non-empty list")
            prompt = llama2_chat_prompt(messages)
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            if not isinstance(prompt, str) or not prompt:
                return self._error(400, "prompt must be a non-empty string")

        prompt_ids = tok.encode(prompt, add_bos=True)
        try:
            params = self._params_from(body)
            stops = self._stops_from(body)
        except (TypeError, ValueError) as e:
            return self._error(400, f"invalid sampling parameter: {e}")
        max_len = self.async_engine.engine.cfg.max_model_len
        if len(prompt_ids) >= max_len:
            return self._error(400, f"prompt has {len(prompt_ids)} tokens; "
                                    f"max_model_len is {max_len}")

        try:
            n = int(body.get("n", 1))
        except (TypeError, ValueError):
            return self._error(400, "n must be an integer")
        if not 1 <= n <= self.async_engine.engine.cfg.max_seqs:
            return self._error(
                400, f"n must be in [1, {self.async_engine.engine.cfg.max_seqs}]")
        if n > 1 and body.get("stream"):
            return self._error(400, "n > 1 does not support stream=true")
        if n > 1 and (params.temperature == 0.0 or params.top_k == 1):
            return self._error(
                400, "n > 1 with deterministic sampling (temperature=0 or "
                     "top_k=1) would return n identical choices; relax the "
                     "sampling or drop n")
        # The X-Adapter header first (with or without a gateway), else the
        # gateway's tenant map. Unknown names answer 404 here, before any
        # queue or slot is taken: the engine only sees registered adapters.
        adapter = str(self.headers.get("X-Adapter", "") or "").strip()
        if adapter and adapter not in adapters.get_catalog():
            return self._error(404, f"unknown adapter {adapter!r}: register it via "
                                    "POST /v1/adapters first")

        # Admission metadata (gateway only), checked before submit so a bad
        # value answers 400 for this request alone.
        tenant = priority = None
        deadline_s = 0.0
        affinity_key = None
        gw = self.gateway
        if gw is not None:
            tenant = tenant_from_headers(self.headers, gw.cfg.default_tenant)
            priority = str(body.get("priority") or self.headers.get("X-Priority")
                           or "interactive")
            if priority not in PRIORITIES:
                return self._error(400, f"priority must be one of {PRIORITIES}")
            try:
                deadline_s = float(body.get("deadline_s", 0) or 0)
            except (TypeError, ValueError):
                return self._error(400, "deadline_s must be a number")
            if not adapter:
                adapter = gw.adapter_for(tenant)
            if gw.cfg.affinity:
                # The adapter is part of the key: one adapter's warm KV is of
                # no use to another.
                affinity_key = affinity_key_from(self.headers, prompt_ids,
                                                 gw.cfg.affinity_prefix_tokens,
                                                 adapter=adapter)

        def submit(p_ids, p, rid_):
            if gw is not None:
                return gw.submit(p_ids, p, rid_, tenant=tenant, priority=priority,
                                 deadline_s=deadline_s, affinity_key=affinity_key,
                                 adapter=adapter)
            return self.async_engine.submit(p_ids, p, rid_,
                                            **({"adapter": adapter} if adapter else {}))

        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        created = int(time.time())
        try:
            if n == 1:
                req, q = submit(prompt_ids, params, rid)
            else:
                # n choices = n engine requests decoding concurrently; a user
                # seed derives per-choice seeds so the response reproduces
                # without n identical samples.
                subs = []
                try:
                    for i in range(n):
                        p_i = params if params.seed is None else \
                            dataclasses.replace(params, seed=params.seed + i)
                        subs.append(submit(prompt_ids, p_i, f"{rid}-{i}"))
                except Exception:
                    # A submit failed mid-loop: cancel the choices already
                    # submitted, or they decode into queues nobody reads.
                    for other, _ in subs:
                        other.cancel_requested = True
                    raise
        except AdmissionError as e:  # gateway refusal: 429/503 + Retry-After
            return self._error(e.status, e.message, retry_after=e.retry_after)
        except ValueError as e:
            return self._error(400, str(e))
        except RuntimeError as e:  # engine parked after an unrecoverable fault
            return self._error(503, str(e))

        if body.get("stream"):
            self._stream_response(req, q, chat, created, stops)
        elif n == 1:
            self._full_response(req, q, chat, created, stops)
        else:
            self._multi_response(subs, rid, chat, created, stops)

    def _collect(self, q: queue.Queue, req: Optional[Request] = None):
        """Yield events until done/error/timeout. On timeout the request is
        cancelled first, so it stops taking a slot."""
        deadline = time.monotonic() + self.cfg.request_timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if req is not None:
                    req.cancel_requested = True
                yield ("error", "request timed out")
                return
            try:
                ev = q.get(timeout=min(remaining, 1.0))
            except queue.Empty:
                continue
            yield ev
            if ev[0] in ("done", "error", "reject"):
                return

    def _collect_choice(self, req: Request, q: queue.Queue,
                        stops: tuple) -> tuple:
        """Drain one non-streaming request: returns ((token_ids, logprobs,
        text, finish), None) or (None, (status, error_message)). A stop
        string match cancels the request early and keeps draining until the
        engine's done event, so the slot release is observed."""
        token_ids: List[int] = []
        logprobs: List[float] = []
        finish = "stop"
        cut = None
        matcher = self._StopMatcher(stops)
        for ev in self._collect(q, req):
            if ev[0] == "token":
                token_ids.append(ev[1])
                logprobs.append(ev[2])
                if stops and cut is None:
                    cut, _ = matcher.feed(self.tokenizer.decode(token_ids))
                    if cut is not None:
                        req.cancel_requested = True
            elif ev[0] == "done":
                finish = ev[1]
            elif ev[0] == "reject":  # a gateway shed after admission
                return None, tuple(ev[1:])
            else:
                return None, (500, ev[1])
        text = self.tokenizer.decode(token_ids)
        if cut is not None:
            text, finish = text[:cut], "stop"
        return (token_ids, logprobs, text, finish), None

    def _choice(self, i: int, chat: bool, text: str, finish: str,
                req: Request, token_ids: List[int], logprobs: List[float]) -> dict:
        if chat:
            choice = {"index": i, "message": {"role": "assistant", "content": text},
                      "finish_reason": finish}
        else:
            choice = {"index": i, "text": text, "finish_reason": finish}
        if req.params.logprobs:
            choice["logprobs"] = {"token_logprobs": logprobs, "tokens": token_ids}
        return choice

    def _full_response(self, req: Request, q: queue.Queue, chat: bool,
                       created: int, stops: tuple = ()) -> None:
        got, err = self._collect_choice(req, q, stops)
        if err is not None:
            return self._error(*err)
        token_ids, logprobs, text, finish = got
        n_prompt = len(req.prompt_token_ids)
        self._json(200, {
            "id": req.request_id,
            "object": "chat.completion" if chat else "text_completion",
            "created": created, "model": self.cfg.model_name,
            "choices": [self._choice(0, chat, text, finish, req, token_ids,
                                     logprobs)],
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": len(token_ids),
                      "total_tokens": n_prompt + len(token_ids)},
            **self._lifecycle_keys(req),
        })

    @staticmethod
    def _phases_of(req) -> Optional[dict]:
        """The finished request's critical-path breakdown, ``{"total_s",
        "ttft_s", <phase>: s, ...}``; None while it is unfinished."""
        eng_req = getattr(req, "_req", None) or req
        if getattr(eng_req, "finish_time", None) is None:
            return None
        try:
            b = request_breakdown(eng_req)
        except Exception:  # noqa: BLE001 - attribution never fails a response
            return None
        return {"total_s": b["total_s"], "ttft_s": b["ttft_s"], **b["phases"]}

    @classmethod
    def _lifecycle_keys(cls, req) -> dict:
        """The request's critical-path ``phases`` (when finished), how often
        it was live-migrated and failed over, and its ``trace_id`` (a
        gateway handle reads its engine request's)."""
        eng_req = getattr(req, "_req", None) or req
        phases = cls._phases_of(req)
        return {**({"phases": phases} if phases is not None else {}),
                "migrations": getattr(eng_req, "num_migrations", 0),
                "retries": getattr(eng_req, "num_retries", 0),
                "trace_id": getattr(eng_req, "trace_id", "")}

    def _multi_response(self, subs: list, rid: str, chat: bool,
                        created: int, stops: tuple = ()) -> None:
        """OpenAI ``n`` > 1: the n requests decode concurrently (submitted
        before this runs); collect each in turn."""
        choices = []
        total_completion = 0
        prompt_tokens = len(subs[0][0].prompt_token_ids)
        for i, (req, q) in enumerate(subs):
            got, err = self._collect_choice(req, q, stops)
            if err is not None:
                # Cancel the other choices before erroring.
                for other, _ in subs:
                    other.cancel_requested = True
                return self._error(*err)
            token_ids, logprobs, text, finish = got
            total_completion += len(token_ids)
            choices.append(self._choice(i, chat, text, finish, req, token_ids,
                                        logprobs))
        self._json(200, {
            "id": rid,
            "object": "chat.completion" if chat else "text_completion",
            "created": created, "model": self.cfg.model_name,
            "choices": choices,
            "usage": {"prompt_tokens": prompt_tokens,
                      "completion_tokens": total_completion,
                      "total_tokens": prompt_tokens + total_completion},
        })

    def _stream_response(self, req: Request, q: queue.Queue, chat: bool,
                         created: int, stops: tuple = ()) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(data: str) -> None:
            payload = f"data: {data}\n\n".encode()
            self.wfile.write(f"{len(payload):x}\r\n".encode() + payload + b"\r\n")
            self.wfile.flush()

        obj = "chat.completion.chunk" if chat else "text_completion"
        key = "delta" if chat else "text"

        def delta_chunk(delta: str) -> None:
            val = {"content": delta} if chat else delta
            chunk(json.dumps({
                "id": req.request_id, "object": obj, "created": created,
                "model": self.cfg.model_name,
                "choices": [{"index": 0, key: val, "finish_reason": None}]}))

        # Incremental detokenization: decode the whole id list and emit the
        # new suffix, so a multi-byte character never splits.
        token_ids: List[int] = []
        emitted = ""
        finish = None
        try:
            if chat:
                chunk(json.dumps({
                    "id": req.request_id, "object": obj, "created": created,
                    "model": self.cfg.model_name,
                    "choices": [{"index": 0, "delta": {"role": "assistant"},
                                 "finish_reason": None}]}))
            cancelled = False
            matcher = self._StopMatcher(stops)
            for ev in self._collect(q, req):
                if ev[0] == "token":
                    if cancelled:
                        # Stop already matched: drain until the engine
                        # finishes, so the final usage reads a settled request.
                        continue
                    token_ids.append(ev[1])
                    text = self.tokenizer.decode(token_ids)
                    if stops:
                        # Emit only up to the earliest match, and hold back
                        # a tail that could start a match.
                        cut, safe = matcher.feed(text)
                        if cut is not None:
                            delta = text[len(emitted):cut]
                            emitted += delta
                            if delta:
                                delta_chunk(delta)
                            req.cancel_requested = True
                            cancelled = True
                            continue
                        text = text[:safe]
                    delta = text[len(emitted):]
                    emitted += delta
                    if delta:  # empty: partial unicode or a held-back prefix
                        delta_chunk(delta)
                elif ev[0] == "done":
                    finish = "stop" if cancelled else ev[1]
                    if stops and not cancelled:
                        # No stop matched: the held-back tail is real output.
                        tail = self.tokenizer.decode(token_ids)[len(emitted):]
                        if tail:
                            emitted += tail
                            delta_chunk(tail)
                else:
                    # ("error", msg) or a gateway ("reject", status, msg,
                    # ...): headers are already on the wire, so the failure
                    # arrives as a terminal SSE error frame.
                    chunk(json.dumps({"error": {
                        "message": ev[2] if ev[0] == "reject" else ev[-1]}}))
                    break
            if finish is not None:
                n_prompt, n_out = len(req.prompt_token_ids), len(req.output_token_ids)
                chunk(json.dumps({
                    "id": req.request_id, "object": obj, "created": created,
                    "model": self.cfg.model_name,
                    "choices": [{"index": 0, key: {} if chat else "",
                                 "finish_reason": finish}],
                    # Token-accurate usage in the final chunk: SSE event
                    # count is not the token count.
                    "usage": {"prompt_tokens": n_prompt,
                              "completion_tokens": n_out,
                              "total_tokens": n_prompt + n_out},
                    **self._lifecycle_keys(req)}))
            chunk("[DONE]")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # Cancel the orphaned request so it stops taking a slot.
            req.cancel_requested = True
            get_logger().info("client disconnected mid-stream: %s", req.request_id)


class _HTTPServer(ThreadingHTTPServer):
    """The server's socket: a listen queue a burst of clients fits in.
    socketserver's default of 5 refuses the connections past it while the
    accepting thread waits for the interpreter, and each refused client
    waits out TCP's 1 s retransmission before its request reaches the
    engine: time no request's critical path can see."""

    daemon_threads = True
    request_queue_size = 128


def make_server(engine: InferenceEngine, tokenizer: Tokenizer,
                cfg: Optional[ServerConfig] = None,
                ) -> Tuple[ThreadingHTTPServer, AsyncEngine]:
    """Build (but do not start) the HTTP server and start the engine's
    stepper; the caller runs ``serve_forever()``. With ``cfg.port`` 0 the
    system picks a free port: ``httpd.server_address[1]``. With
    ``cfg.gateway`` enabled an :class:`~dlti_tpu_torch.serving.gateway.
    AdmissionGateway` stands between the handlers and the engine
    (``httpd.gateway``; None otherwise). ``engine``: an
    :class:`InferenceEngine` or a :class:`~dlti_tpu_torch.serving.replicas.
    ReplicatedEngine`."""
    cfg = cfg or ServerConfig()
    async_engine = AsyncEngine(engine)
    registry = build_registry(async_engine)
    # This process's row in a Perfetto export.
    get_tracer().process_label = "server"
    gateway = None
    if cfg.gateway is not None and cfg.gateway.enabled:
        gateway = AdmissionGateway(async_engine, cfg.gateway, registry)
    # The time-series ring behind /debug/vars and /dashboard: always on,
    # one registry read (and a ledger snapshot) a second; stopped with the
    # stepper (AsyncEngine.shutdown).
    sampler = TimeSeriesSampler(interval_s=1.0, registry=registry)
    led = getattr(engine, "memledger", None)
    if led is not None and led.enabled:
        sampler.add_source(led.scalars)
    async_engine.sampler = sampler
    sampler.start()
    handler = type("BoundHandler", (_Handler,), {
        "async_engine": async_engine, "tokenizer": tokenizer, "cfg": cfg,
        "registry": registry, "gateway": gateway, "sampler": sampler,
        "profile_lock": threading.Lock(),
    })
    try:
        httpd = _HTTPServer((cfg.host, cfg.port), handler)
    except OSError:
        if gateway is not None:
            gateway.shutdown()
        async_engine.shutdown()
        raise
    httpd.gateway = gateway
    httpd.sampler = sampler
    return httpd, async_engine


def serve(engine: InferenceEngine, tokenizer: Tokenizer,
          cfg: Optional[ServerConfig] = None) -> None:
    """Blocking entry point (``dlti_tpu_torch.cli.serve``). SIGTERM, like
    Ctrl-C, stops the server cleanly: the stepper is shut down and the
    socket closed, and the call returns. With a gateway SIGTERM first
    drains: new admissions get 503, ``/health`` reads ``draining``, and
    queued and in-flight requests finish for up to ``drain_grace_s``."""
    cfg = cfg or ServerConfig()
    httpd, async_engine = make_server(engine, tokenizer, cfg)
    gateway = httpd.gateway
    host, port = httpd.server_address[:2]
    get_logger().info("serving on http://%s:%d (model=%s)", host, port,
                      cfg.model_name)

    def _graceful_stop():
        if gateway is not None:
            gateway.drain()
            gateway.wait_idle(gateway.cfg.drain_grace_s)
        httpd.shutdown()

    def _on_term(signum, frame):
        # httpd.shutdown() joins serve_forever, so it runs off this thread.
        threading.Thread(target=_graceful_stop, daemon=True).start()

    prev_handler = None
    installed = False
    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_term)
        installed = True
    except ValueError:
        pass  # not the main thread (embedded use): SIGTERM stays default
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if installed:
            signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)
        if gateway is not None:
            gateway.shutdown()
        async_engine.shutdown()
        httpd.server_close()
