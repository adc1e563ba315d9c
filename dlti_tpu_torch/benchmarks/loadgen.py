"""Async load generator for the serving engine — the Locust/AsyncIO leg.

The port's copy of ``dlti_tpu/benchmarks/loadgen.py``: the same requests,
scrapes and report keys, against either package's server. A scrape of an
endpoint the server lacks or answers 404 (the port has no ``/debug/slo`` and
no fleet yet; ``/debug/trace`` while tracing is off) leaves its report
section empty and counts no failed request.

The reference claims "Benchmarking: Locust, AsyncIO" (``README.md:11,17``)
with ``locust``/``aiohttp`` pinned but unused (``requirements.txt:35-36``).
This is that capability, stdlib-only: an asyncio closed-loop (N concurrent
users, Locust's model) or open-loop (Poisson arrivals at a target QPS)
driver speaking HTTP/1.1 over raw asyncio streams, measuring what serving
benchmarks actually need:

* per-request latency and output token counts
* TTFT (time to first streamed token) and TPOT (per-token latency) when
  ``stream=True``
* aggregate request/output-token throughput + p50/p90/p99 percentiles

Report schema feeds ``dlti_tpu_torch.cli.benchmark_serving`` and the CSV/plot
tooling (the serving analog of ``results/training_metrics.csv``).
"""

from __future__ import annotations

import asyncio
import json
import random
import re
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from dlti_tpu_torch.benchmarks.traces import TraceEvent, read_trace, write_trace


@dataclass
class LoadGenConfig:
    host: str = "127.0.0.1"
    port: int = 8000
    num_requests: int = 64
    concurrency: int = 8            # closed-loop users
    qps: Optional[float] = None     # set => open-loop Poisson arrivals
    stream: bool = True             # measure TTFT via SSE
    max_tokens: int = 64
    temperature: float = 0.0
    prompt: str = "Write a function that reverses a linked list."
    prompts: Tuple[str, ...] = ()   # optional pool; falls back to `prompt`
    chat: bool = False
    timeout_s: float = 300.0
    seed: int = 0
    # After the run, scrape the server's /metrics and attach its ON-ENGINE
    # request-lifecycle histograms (TTFT/TPOT/queue time) to the report —
    # the engine's own view of the latencies this loadgen measures from
    # outside, so client-vs-server skew (network, HTTP framing, queueing
    # before admission) is visible in one report. Off by default: the
    # target may not expose dlti_* metrics.
    scrape_server_metrics: bool = False
    # After the run, scrape the server's /debug/vars time-series ring and
    # record the watchdog alert counters + the PEAK gateway queue depth
    # over the run (the ring sees the peak; a point-in-time scrape at run
    # end would not) — so chaos/regression runs fail loudly when the
    # server's own watchdog fired. Best-effort like the /metrics scrape.
    scrape_debug_vars: bool = True
    # Multi-tenant workload: > 0 spreads requests round-robin over
    # synthetic tenants "tenant-0".."tenant-N-1" via the X-Tenant header
    # (the admission gateway's per-tenant rate limits and fair dequeue
    # see N distinct principals). 0 = no tenant header.
    tenants: int = 0
    # Priority workload mix, "interactive:0.8,batch:0.2" — each request
    # draws its class from this distribution (seeded) and sends it in the
    # body. "" = no priority field (server default class).
    priority_mix: str = ""
    # Per-request queued-deadline (seconds) sent as body deadline_s when
    # > 0; a gateway sheds past-deadline queued requests with 503.
    deadline_s: float = 0.0
    # Recurring-session (chat-shaped) workload: sessions > 0 switches the
    # driver to N concurrent sessions of `turns` requests each. Every
    # session replays a shared system prompt plus its own GROWING history
    # (turn t's prompt is a strict extension of turn t-1's), sent with an
    # X-Session header so an affinity-routing gateway keeps the session
    # on one replica's warm prefix cache. `reuse_frac` is the fraction of
    # non-first turns that actually revisit the session; the rest issue
    # an unrelated cold prompt (one-off traffic mixed into the run).
    # num_requests is ignored in this mode (sessions * turns requests).
    sessions: int = 0
    turns: int = 4
    reuse_frac: float = 1.0
    # Multi-LoRA workload: > 0 tags each request with an X-Adapter header
    # drawn from N synthetic adapter names "adapter-0".."adapter-N-1"
    # (register them on the server first — scripts/serve.py --adapter or
    # POST /v1/adapters). adapter_mix picks the draw: "zipf" (weight
    # 1/(i+1) — the realistic skew that exercises pool eviction while the
    # hot adapters stay resident) or "uniform". 0 = no adapter header.
    adapters: int = 0
    adapter_mix: str = "zipf"
    # Mixed-interference workload: this fraction of requests (seeded draw)
    # carries a synthetic long prompt of ~long_prompt_tokens tokens instead
    # of the normal prompt — the disaggregation stressor. The report then
    # splits short-request decode TPOT by whether a long prefill was
    # concurrently in flight (the `interference` section) and adds
    # "long_prompt"/"short_prompt" per_class entries. 0.0 = off.
    long_prompt_frac: float = 0.0
    long_prompt_tokens: int = 512
    # Trace replay / capture (benchmarks.traces, dlti-trace/1 JSONL).
    # `trace` replays a recorded workload: each event fires at its
    # recorded arrival offset, and tenant / priority / session / adapter
    # / prompt+output lengths / deadline all come from the event
    # (num_requests, qps, tenants, priority_mix are ignored; concurrency
    # still caps in-flight). `record_trace` writes every request THIS
    # run submitted (any drive mode, replay included) back out as a
    # trace file, so live runs become replayable fixtures.
    trace: str = ""
    record_trace: str = ""


@dataclass
class RequestRecord:
    start: float
    end: float = 0.0
    first_token: Optional[float] = None
    output_tokens: int = 0
    ok: bool = False
    error: str = ""
    status: int = 0          # HTTP status (0 = transport failure)
    tenant: str = ""
    priority: str = ""
    # Recurring-session mode: which session (if any) and whether this
    # request replayed a warm, previously-sent prefix (turn >= 1 of a
    # session) vs a cold first-touch prompt.
    session: str = ""
    warm: bool = False
    # Mixed-interference mode: this request carried the synthetic long
    # prompt (its prefill is the interference source, not a victim).
    long: bool = False
    # Multi-LoRA mode: the adapter name this request was tagged with.
    adapter: str = ""
    # Server-side critical-path breakdown (the response's "phases"
    # object: gateway queue, engine queue, tier restore, prefill,
    # failover, decode — telemetry.ledger); empty when the server
    # predates it or the request failed.
    phases: dict = field(default_factory=dict)
    # Replica-lifecycle visibility (serving.lifecycle): how many times
    # this request's KV was live-migrated between replicas mid-flight,
    # and how many failover/preempt resubmissions it survived. 0 when
    # the server predates the fields or the fleet stayed healthy.
    migrations: int = 0
    retries: int = 0
    # Distributed-trace context (telemetry.distributed_trace): the id
    # minted at admission and carried across every process this request
    # touched; joins this client-side record to the server's merged
    # /debug/trace?request_id= timeline. "" when the server predates it.
    trace_id: str = ""
    request_id: str = ""     # server-assigned id (the timeline's key)

    @property
    def shed(self) -> bool:
        """Load intentionally refused by the server (gateway 429 queue
        bound / rate limit, 503 drain or queued-deadline shed) — reported
        separately from real errors."""
        return self.status in (429, 503)

    @property
    def latency(self) -> float:
        return self.end - self.start

    @property
    def ttft(self) -> Optional[float]:
        return None if self.first_token is None else self.first_token - self.start


@dataclass
class LoadReport:
    num_requests: int
    num_ok: int
    duration_s: float
    requests_per_s: float
    output_tokens_per_s: float
    latency_p50_s: float
    latency_p90_s: float
    latency_p99_s: float
    ttft_p50_s: float = 0.0
    ttft_p90_s: float = 0.0
    ttft_p99_s: float = 0.0
    tpot_mean_ms: float = 0.0
    # Tail-of-the-tail latency (p99.9) — the SLO percentile a
    # self-healing fleet is judged on: a single quarantine/migration
    # event lands here long before it moves p99.
    ttft_p999_s: float = 0.0
    tpot_p999_ms: float = 0.0
    # Replica-lifecycle disturbance totals over the run: live KV
    # migrations and failover resubmissions the served requests
    # reported (RequestRecord.migrations / .retries).
    migrations_total: int = 0
    retries_total: int = 0
    # Gateway shed accounting: 429/503 refusals are deliberate
    # load-shedding, counted apart from num_ok and from real errors.
    num_shed: int = 0
    shed_rate: float = 0.0
    # Per-priority-class latency breakdown ({class: {count, ok, shed,
    # ttft_p50_s, ttft_p90_s, ttft_p99_s, tpot_mean_ms, latency_p50_s,
    # latency_p99_s}}); empty without a priority mix.
    per_class: dict = field(default_factory=dict)
    errors: List[str] = field(default_factory=list)
    # Server-side histogram summaries ({metric: {count, sum, mean}}) when
    # cfg.scrape_server_metrics is set; empty otherwise.
    server_histograms: dict = field(default_factory=dict)
    # Server watchdog verdict from the end-of-run /debug/vars scrape:
    # {rule: count} of alerts the SERVER's anomaly watchdog fired, and the
    # peak gateway queue depth its time-series ring observed. Empty/0 when
    # the scrape is off, the route is absent, or nothing fired.
    watchdog_alerts: dict = field(default_factory=dict)
    peak_queue_depth: float = 0.0
    # Recurring-session mode: cold (first-touch) vs warm (repeat-prefix)
    # TTFT percentiles — the tiered-prefix-cache headline — plus the
    # server's own prefix-cache hit rate scraped from /stats at run end
    # ((cached + restored) / (cached + restored + prefilled) tokens;
    # 0.0 when the scrape fails or the server runs without the cache).
    num_cold: int = 0
    num_warm: int = 0
    cold_ttft_p50_s: float = 0.0
    cold_ttft_p90_s: float = 0.0
    warm_ttft_p50_s: float = 0.0
    warm_ttft_p90_s: float = 0.0
    cache_hit_rate: float = 0.0
    # Multi-LoRA mode (cfg.adapters > 0): per-adapter latency breakdown
    # ({adapter: {count, ok, shed, ttft/latency percentiles, tpot}} — the
    # _class_summary schema), plus the server's own adapter-pool hit rate
    # scraped from /metrics at run end (pool_hits / (hits + misses); 0.0
    # when the scrape fails or the server runs without a pool).
    per_adapter: dict = field(default_factory=dict)
    adapter_pool_hit_rate: float = 0.0
    # Mixed-interference mode (long_prompt_frac > 0): decode-TPOT p99 of
    # SHORT requests split by whether a long prompt's prefill window
    # overlapped their decode window — the prefill→decode interference a
    # disaggregated server is supposed to remove. Empty when the mode is
    # off or one side has no samples.
    interference: dict = field(default_factory=dict)
    # Critical-path decomposition (goodput-ledger era): mean seconds per
    # server-reported phase (gateway queue, engine queue, tier restore,
    # prefill, failover, decode) over all ok requests, and the cold vs
    # warm split — the "warm TTFT is lower BECAUSE restore replaced
    # prefill" evidence, not just the headline percentiles. Empty when
    # the server doesn't report phases.
    phase_means: dict = field(default_factory=dict)
    cold_phases: dict = field(default_factory=dict)
    warm_phases: dict = field(default_factory=dict)
    # End-of-run HBM attribution scraped from the server's /debug/memory
    # (telemetry.memledger): source, bytes_in_use, peak/untracked bytes
    # and the per-owner map — "did this load level fit, and with how much
    # headroom" alongside the latency numbers. Empty when the scrape is
    # off, the route is absent, or the server's ledger is disabled.
    memory: dict = field(default_factory=dict)
    # Multi-process fleet federation cross-check (serving.fleet): when
    # the end-of-run /metrics scrape finds per-worker federated series
    # (dlti_fleet_w{i}_requests, ...), sum each counter across workers
    # and compare against the gateway-level dlti_<key> total — the two
    # are computed from the same per-worker snapshots, so any delta
    # means the federation lost or double-counted a worker (e.g. across
    # a respawn). {"per_worker": {id: {key: v}}, "checks": {key:
    # {per_worker_sum, fleet_total, delta}}, "consistent": bool, plus
    # the fleet liveness/respawn counters}. Empty against a
    # single-process server.
    fleet_federation: dict = field(default_factory=dict)
    # Speculative-decode economics scraped from /metrics at run end
    # (engine.SPEC_METRIC_NAMES): proposed/accepted draft-token totals,
    # paused slot-rounds, the cumulative acceptance rate, and the draft
    # length the adaptive ladder last dispatched. All zeros against a
    # server running without --speculative (the series are schema-stable
    # and always exposed); {} only when the scrape itself fails.
    spec: dict = field(default_factory=dict)
    # SLO cross-check (telemetry.slo via GET /debug/slo): the server's
    # per-(objective, class) compliance / error-budget / breaching state
    # at run end, the client's own compliance recomputed from this run's
    # records at the server-reported (bucket-snapped) thresholds, and
    # per-pair agreement deltas — the server's SLO engine audited from
    # outside. Empty when the scrape is off, the route is absent, or the
    # server runs without --slo.
    slo: dict = field(default_factory=dict)
    # Distributed-trace coverage (telemetry.distributed_trace): of a
    # bounded sample of ok requests, the fraction whose server-side
    # merged timeline (GET /debug/trace?request_id=) contains the
    # gateway, prefill AND decode legs — span federation audited
    # end-to-end from the client. 0.0 when the scrape is off, tracing is
    # disabled server-side, or the server predates trace ids.
    trace_coverage: float = 0.0
    # The raw per-request records, for programmatic callers (the fleet
    # trace drill samples a migrated request's id + client latency to
    # cross-check the server's /debug/trace timeline against). Excluded
    # from to_dict(): the JSON report stays a summary, not a request log.
    records: List[RequestRecord] = field(default_factory=list)

    def to_dict(self) -> dict:
        import dataclasses

        d = dataclasses.asdict(self)
        d.pop("records", None)
        return d


def _percentile(xs: List[float], p: float) -> float:
    """Linear interpolation between closest ranks (numpy's default
    method). Nearest-rank rounding is too coarse for tail percentiles at
    bench-sized sample counts — at n=100, p99 and p99.9 both snapped to
    the max sample, hiding a tail regression until it moved p90."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = max(0.0, p / 100.0 * (len(xs) - 1))
    f = int(k)
    if f >= len(xs) - 1:
        return xs[-1]
    return xs[f] + (k - f) * (xs[f + 1] - xs[f])


async def _iter_body(reader, headers: dict, timeout_s: float):
    """Yield decoded body byte chunks, honoring Transfer-Encoding: chunked
    (RFC 9112 §7.1) so framing never corrupts the payload — against servers
    beyond the in-repo one (which uses Content-Length), chunk-size lines
    would otherwise interleave with the JSON/SSE bytes."""
    if "chunked" in headers.get("transfer-encoding", "").lower():
        while True:
            size_line = await asyncio.wait_for(reader.readline(), timeout_s)
            if not size_line:
                return  # truncated stream
            try:
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
            except ValueError:
                return
            if size == 0:
                # Drain trailer section up to the blank line.
                while True:
                    t = await asyncio.wait_for(reader.readline(), timeout_s)
                    if t in (b"\r\n", b"\n", b""):
                        return
            data = await asyncio.wait_for(reader.readexactly(size), timeout_s)
            yield data
            await asyncio.wait_for(reader.readline(), timeout_s)  # CRLF
    elif "content-length" in headers:
        n = int(headers["content-length"])
        if n > 0:
            yield await asyncio.wait_for(reader.readexactly(n), timeout_s)
    else:
        while True:
            chunk = await asyncio.wait_for(reader.read(4096), timeout_s)
            if not chunk:
                return
            yield chunk


async def _http_post_sse(host: str, port: int, path: str, body: dict,
                         rec: RequestRecord, timeout_s: float,
                         extra_headers: Optional[dict] = None) -> None:
    """POST; if the response is SSE, count data chunks and stamp TTFT."""
    writer = None
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout_s
        )
        payload = json.dumps(body).encode()
        extra = "".join(f"{k}: {v}\r\n"
                        for k, v in (extra_headers or {}).items())
        req = (f"POST {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
               f"Content-Type: application/json\r\n{extra}"
               f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n"
               ).encode() + payload
        writer.write(req)
        await writer.drain()

        status_line = await asyncio.wait_for(reader.readline(), timeout_s)
        parts = status_line.split()
        if len(parts) < 2:
            rec.error = f"malformed/empty status line: {status_line[:80]!r}"
            return
        status = int(parts[1])
        rec.status = status
        headers = {}
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout_s)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()

        if status != 200:
            raw = b"".join([c async for c in _iter_body(reader, headers, timeout_s)])
            rec.error = f"HTTP {status}: {raw[:200].decode(errors='replace')}"
            return

        if headers.get("content-type", "").startswith("text/event-stream"):
            # SSE: scan dechunked stream for `data:` lines.
            n_data = 0
            usage_tokens = 0
            buf = b""
            async for chunk in _iter_body(reader, headers, timeout_s):
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    s = line.strip()
                    if not s.startswith(b"data:"):
                        continue
                    data = s[5:].strip()
                    if data == b"[DONE]":
                        rec.ok = True
                        continue
                    try:
                        obj = json.loads(data)
                    except json.JSONDecodeError:
                        continue
                    choices = obj.get("choices") or [{}]
                    delta = choices[0].get("delta", {}).get("content") \
                        if "delta" in choices[0] else choices[0].get("text")
                    if delta:
                        if rec.first_token is None:
                            rec.first_token = time.monotonic()
                        n_data += 1
                    if obj.get("usage"):
                        usage_tokens = int(
                            obj["usage"].get("completion_tokens", 0))
                    if obj.get("phases"):
                        rec.phases = dict(obj["phases"])
                    if "migrations" in obj:
                        rec.migrations = int(obj.get("migrations") or 0)
                    if "retries" in obj:
                        rec.retries = int(obj.get("retries") or 0)
                    if obj.get("trace_id"):
                        rec.trace_id = str(obj["trace_id"])
                    if obj.get("id"):
                        rec.request_id = str(obj["id"])
            # Prefer the final chunk's usage (token-accurate; our server
            # always sends it — stream_options.include_usage semantics).
            # Fallback: SSE event count, the stream's visible progress
            # unit (!= tokens when multi-step decode batches per sync).
            rec.output_tokens = usage_tokens if usage_tokens else n_data
            rec.ok = rec.ok or n_data > 0 or usage_tokens > 0
        else:
            raw = b"".join([c async for c in _iter_body(reader, headers, timeout_s)])
            obj = json.loads(raw)
            usage = obj.get("usage", {})
            rec.output_tokens = int(usage.get("completion_tokens", 0))
            if obj.get("phases"):
                rec.phases = dict(obj["phases"])
            rec.migrations = int(obj.get("migrations") or 0)
            rec.retries = int(obj.get("retries") or 0)
            rec.trace_id = str(obj.get("trace_id") or "")
            rec.request_id = str(obj.get("id") or "")
            rec.ok = True
    except Exception as e:  # noqa: BLE001 — one request's failure is a
        # recorded data point, never a crash of the whole load test.
        rec.error = f"{type(e).__name__}: {e}"
    finally:
        rec.end = time.monotonic()
        if writer is not None:
            writer.close()
            try:
                await writer.wait_closed()
            except OSError:
                pass


async def _scrape_histograms(host: str, port: int,
                             timeout_s: float = 10.0) -> dict:
    """GET /metrics and fold Prometheus histogram series into
    ``{name: {count, sum, mean}}``. Best-effort: any failure (no route,
    refused connection, unparseable body) returns ``{}`` — scraping must
    never fail a load test."""
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout_s)
        req = (f"GET /metrics HTTP/1.1\r\nHost: {host}:{port}\r\n"
               f"Connection: close\r\n\r\n").encode()
        writer.write(req)
        await writer.drain()
        status_line = await asyncio.wait_for(reader.readline(), timeout_s)
        if b" 200 " not in status_line and not status_line.endswith(b" 200\r\n"):
            return {}
        headers: dict = {}
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout_s)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        raw = b"".join([c async for c in _iter_body(reader, headers, timeout_s)])
        writer.close()
    except Exception:
        return {}
    out: dict = {}
    for line in raw.decode(errors="replace").splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, _, value = line.partition(" ")
        base = None
        if name.endswith("_sum"):
            base, key = name[:-4], "sum"
        elif name.endswith("_count"):
            base, key = name[:-6], "count"
        if base is None:
            continue
        try:
            v = float(value)
        except ValueError:
            continue
        out.setdefault(base, {})[key] = v
    hists = {}
    for base, d in out.items():
        if "count" in d and "sum" in d:
            n = d["count"]
            hists[base] = {"count": int(n), "sum": round(d["sum"], 6),
                           "mean": round(d["sum"] / n, 6) if n else 0.0}
    return hists


async def _http_get_json(host: str, port: int, path: str,
                         timeout_s: float = 10.0) -> Optional[dict]:
    """GET a JSON route over raw asyncio streams; None on any failure
    (scrapes must never fail a load test)."""
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout_s)
        req = (f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
               f"Connection: close\r\n\r\n").encode()
        writer.write(req)
        await writer.drain()
        status_line = await asyncio.wait_for(reader.readline(), timeout_s)
        if b" 200 " not in status_line and \
                not status_line.endswith(b" 200\r\n"):
            return None
        headers: dict = {}
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout_s)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        raw = b"".join([c async for c in _iter_body(reader, headers,
                                                    timeout_s)])
        writer.close()
        return json.loads(raw)
    except Exception:
        return None


def _watchdog_report(debug_vars: Optional[dict]) -> Tuple[dict, float]:
    """-> ({rule: alert_count}, peak gateway queue depth) from a
    /debug/vars snapshot (the ring holds the run's history, so the peak
    is the true peak, not the end-of-run value)."""
    if not debug_vars:
        return {}, 0.0
    alerts: dict = {}
    prefix = "dlti_watchdog_alerts_total"
    for k, v in (debug_vars.get("latest") or {}).items():
        if not k.startswith(prefix) or not v:
            continue
        label = k[len(prefix):].strip("{}")  # e.g. rule="hung_step"
        rule = label.partition("=")[2].strip('"') or label or "total"
        alerts[rule] = alerts.get(rule, 0) + int(v)
    peak = 0.0
    for s in debug_vars.get("samples") or []:
        peak = max(peak, float(s.get("values", {})
                               .get("gateway_queue_depth", 0.0)))
    return alerts, peak


def _slo_client_compliance(server_slo: dict,
                           recs: List[RequestRecord]) -> dict:
    """Recompute the server's SLO compliance from this run's records,
    classifying at the server-reported (bucket-snapped) thresholds so
    both sides cut on the identical boundary. Only objectives the client
    can observe from outside are recomputed — ttft (first SSE token),
    tpot (per-token decode latency), availability (ok vs refused) —
    queue_delay and goodput are server-internal."""
    out: dict = {}
    for key, st in (server_slo.get("objectives") or {}).items():
        name = st.get("objective")
        cls = st.get("class", "all")
        pool = [r for r in recs
                if cls in ("all", "") or r.priority == cls]
        thr = st.get("threshold_s")
        good = total = 0
        if name == "ttft" and thr:
            vals = [r.ttft for r in pool if r.ok and r.ttft is not None]
            total = len(vals)
            good = sum(1 for v in vals if v <= thr)
        elif name == "tpot" and thr:
            vals = [(r.latency - r.ttft) / (r.output_tokens - 1)
                    for r in pool
                    if r.ok and r.ttft is not None and r.output_tokens > 1]
            total = len(vals)
            good = sum(1 for v in vals if v <= thr)
        elif name == "availability":
            done = [r for r in pool if r.status or r.error]
            total = len(done)
            good = sum(1 for r in done if r.ok)
        else:
            continue
        if total:
            out[key] = {"good": good, "total": total,
                        "compliance": round(good / total, 6)}
    return out


def _slo_report(server_slo: dict, recs: List[RequestRecord]) -> dict:
    """LoadReport.slo: the server's /debug/slo state, the client-side
    recomputation, and per-(objective, class) agreement deltas. The
    server is windowed — the cross-check is honest only when its SLO
    window covers the whole run (the drill harness arranges that)."""
    server: dict = {}
    for key, st in (server_slo.get("objectives") or {}).items():
        server[key] = {
            "compliance": st.get("compliance"),
            "error_budget_remaining": st.get("error_budget_remaining"),
            "breaching": bool(st.get("breaching", False)),
            "threshold_s": st.get("threshold_s"),
            "target": st.get("target"),
        }
    client = _slo_client_compliance(server_slo, recs)
    agreement: dict = {}
    for key, c in client.items():
        s = server.get(key, {})
        if s.get("compliance") is None:
            continue
        delta = abs(float(s["compliance"]) - c["compliance"])
        agreement[key] = {"server": s["compliance"],
                         "client": c["compliance"],
                         "delta": round(delta, 6)}
    return {
        "server": server,
        "client": client,
        "agreement": agreement,
        "max_delta": round(max((a["delta"] for a in agreement.values()),
                               default=0.0), 6),
        "breaching": list(server_slo.get("breaching") or []),
    }


def _trace_prompt(ev: TraceEvent, idx: int) -> str:
    """Synthetic prompt sized to ev.prompt_tokens tokens (exact under the
    byte tokenizer: one char per token). A per-event prefix keeps replayed
    prompts distinct so a prefix cache can't collapse the prefill work
    the trace's length distribution encodes."""
    filler = f"[trace {idx}] replayed workload payload segment text. "
    n = max(1, int(ev.prompt_tokens))
    return (filler * (n // len(filler) + 1))[:n]


def _body_prompt_tokens(body: dict) -> int:
    """~token count of a request body's prompt (exact under the byte
    tokenizer: one char per token)."""
    if "prompt" in body:
        return len(body["prompt"])
    return sum(len(m.get("content", ""))
               for m in body.get("messages") or [])


def parse_priority_mix(spec: str) -> List[Tuple[str, float]]:
    """"interactive:0.8,batch:0.2" -> [("interactive", 0.8), ...]."""
    out: List[Tuple[str, float]] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            weight = float(w) if w else 1.0
        except ValueError:
            raise ValueError(f"bad priority mix entry {part!r} "
                             f"(expected class:weight)")
        if weight < 0:
            raise ValueError(f"priority weight must be >= 0: {part!r}")
        out.append((name.strip(), weight))
    return out


def _long_prompt(cfg: LoadGenConfig, idx: int) -> str:
    """Synthetic long-document prompt sized to ~long_prompt_tokens tokens
    (exact under the byte tokenizer: one char per token). A per-request
    prefix keeps prompts distinct so a prefix cache can't collapse the
    prefill work the interference measurement depends on."""
    filler = f"[doc {idx}] long document segment under summarization. "
    n = max(1, cfg.long_prompt_tokens)
    return (filler * (n // len(filler) + 1))[:n]


def _draw_adapter(cfg: LoadGenConfig, rng: random.Random) -> str:
    """Draw an adapter name "adapter-i" under the configured mix: zipf
    weights 1/(i+1) (adapter-0 hottest), uniform weighs all equally."""
    if cfg.adapters <= 0:
        return ""
    if cfg.adapter_mix == "uniform":
        i = rng.randrange(cfg.adapters)
    elif cfg.adapter_mix == "zipf":
        weights = [1.0 / (k + 1) for k in range(cfg.adapters)]
        i = rng.choices(range(cfg.adapters), weights=weights)[0]
    else:
        raise ValueError(f"adapter_mix must be 'zipf' or 'uniform', "
                         f"got {cfg.adapter_mix!r}")
    return f"adapter-{i}"


def _build_body(cfg: LoadGenConfig, rng: random.Random, idx: int,
                mix: List[Tuple[str, float]],
                ) -> Tuple[str, dict, dict, str, str, bool, str]:
    """-> (path, body, extra_headers, tenant, priority, long, adapter)
    for request idx."""
    long = (cfg.long_prompt_frac > 0
            and rng.random() < cfg.long_prompt_frac)
    prompt = (_long_prompt(cfg, idx) if long
              else rng.choice(cfg.prompts) if cfg.prompts else cfg.prompt)
    if cfg.chat:
        path = "/v1/chat/completions"
        body = {"messages": [{"role": "user", "content": prompt}]}
    else:
        path = "/v1/completions"
        body = {"prompt": prompt}
    body.update({"max_tokens": cfg.max_tokens, "temperature": cfg.temperature,
                 "stream": cfg.stream})
    headers: dict = {}
    tenant = priority = ""
    if cfg.tenants > 0:
        tenant = f"tenant-{idx % cfg.tenants}"
        headers["X-Tenant"] = tenant
    if mix:
        priority = rng.choices([m[0] for m in mix],
                               weights=[m[1] for m in mix])[0]
        body["priority"] = priority
    if cfg.deadline_s and cfg.deadline_s > 0:
        body["deadline_s"] = cfg.deadline_s
    adapter = _draw_adapter(cfg, rng)
    if adapter:
        headers["X-Adapter"] = adapter
    return path, body, headers, tenant, priority, long, adapter


def _phase_means(recs: List[RequestRecord]) -> dict:
    """Mean seconds per server-reported critical-path phase over the
    records that carried one ({} when none did). "total_s"/"ttft_s" ride
    along so the breakdown can be sanity-checked against the client-side
    latency percentiles."""
    agg: dict = {}
    n = 0
    for r in recs:
        if not r.phases:
            continue
        n += 1
        for k, v in r.phases.items():
            if isinstance(v, (int, float)):
                agg[k] = agg.get(k, 0.0) + float(v)
    return {k: round(v / n, 4) for k, v in agg.items()} if n else {}


def _class_summary(recs: List[RequestRecord]) -> dict:
    ok = [r for r in recs if r.ok]
    lat = [r.latency for r in ok]
    ttfts = [r.ttft for r in ok if r.ttft is not None]
    tpots_ms = [
        (r.latency - r.ttft) / max(1, r.output_tokens - 1) * 1000
        for r in ok if r.ttft is not None and r.output_tokens > 1
    ]
    return {
        "count": len(recs),
        "ok": len(ok),
        "shed": sum(1 for r in recs if r.shed),
        "latency_p50_s": round(_percentile(lat, 50), 4),
        "latency_p99_s": round(_percentile(lat, 99), 4),
        "ttft_p50_s": round(_percentile(ttfts, 50), 4),
        "ttft_p90_s": round(_percentile(ttfts, 90), 4),
        "ttft_p99_s": round(_percentile(ttfts, 99), 4),
        "tpot_mean_ms": (round(sum(tpots_ms) / len(tpots_ms), 2)
                         if tpots_ms else 0.0),
        "tpot_p99_ms": round(_percentile(tpots_ms, 99), 2),
    }


def _interference_summary(recs: List[RequestRecord]) -> dict:
    """Decode-TPOT p99 of short requests, split by whether any long
    request's prefill window [start, first_token] overlapped their decode
    window [first_token, end]. The victim metric of prefill→decode
    interference: a colocated engine's long chunks steal decode steps
    from co-resident slots; a disaggregated one's don't."""
    longs = [r for r in recs if r.long and r.ok and r.first_token is not None]
    shorts = [r for r in recs if not r.long and r.ok
              and r.first_token is not None and r.output_tokens > 1]
    if not longs or not shorts:
        return {}
    windows = [(r.start, r.first_token) for r in longs]
    with_ms: List[float] = []
    without_ms: List[float] = []
    for r in shorts:
        tpot = (r.end - r.first_token) / (r.output_tokens - 1) * 1000
        overlapped = any(ws < r.end and we > r.first_token
                         for ws, we in windows)
        (with_ms if overlapped else without_ms).append(tpot)
    return {
        "num_long": len(longs),
        "num_with_long_prefill": len(with_ms),
        "num_without_long_prefill": len(without_ms),
        "tpot_p99_with_long_prefill_ms": round(_percentile(with_ms, 99), 2),
        "tpot_p99_without_long_prefill_ms":
            round(_percentile(without_ms, 99), 2),
        "tpot_p50_with_long_prefill_ms": round(_percentile(with_ms, 50), 2),
        "tpot_p50_without_long_prefill_ms":
            round(_percentile(without_ms, 50), 2),
    }


async def _scrape_adapter_hit_rate(cfg: LoadGenConfig) -> float:
    """Adapter-pool hit rate from the server's /metrics counters
    (dlti_adapter_pool_{hits,misses}_total): hits / (hits + misses).
    Best-effort like every scrape — 0.0 on any failure or a pool that
    never resolved an adapter."""
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(cfg.host, cfg.port), 10.0)
        req = (f"GET /metrics HTTP/1.1\r\nHost: {cfg.host}:{cfg.port}\r\n"
               f"Connection: close\r\n\r\n").encode()
        writer.write(req)
        await writer.drain()
        status_line = await asyncio.wait_for(reader.readline(), 10.0)
        if b" 200" not in status_line:
            return 0.0
        headers: dict = {}
        while True:
            line = await asyncio.wait_for(reader.readline(), 10.0)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        raw = b"".join([c async for c in _iter_body(reader, headers, 10.0)])
        writer.close()
    except Exception:
        return 0.0
    vals = {}
    for line in raw.decode(errors="replace").splitlines():
        name, _, value = line.partition(" ")
        if name in ("dlti_adapter_pool_hits_total",
                    "dlti_adapter_pool_misses_total"):
            try:
                vals[name] = float(value)
            except ValueError:
                pass
    hits = vals.get("dlti_adapter_pool_hits_total", 0.0)
    misses = vals.get("dlti_adapter_pool_misses_total", 0.0)
    return round(hits / (hits + misses), 4) if hits + misses else 0.0


# Per-worker counters the fleet supervisor federates (must mirror
# dlti_tpu.serving.fleet.WORKER_COUNTER_KEYS — pinned by the fleet tests;
# not imported so the loadgen stays usable against a remote server
# without pulling in the engine stack).
_FLEET_COUNTER_KEYS = ("requests", "generated_tokens", "prefill_tokens",
                       "preemptions", "decode_steps")
_FLEET_SERIES_RE = re.compile(r"^dlti_fleet_w(\d+)_([a-z_]+) (\S+)$")


def _fleet_federation_report(metrics_text: str) -> dict:
    """LoadReport.fleet_federation from a raw /metrics exposition: sum
    each per-worker federated counter (``dlti_fleet_w{i}_<key>``) across
    workers and check it equals the gateway-level ``dlti_<key>`` total.
    {} when the exposition carries no fleet series (single-process
    server)."""
    scalars: dict = {}
    per_worker: dict = {}
    for line in metrics_text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        m = _FLEET_SERIES_RE.match(line)
        if m:
            wid, key, val = int(m.group(1)), m.group(2), m.group(3)
            try:
                per_worker.setdefault(wid, {})[key] = float(val)
            except ValueError:
                pass
            continue
        name, _, value = line.partition(" ")
        try:
            scalars[name] = float(value)
        except ValueError:
            pass
    if not per_worker:
        return {}
    checks: dict = {}
    for key in _FLEET_COUNTER_KEYS:
        rows = [w[key] for w in per_worker.values() if key in w]
        if not rows or f"dlti_{key}" not in scalars:
            continue
        total = scalars[f"dlti_{key}"]
        checks[key] = {
            "per_worker_sum": sum(rows),
            "fleet_total": total,
            "delta": total - sum(rows),
        }
    return {
        "workers": sorted(per_worker),
        "workers_alive": scalars.get("dlti_fleet_workers_alive"),
        "respawns_total": scalars.get("dlti_fleet_respawns_total"),
        "per_worker": per_worker,
        "checks": checks,
        "max_abs_delta": max((abs(c["delta"]) for c in checks.values()),
                             default=0.0),
        "consistent": all(c["delta"] == 0 for c in checks.values()),
    }


async def _scrape_spec(cfg: LoadGenConfig) -> dict:
    """LoadReport.spec from the server's /metrics exposition: the five
    schema-stable speculative-decode series (dlti_spec_*_total counters
    plus the acceptance-rate / draft-length gauges), reported under
    short keys. Best-effort like every scrape — {} on any failure."""
    names = {
        "dlti_spec_proposed_total": "proposed",
        "dlti_spec_accepted_total": "accepted",
        "dlti_spec_paused_rounds_total": "paused_rounds",
        "dlti_spec_acceptance_rate": "acceptance_rate",
        "dlti_spec_draft_len": "draft_len",
    }
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(cfg.host, cfg.port), 10.0)
        req = (f"GET /metrics HTTP/1.1\r\nHost: {cfg.host}:{cfg.port}\r\n"
               f"Connection: close\r\n\r\n").encode()
        writer.write(req)
        await writer.drain()
        status_line = await asyncio.wait_for(reader.readline(), 10.0)
        if b" 200" not in status_line:
            return {}
        headers: dict = {}
        while True:
            line = await asyncio.wait_for(reader.readline(), 10.0)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        raw = b"".join([c async for c in _iter_body(reader, headers, 10.0)])
        writer.close()
    except Exception:
        return {}
    out: dict = {}
    for line in raw.decode(errors="replace").splitlines():
        name, _, value = line.partition(" ")
        if name in names:
            try:
                out[names[name]] = float(value)
            except ValueError:
                pass
    return out


async def _scrape_trace_coverage(cfg: LoadGenConfig,
                                 recs: List["RequestRecord"],
                                 sample: int = 16) -> float:
    """LoadReport.trace_coverage: fetch the merged server-side timeline
    (GET /debug/trace?request_id=) for a bounded sample of ok requests
    and count those whose span tree carries the gateway, prefill AND
    decode legs. Best-effort like every scrape: 0.0 when tracing is
    disabled, the route is absent, or no response carried an id."""
    cand = [r for r in recs if r.ok and r.request_id]
    if not cand:
        return 0.0
    # Newest first: the span ring evicts oldest, so sampling the tail
    # measures federation, not ring capacity.
    cand = cand[-sample:]
    need = {"gateway/queued", "request/prefill", "request/decode"}
    covered = 0
    for r in cand:
        tl = await _http_get_json(
            cfg.host, cfg.port, f"/debug/trace?request_id={r.request_id}")
        if tl and need <= set(tl.get("legs") or {}):
            covered += 1
    return round(covered / len(cand), 4)


async def _scrape_fleet_federation(cfg: LoadGenConfig) -> dict:
    """GET /metrics and run the fleet federation cross-check.
    Best-effort like every scrape: {} on any failure or against a
    server with no fleet series."""
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(cfg.host, cfg.port), 10.0)
        req = (f"GET /metrics HTTP/1.1\r\nHost: {cfg.host}:{cfg.port}\r\n"
               f"Connection: close\r\n\r\n").encode()
        writer.write(req)
        await writer.drain()
        status_line = await asyncio.wait_for(reader.readline(), 10.0)
        if b" 200" not in status_line:
            return {}
        headers: dict = {}
        while True:
            line = await asyncio.wait_for(reader.readline(), 10.0)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        raw = b"".join([c async for c in _iter_body(reader, headers, 10.0)])
        writer.close()
    except Exception:
        return {}
    return _fleet_federation_report(raw.decode(errors="replace"))


async def _scrape_cache_hit_rate(cfg: LoadGenConfig) -> float:
    """Prefix-cache hit rate from the server's own /stats counters:
    tokens served from cache (HBM hits + lower-tier restores) over all
    prompt tokens the engine handled. Best-effort like every scrape."""
    stats = await _http_get_json(cfg.host, cfg.port, "/stats")
    if not stats:
        return 0.0
    cached = float(stats.get("prefix_cached_tokens", 0) or 0)
    restored = float(stats.get("prefix_restored_tokens", 0) or 0)
    prefilled = float(stats.get("prefill_tokens", 0) or 0)
    total = cached + restored + prefilled
    return round((cached + restored) / total, 4) if total else 0.0


async def _run_async(cfg: LoadGenConfig) -> LoadReport:
    rng = random.Random(cfg.seed)
    mix = parse_priority_mix(cfg.priority_mix)
    records: List[RequestRecord] = []
    captured: List[TraceEvent] = []
    sem = asyncio.Semaphore(cfg.concurrency)

    def _capture(rec: RequestRecord, body: dict) -> None:
        # --record-trace: every submitted request (any drive mode)
        # becomes a trace event at its actual send offset.
        if not cfg.record_trace:
            return
        captured.append(TraceEvent(
            offset_s=max(0.0, rec.start - t0),
            prompt_tokens=_body_prompt_tokens(body),
            max_tokens=int(body.get("max_tokens", cfg.max_tokens)),
            tenant=rec.tenant, priority=rec.priority,
            session=rec.session, adapter=rec.adapter,
            deadline_s=float(body.get("deadline_s", 0.0) or 0.0)))

    async def one(idx: int) -> None:
        async with sem:
            path, body, headers, tenant, priority, long, adapter = \
                _build_body(cfg, rng, idx, mix)
            rec = RequestRecord(start=time.monotonic(), tenant=tenant,
                                priority=priority, long=long,
                                adapter=adapter)
            records.append(rec)
            _capture(rec, body)
            await _http_post_sse(cfg.host, cfg.port, path, body, rec,
                                 cfg.timeout_s, extra_headers=headers)

    async def replay_one(idx: int, ev: TraceEvent) -> None:
        async with sem:
            prompt = _trace_prompt(ev, idx)
            if cfg.chat:
                path = "/v1/chat/completions"
                body: dict = {"messages": [{"role": "user",
                                            "content": prompt}]}
            else:
                path = "/v1/completions"
                body = {"prompt": prompt}
            body.update({"max_tokens": ev.max_tokens or cfg.max_tokens,
                         "temperature": cfg.temperature,
                         "stream": cfg.stream})
            headers: dict = {}
            if ev.tenant:
                headers["X-Tenant"] = ev.tenant
            if ev.priority:
                body["priority"] = ev.priority
            if ev.session:
                headers["X-Session"] = ev.session
            if ev.adapter:
                headers["X-Adapter"] = ev.adapter
            if ev.deadline_s and ev.deadline_s > 0:
                body["deadline_s"] = ev.deadline_s
            rec = RequestRecord(start=time.monotonic(), tenant=ev.tenant,
                                priority=ev.priority, session=ev.session,
                                adapter=ev.adapter)
            records.append(rec)
            _capture(rec, body)
            await _http_post_sse(cfg.host, cfg.port, path, body, rec,
                                 cfg.timeout_s, extra_headers=headers)

    async def session_task(sidx: int) -> None:
        # One chat session: `turns` sequential requests replaying a shared
        # system prompt + this session's growing history. Turn t's prompt
        # strictly extends turn t-1's, so a prefix-caching server skips
        # everything but the new tail — the cold-vs-warm TTFT split below
        # is the measurement of exactly that.
        srng = random.Random(cfg.seed * 7919 + sidx)
        sess = f"sess-{sidx}"
        system = cfg.prompt
        history: List[str] = []
        for t in range(cfg.turns):
            reuse = t > 0 and srng.random() < cfg.reuse_frac
            if t == 0 or reuse:
                history.append(f"[turn {len(history)}] {sess} follow-up "
                               f"question {len(history)}")
                text = system + "\n" + "\n".join(history)
                headers = {"X-Session": sess}
                rec_sess, warm = sess, t > 0
            else:
                # Defecting turn: unrelated one-off traffic (cold), no
                # session header — the (1 - reuse_frac) noise floor.
                text = f"one-off {sess}-{t}: {system[::-1]}"
                headers = {}
                rec_sess, warm = "", False
            if cfg.tenants > 0:
                headers["X-Tenant"] = f"tenant-{sidx % cfg.tenants}"
            if cfg.chat:
                path = "/v1/chat/completions"
                body = {"messages": [{"role": "user", "content": text}]}
            else:
                path = "/v1/completions"
                body = {"prompt": text}
            body.update({"max_tokens": cfg.max_tokens,
                         "temperature": cfg.temperature,
                         "stream": cfg.stream})
            if cfg.deadline_s and cfg.deadline_s > 0:
                body["deadline_s"] = cfg.deadline_s
            async with sem:
                rec = RequestRecord(start=time.monotonic(),
                                    tenant=headers.get("X-Tenant", ""),
                                    session=rec_sess, warm=warm)
                records.append(rec)
                await _http_post_sse(cfg.host, cfg.port, path, body, rec,
                                     cfg.timeout_s, extra_headers=headers)

    replay_events: List[TraceEvent] = []
    if cfg.trace:
        _, replay_events = read_trace(cfg.trace)

    t0 = time.monotonic()
    if cfg.trace:
        # Trace replay: fire each event at its recorded arrival offset —
        # sleep up to the offset, never ahead; a late event fires
        # immediately so offsets stay faithful under scheduler jitter.
        tasks = []
        for i, ev in enumerate(replay_events):
            delay = t0 + ev.offset_s - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append(asyncio.create_task(replay_one(i, ev)))
        await asyncio.gather(*tasks, return_exceptions=True)
    elif cfg.sessions > 0:
        # Recurring-session mode: sessions run concurrently, each one's
        # turns strictly in order (turn t+1 needs t's prefix resident).
        await asyncio.gather(
            *(session_task(i) for i in range(cfg.sessions)),
            return_exceptions=True)
    elif cfg.qps:
        # Open loop: Poisson arrivals; concurrency still caps in-flight.
        tasks = []
        for i in range(cfg.num_requests):
            tasks.append(asyncio.create_task(one(i)))
            await asyncio.sleep(rng.expovariate(cfg.qps))
        await asyncio.gather(*tasks, return_exceptions=True)
    else:
        # Closed loop: `concurrency` users issuing back-to-back requests.
        await asyncio.gather(*(one(i) for i in range(cfg.num_requests)),
                             return_exceptions=True)
    duration = time.monotonic() - t0
    if cfg.record_trace and captured:
        write_trace(cfg.record_trace, captured,
                    meta={"source": "loadgen", "seed": cfg.seed,
                          "mode": ("replay" if cfg.trace else
                                   "sessions" if cfg.sessions > 0 else
                                   "open" if cfg.qps else "closed")})
    server_hists = (await _scrape_histograms(cfg.host, cfg.port)
                    if cfg.scrape_server_metrics else {})
    watchdog_alerts, peak_queue = _watchdog_report(
        await _http_get_json(cfg.host, cfg.port, "/debug/vars")
        if cfg.scrape_debug_vars else None)
    # End-of-run memory map (telemetry.memledger via /debug/memory) —
    # best-effort like every other scrape; {} when absent/disabled.
    mem_snap = (await _http_get_json(cfg.host, cfg.port, "/debug/memory")
                if cfg.scrape_debug_vars else None)
    # End-of-run SLO state (telemetry.slo via /debug/slo) cross-checked
    # against this run's own records — best-effort like every scrape.
    slo_snap = (await _http_get_json(cfg.host, cfg.port, "/debug/slo")
                if cfg.scrape_debug_vars else None)
    # End-of-run fleet federation cross-check (serving.fleet) — rides
    # the same best-effort gate; {} against a single-process server.
    fleet_federation = (await _scrape_fleet_federation(cfg)
                        if cfg.scrape_debug_vars else {})
    # End-of-run speculative-decode economics (engine spec scalar
    # source) — same best-effort gate; all-zero values against a server
    # running without --speculative.
    spec = (await _scrape_spec(cfg) if cfg.scrape_debug_vars else {})
    # End-of-run distributed-trace audit: same best-effort gate; 0.0
    # against a server with tracing off or without trace ids.
    trace_coverage = (await _scrape_trace_coverage(cfg, records)
                      if cfg.scrape_debug_vars else 0.0)
    slo = (_slo_report(slo_snap, records)
           if slo_snap and slo_snap.get("objectives") else {})
    memory = {}
    if mem_snap:
        memory = {
            "source": mem_snap.get("source", ""),
            "bytes_in_use": mem_snap.get("bytes_in_use", 0),
            "peak_bytes": mem_snap.get("peak_bytes", 0),
            "untracked_bytes": mem_snap.get("untracked_bytes", 0),
            "headroom_bytes": mem_snap.get("headroom_bytes"),
            "owners": {o: d.get("bytes", 0) for o, d in
                       (mem_snap.get("owners") or {}).items()},
        }

    ok = [r for r in records if r.ok]
    shed = [r for r in records if r.shed]
    lat = [r.latency for r in ok]
    ttfts = [r.ttft for r in ok if r.ttft is not None]
    total_out = sum(r.output_tokens for r in ok)
    tpots_ms = [
        (r.latency - r.ttft) / max(1, r.output_tokens - 1) * 1000
        for r in ok if r.ttft is not None and r.output_tokens > 1
    ]
    per_class = {}
    if mix:
        for cls in {m[0] for m in mix}:
            per_class[cls] = _class_summary(
                [r for r in records if r.priority == cls])
    if cfg.long_prompt_frac > 0:
        per_class["long_prompt"] = _class_summary(
            [r for r in records if r.long])
        per_class["short_prompt"] = _class_summary(
            [r for r in records if not r.long])
    per_adapter = {}
    if cfg.adapters > 0:
        for name in sorted({r.adapter for r in records if r.adapter}):
            per_adapter[name] = _class_summary(
                [r for r in records if r.adapter == name])
    adapter_pool_hit_rate = (await _scrape_adapter_hit_rate(cfg)
                             if cfg.adapters > 0 else 0.0)
    cold = [r for r in ok if not r.warm]
    warm = [r for r in ok if r.warm]
    cold_ttfts = [r.ttft for r in cold if r.ttft is not None]
    warm_ttfts = [r.ttft for r in warm if r.ttft is not None]
    cache_hit_rate = (await _scrape_cache_hit_rate(cfg)
                      if cfg.sessions > 0 else 0.0)
    return LoadReport(
        num_requests=len(records),
        num_ok=len(ok),
        duration_s=round(duration, 3),
        requests_per_s=round(len(ok) / duration, 3) if duration else 0.0,
        output_tokens_per_s=round(total_out / duration, 1) if duration else 0.0,
        latency_p50_s=round(_percentile(lat, 50), 4),
        latency_p90_s=round(_percentile(lat, 90), 4),
        latency_p99_s=round(_percentile(lat, 99), 4),
        ttft_p50_s=round(_percentile(ttfts, 50), 4),
        ttft_p90_s=round(_percentile(ttfts, 90), 4),
        ttft_p99_s=round(_percentile(ttfts, 99), 4),
        tpot_mean_ms=round(sum(tpots_ms) / len(tpots_ms), 2) if tpots_ms else 0.0,
        ttft_p999_s=round(_percentile(ttfts, 99.9), 4),
        tpot_p999_ms=round(_percentile(tpots_ms, 99.9), 2),
        migrations_total=sum(r.migrations for r in records),
        retries_total=sum(r.retries for r in records),
        num_shed=len(shed),
        shed_rate=round(len(shed) / len(records), 4) if records else 0.0,
        per_class=per_class,
        # Shed refusals are deliberate back-pressure, not errors; keep the
        # error list for real failures so a bounded-queue burst doesn't
        # read as a broken server.
        errors=[r.error for r in records if r.error and not r.shed][:10],
        server_histograms=server_hists,
        watchdog_alerts=watchdog_alerts,
        peak_queue_depth=peak_queue,
        num_cold=len(cold),
        num_warm=len(warm),
        cold_ttft_p50_s=round(_percentile(cold_ttfts, 50), 4),
        cold_ttft_p90_s=round(_percentile(cold_ttfts, 90), 4),
        warm_ttft_p50_s=round(_percentile(warm_ttfts, 50), 4),
        warm_ttft_p90_s=round(_percentile(warm_ttfts, 90), 4),
        cache_hit_rate=cache_hit_rate,
        per_adapter=per_adapter,
        adapter_pool_hit_rate=adapter_pool_hit_rate,
        interference=(_interference_summary(records)
                      if cfg.long_prompt_frac > 0 else {}),
        phase_means=_phase_means(ok),
        cold_phases=_phase_means(cold),
        warm_phases=_phase_means(warm),
        memory=memory,
        slo=slo,
        fleet_federation=fleet_federation,
        spec=spec,
        trace_coverage=trace_coverage,
        records=records,
    )


def run_load_test(cfg: LoadGenConfig) -> LoadReport:
    """Blocking entry point (used by ``dlti_tpu_torch.cli.benchmark_serving``)."""
    return asyncio.run(_run_async(cfg))
